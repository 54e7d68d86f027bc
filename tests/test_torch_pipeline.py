"""The partition pipeline (``parallel/pipeline.py``) on the CPU: file
scans whose host half (decode, stats pruning, wire encode and pack) runs
on prefetch threads ahead of the ordered consumer.

- Pipeline on against off: bit-identical batches at prefetchPartitions 1
  and 3, over TPC-H queries read from 8 parquet files a table (the
  collect loop, the exchange's map side, a broadcast join's probe side)
  and a union of two scans; the same order when a late partition
  finishes its prefetch first.
- The counters flow into the query's ``Pipeline@query`` metrics and the
  process-global counters, overlapRatio as the reference derives it.
- An error in a prefetch is re-raised where the consumer takes that
  partition, and its payloads do not outlive the query.
- No prefetch thread outlives a query; none is created when the pipeline
  is off (or ``SRT_PIPELINE=0``), nor for a plan without a file scan.
- ``params_of`` resolves the conf and the environment as the
  reference's does.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import threading
import time

import numpy as np
import pytest

from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.config import TpuConf as JConf
from spark_rapids_tpu.parallel import pipeline as JPL

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.io import scan as S
from spark_rapids_tpu_torch.ops.base import ExecContext
from spark_rapids_tpu_torch.parallel import pipeline as PL
from spark_rapids_tpu_torch.plan import logical as L

VFA = {"spark.rapids.sql.variableFloatAgg.enabled": True,
       "spark.rapids.sql.format.scanCache.maxBytes": 0}
OFF = {"spark.rapids.sql.pipeline.enabled": False}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_pipe"))
    jtpch.generate(d, scale=0.005, files_per_table=8, seed=0)
    return d


def _union(session, data_dir):
    li = tpch._read(session, data_dir, "lineitem") \
        .select("l_orderkey", "l_quantity")
    return li.union(li.filter(L.col("l_quantity") > 10.0))


PLANS = {q: (lambda q: lambda s, d: tpch.QUERIES[q](s, d))(q)
         for q in ("q1", "q3", "q4", "q6")}
PLANS["union"] = _union


def _batches(phys, ctx=None):
    ctx = ctx or ExecContext(phys.conf)
    return phys.collect_batches(ctx), ctx


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.names == w.names and g.num_rows == w.num_rows
        for a, b in zip(g.columns, w.columns):
            np.testing.assert_array_equal(a.validity, b.validity)
            if a.dtype.is_string:
                assert a.to_list() == b.to_list()
            else:
                assert np.asarray(a.data).tobytes() == \
                    np.asarray(b.data).tobytes()


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("srt-prefetch")]


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_pipeline_on_matches_off(plan, depth, data_dir):
    on = TpuSession(dict(VFA, **{
        "spark.rapids.sql.pipeline.prefetchPartitions": depth}),
        device="cpu")
    off = TpuSession(dict(VFA, **OFF), device="cpu")
    want, _ = _batches(PLANS[plan](off, data_dir)._physical())
    got, ctx = _batches(PLANS[plan](on, data_dir)._physical())
    _same_batches(got, want)
    m = ctx.metrics["Pipeline@query"].values
    parts = 16 if plan == "union" else 8
    assert m["prefetchedPartitions"] >= parts
    assert m["stagingBytesPrefetched"] > 0
    assert 0.0 <= m["overlapRatio"] <= 1.0
    assert not _prefetch_threads()


def test_late_partition_first_keeps_the_order(data_dir, monkeypatch):
    """Partition 0's prefetch is the slowest: the rows still come in
    partition order, bit for bit the serial run's."""
    off = TpuSession(dict(VFA, **OFF), device="cpu")
    want, _ = _batches(PLANS["union"](off, data_dir)._physical())
    real = S.FileScanExec.prefetch_host

    def slow_first(self, ctx, partition):
        if partition == 0:
            time.sleep(0.3)
        return real(self, ctx, partition)
    monkeypatch.setattr(S.FileScanExec, "prefetch_host", slow_first)
    on = TpuSession(dict(VFA, **{
        "spark.rapids.sql.pipeline.prefetchPartitions": 3,
        "spark.rapids.sql.pipeline.hostThreads": 4}), device="cpu")
    for _ in range(2):
        got, ctx = _batches(PLANS["union"](on, data_dir)._physical())
        _same_batches(got, want)
    assert ctx.metrics["Pipeline@query"].values["pipelineStalls"] >= 1


def test_counters_flow_into_the_metrics(data_dir):
    PL.reset_counters()
    on = TpuSession(dict(VFA), device="cpu")
    _, ctx = _batches(tpch.q3(on, data_dir)._physical())
    m = dict(ctx.metrics["Pipeline@query"].values)
    assert m["hostPrefetchMs"] > 0 and m["consumerWaitMs"] >= 0
    assert m["prefetchedPartitions"] == 8
    want = JPL._with_overlap_ratio({k: m[k] for k in (
        "hostPrefetchMs", "consumerWaitMs")})
    assert m["overlapRatio"] == want["overlapRatio"]
    glob = PL.counters()
    for k in ("hostPrefetchMs", "consumerWaitMs", "prefetchedPartitions",
              "stagingBytesPrefetched"):
        assert glob[k] == pytest.approx(m[k])
    scan = [v.values for k, v in ctx.metrics.items()
            if k.startswith("FileScanExec[")]
    assert sum(s.get("decodeTime", 0) for s in scan) > 0
    assert sum(s.get("numOutputRows", 0) for s in scan) > 0


def test_prefetch_error_is_raised_at_consumption(data_dir, monkeypatch):
    real = S.FileScanExec.prefetch_host
    consumed = []
    real_exec = S.FileScanExec.execute_device

    def failing(self, ctx, partition):
        if partition == 3:
            raise ValueError("decode failed in partition 3")
        return real(self, ctx, partition)

    def tracking(self, ctx, partition):
        consumed.append(partition)
        return real_exec(self, ctx, partition)
    monkeypatch.setattr(S.FileScanExec, "prefetch_host", failing)
    monkeypatch.setattr(S.FileScanExec, "execute_device", tracking)
    on = TpuSession(dict(VFA), device="cpu")
    phys = tpch.q6(on, data_dir)._physical()
    ctx = ExecContext(phys.conf)
    with pytest.raises(ValueError, match="partition 3"):
        phys.collect_batches(ctx)
    assert consumed == [0, 1, 2]
    assert not any(str(k).startswith("scan-prefetch:") for k in ctx.cache)
    assert not _prefetch_threads()


def _thread_names(monkeypatch):
    started = []
    real = threading.Thread.start

    def start(self):
        started.append(self.name)
        return real(self)
    monkeypatch.setattr(threading.Thread, "start", start)
    return started


@pytest.mark.parametrize("how", ["conf", "env"])
def test_no_thread_when_the_pipeline_is_off(how, data_dir, monkeypatch):
    conf = dict(VFA, **{"spark.rapids.sql.format.parquet.reader.type":
                        "PERFILE"})
    if how == "conf":
        conf.update(OFF)
    else:
        monkeypatch.setenv("SRT_PIPELINE", "0")
    session = TpuSession(conf, device="cpu")
    phys = tpch.q3(session, data_dir)._physical()
    started = _thread_names(monkeypatch)
    rows = phys.collect()
    assert started == []
    monkeypatch.undo()
    assert rows == tpch.q3(TpuSession(dict(VFA), device="cpu"),
                           data_dir).collect()


def test_plans_without_a_file_scan_stay_serial(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a pipeline opened over an in-memory plan")
    monkeypatch.setattr(PL.PartitionPipeline, "__init__", refuse)
    session = TpuSession(dict(VFA), device="cpu")
    df = session.create_dataframe(
        {"k": np.arange(100, dtype=np.int64) % 7,
         "v": np.arange(100, dtype=np.int64)},
        (("k", _dtype("int64")), ("v", _dtype("int64"))), num_partitions=4)
    rows = df.group_by("k").agg(L.agg_sum(L.col("v")).alias("s")) \
        .order_by("k").collect()
    assert rows == [(k, sum(v for v in range(100) if v % 7 == k))
                    for k in range(7)]


def _dtype(name):
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    return dt.type_named(name)


@pytest.mark.parametrize("raw,env", [
    ({}, None), (OFF, None), ({}, "0"), ({}, "1"),
    ({"spark.rapids.sql.pipeline.prefetchPartitions": 0,
      "spark.rapids.sql.pipeline.hostThreads": 9}, None),
    ({"spark.rapids.sql.pipeline.enabled": "false"}, None)])
def test_params_match_reference(raw, env, monkeypatch):
    if env is None:
        monkeypatch.delenv("SRT_PIPELINE", raising=False)
    else:
        monkeypatch.setenv("SRT_PIPELINE", env)
    got, want = PL.params_of(C.TpuConf(raw)), JPL.params_of(JConf(raw))
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.prefetch_partitions, got.host_threads) == (
            want.prefetch_partitions, want.host_threads)
