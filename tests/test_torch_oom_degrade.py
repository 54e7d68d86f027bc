"""The port's two answers to a device OOM that the ladder leaves
unmet, both port-only and held to the reference's rows: a join's probe
step splits its batch (``memory/oom.py`` ``split_on_oom``,
``DeviceBatch.halves``), and a concurrent stage wave reruns its
OOM-failed stages one at a time (``parallel/pipeline.py``
``prematerialize_stages``).

- ``DeviceBatch.halves`` gives views whose live rows, in order, are the
  batch's (a selection vector and a ``num_rows`` inside either half).
- ``split_on_oom`` halves a batch until its step fits, yields the
  halves' outputs in row order, counts ``splitRetries`` per split, and
  lets the error through below ``2 * _MIN_TARGET_ROWS`` rows.
- A join of 20,000 probe rows (numpy seed 5) whose probe step raises a
  real-typed ``torch.OutOfMemoryError`` on any batch above 8,192 rows:
  the ladder runs (the shrink rung) and is exhausted, the batch splits,
  and the rows equal the unforced run's and the reference host engine's,
  for the dense path (unique keys) and the expanded path (duplicate
  keys), inner / left / semi / anti / full.
- The same probe rows through a 4-way hash exchange whose map-side
  split raises on any batch above 8,192 rows: the rows equal the unforced
  run's in order and the reference host engine's; and grouped (by key,
  unique, and by key mod 7) with count, sum, min, first and last under a
  partial update that raises so: counts, min, first and last equal the
  unforced run's, sums within rounding, and all but first and last the
  reference's.
- TPC-H q3 (the reference's ``tpch.generate`` at scale 0.003, 3 files a
  table, seed 7; auto-broadcast off, 4 partitions: three scan stages in
  one wave) whose first stage on a ``srt-stage`` thread raises a device
  OOM: that stage runs again alone (``serialStageRetries`` 1) and the
  rows equal the pipeline-off run's and the reference host engine's; a
  non-OOM failure there still reaches the caller.
- Kept on purpose (ROADMAP queue C): a final aggregate whose device OOM
  the ladder leaves unmet raises in the port. The reference's
  host-fallback rung would finish it on the CPU; the port has no such
  rung and registers no ``oom.hostFallback.enabled`` key. Since the
  multi-query scheduler, the evict-neighbors rung acts first when a
  neighbor query holds device memory: it spills the neighbor, and the
  final aggregate, which cannot split, still raises.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import threading

import numpy as np
import pytest
import torch

from spark_rapids_tpu.api.dataframe import TpuSession as JSession
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.columnar import dtypes as jdt

from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, DeviceColumn
from spark_rapids_tpu_torch.memory import oom
from spark_rapids_tpu_torch.ops import base as tbase
from spark_rapids_tpu_torch.ops import join as tjoin
from spark_rapids_tpu_torch.parallel.exchange import ShuffleExchangeExec
from spark_rapids_tpu_torch.plan import plan_cache as pc

from harness import assert_rows_equal

PROBE, BUILD = 20_000, 3_000
CONF = {"spark.rapids.sql.variableFloatAgg.enabled": True}


@pytest.fixture(autouse=True)
def _fresh():
    pc.cache().clear()
    oom.reset_degradation()
    yield
    pc.cache().clear()
    oom.reset_degradation()


def _batch(cap=8192, n=5000):
    d = torch.arange(cap, dtype=torch.int64)
    return DeviceBatch((DeviceColumn(dt.INT64, d, torch.ones(
        cap, dtype=torch.bool)),), torch.tensor(n, dtype=torch.int32),
        sel=(d % 3 != 0))


def _live(b):
    return b.columns[0].data[b.row_mask()].tolist()


@pytest.mark.parametrize("n", [0, 100, 4096, 5000, 8192])
def test_halves_keep_the_live_rows_in_order(n):
    b = _batch(n=n)
    lo, hi = b.halves()
    assert lo.capacity == hi.capacity == 4096
    assert _live(lo) + _live(hi) == _live(b)
    assert lo.columns[0].data.data_ptr() == b.columns[0].data.data_ptr()


def _exhausted():
    return oom.OomRetryExhausted(RuntimeError("x"), [oom.RUNG_SHRINK])


_RAW = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 MiB")


@pytest.mark.parametrize("error", [_exhausted(), _RAW],
                         ids=["exhausted", "raw"])
def test_split_on_oom_halves_until_the_step_fits(error):
    calls = []

    def step(b, offset):
        calls.append((b.capacity, offset))
        if b.capacity > 4096:
            raise error
        return b

    sink = tbase.Metrics("Recovery")
    faults.set_recovery_sink(sink)
    try:
        outs = list(oom.split_on_oom(step, _batch(cap=16384, n=16000)))
    finally:
        faults.set_recovery_sink(None)
    assert calls == [(16384, 0), (8192, 0), (4096, 0), (4096, 4096),
                     (8192, 8192), (4096, 8192), (4096, 12288)]
    assert [o.capacity for o in outs] == [4096] * 4
    assert sum((_live(o) for o in outs), []) == _live(
        _batch(cap=16384, n=16000))
    assert sink.values["splitRetries"] == 3


def test_split_on_oom_raises_below_its_floor_and_on_other_errors():
    def step(b, offset):
        raise _exhausted()

    with pytest.raises(oom.OomRetryExhausted):
        list(oom.split_on_oom(step, _batch()))

    def other(b, offset):
        raise ValueError("not an OOM")

    with pytest.raises(ValueError):
        list(oom.split_on_oom(other, _batch(cap=16384)))


def _frames(session, D, unique: bool):
    rng = np.random.default_rng(5)
    keys = rng.integers(0, BUILD * 2, PROBE)
    bkeys = np.arange(BUILD) * 2 if unique else np.arange(BUILD) // 2 * 4
    probe = session.create_dataframe(
        {"k": [int(x) for x in keys],
         "v": [float(x) for x in rng.uniform(-1, 1, PROBE)]},
        [("k", D.INT64), ("v", D.FLOAT64)])
    build = session.create_dataframe(
        {"k": [int(x) for x in bkeys],
         "w": [int(x) for x in rng.integers(0, 1000, BUILD)]},
        [("k", D.INT64), ("w", D.INT64)])
    return probe, build


def _force_oom(monkeypatch, cls, method, batch_arg=1):
    """``cls.method`` raises a device OOM on any batch (its positional
    argument ``batch_arg``) above 8,192 rows."""
    orig = getattr(cls, method)

    def step(self, *args):
        if args[batch_arg].capacity > 8192:
            raise torch.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 MiB")
        return orig(self, *args)

    monkeypatch.setattr(cls, method, step)


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti", "full"])
@pytest.mark.parametrize("unique", [True, False], ids=["dense", "expanded"])
def test_join_splits_its_probe_batch(monkeypatch, how, unique):
    probe, build = _frames(TpuSession(CONF, device="cpu"), dt, unique)
    df = probe.join(build, "k", how)
    want = df.collect()
    pc.cache().clear()
    # The dense path runs _dense_step; the expanded one, _emit_expanded
    # (a full outer join never takes the dense table).
    _force_oom(monkeypatch, tjoin._JoinKernelMixin,
               "_dense_step" if unique and how != "full"
               else "_emit_expanded")
    got = df.collect()
    rec = df._physical().last_ctx.metrics["Recovery@query"].values
    assert rec["splitRetries"] >= 1, rec
    assert rec["spillEscalations"] >= 1, rec
    assert_rows_equal(sorted(got, key=repr), sorted(want, key=repr))
    jp, jb = _frames(JSession(CONF), jdt, unique)
    ref = jp.join(jb, "k", how).collect_host()
    assert len(got) == len(ref)
    assert_rows_equal(sorted(got, key=repr), sorted(ref, key=repr),
                      approx_float=True)


def test_exchange_map_side_splits_its_batch(monkeypatch):
    def frame(session, D):
        probe, _ = _frames(session, D, True)
        return probe.repartition(4, "k")

    df = frame(TpuSession(CONF, device="cpu"), dt)
    want = df.collect()
    pc.cache().clear()
    _force_oom(monkeypatch, ShuffleExchangeExec, "_split", batch_arg=0)
    got = df.collect()
    rec = df._physical().last_ctx.metrics["Recovery@query"].values
    assert rec["splitRetries"] >= 1, rec
    assert got == want and len(got) == PROBE
    ref = frame(JSession(CONF), jdt).collect_host()
    assert_rows_equal(sorted(got), sorted(ref))


@pytest.mark.parametrize("unique", [True, False])
def test_partial_aggregate_splits_its_batch(monkeypatch, unique):
    from spark_rapids_tpu_torch.ops.aggregate import HashAggregateExec
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu.plan import logical as JL

    def frame(session, D, M):
        probe, _ = _frames(session, D, True)
        k = M.col("k") if unique else M.col("k") % 7
        v = M.col("v")
        return probe.with_column("g", k).group_by("g").agg(
            M.agg_count().alias("n"), M.agg_sum(v).alias("s"),
            M.agg_min(v).alias("lo"), M.agg_first(v).alias("f"),
            M.agg_last(v).alias("l"))

    df = frame(TpuSession(CONF, device="cpu"), dt, L)
    want = df.collect()
    pc.cache().clear()
    _force_oom(monkeypatch, HashAggregateExec, "_update_batch",
               batch_arg=0)
    got = df.collect()
    rec = df._physical().last_ctx.metrics["Recovery@query"].values
    assert rec["splitRetries"] >= 1, rec
    key = lambda r: r[0]  # noqa: E731
    got, want = sorted(got, key=key), sorted(want, key=key)
    # Counts, min, first and last exactly (the halves keep the arrival
    # index), the sums within rounding (another order).
    assert [r[:2] + r[3:] for r in got] == [r[:2] + r[3:] for r in want]
    assert_rows_equal(got, want, approx_float=True)
    ref = frame(JSession(CONF), jdt, JL).collect_host()
    assert_rows_equal([r[:4] for r in got],
                      sorted((r[:4] for r in ref), key=key),
                      approx_float=True)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_oom_degrade"))
    jtpch.generate(d, scale=0.003, files_per_table=3, seed=7)
    return d


Q3 = {"spark.rapids.sql.variableFloatAgg.enabled": True,
      "spark.rapids.sql.shuffle.partitions": 4,
      "spark.rapids.sql.autoBroadcastJoinThreshold": -1,
      "spark.rapids.sql.format.scanCache.maxBytes": 0}


def _fail_first_stage_thread(monkeypatch, error):
    """The first exchange a ``srt-stage`` thread materializes raises
    ``error`` instead."""
    orig = ShuffleExchangeExec.stage_prematerialize
    fired = []

    def stage_prematerialize(self, ctx):
        if threading.current_thread().name.startswith("srt-stage") \
                and not fired:
            fired.append(id(self))
            raise error
        return orig(self, ctx)

    monkeypatch.setattr(ShuffleExchangeExec, "stage_prematerialize",
                        stage_prematerialize)
    return fired


def test_stage_wave_reruns_an_oom_stage_alone(monkeypatch, data_dir):
    want = tpch.QUERIES["q3"](TpuSession(dict(Q3, **{
        "spark.rapids.sql.pipeline.enabled": False}), device="cpu"),
        data_dir).collect()
    pc.cache().clear()
    fired = _fail_first_stage_thread(monkeypatch, torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 MiB"))
    df = tpch.QUERIES["q3"](TpuSession(Q3, device="cpu"), data_dir)
    got = df.collect()
    assert len(fired) == 1
    pm = df.metrics()["Pipeline@query"]
    assert pm["concurrentStages"] == 3 and pm["serialStageRetries"] == 1, pm
    assert got == want and got
    assert df._physical().last_ctx.last_leak_report == []
    ref = jtpch.q3(JSession(dict(Q3, **{
        "spark.rapids.sql.cost.enabled": False})), data_dir).collect_host()
    assert_rows_equal(got, ref, approx_float=True)


def test_stage_wave_reraises_other_errors(monkeypatch, data_dir):
    _fail_first_stage_thread(monkeypatch, ValueError("not an OOM"))
    df = tpch.QUERIES["q3"](TpuSession(Q3, device="cpu"), data_dir)
    with pytest.raises(ValueError, match="not an OOM"):
        df.collect()


def test_final_aggregate_oom_left_unmet_raises(monkeypatch, tmp_path):
    from spark_rapids_tpu import config as JC
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.columnar.host import (HostBatch,
                                                      host_to_device)
    from spark_rapids_tpu_torch.ops.aggregate import HashAggregateExec
    from spark_rapids_tpu_torch.parallel import scheduler as SC
    from spark_rapids_tpu_torch.plan import logical as L
    session = TpuSession(CONF, device="cpu")
    probe, _ = _frames(session, dt, True)
    df = probe.with_column("g", L.col("k") % 7).group_by("g").agg(
        L.agg_sum(L.col("v")).alias("s"))
    assert len(df.collect()) == 7
    pc.cache().clear()
    orig = HashAggregateExec._consolidate

    def consolidate(self, pending, final_stage=False):
        if final_stage:
            raise torch.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 MiB")
        return orig(self, pending, final_stage)

    monkeypatch.setattr(HashAggregateExec, "_consolidate", consolidate)
    # A neighbor query holding device buffers in its catalog.
    mgr = SC.get_query_manager(session.conf)
    neighbor = mgr.admit(session.conf)
    nctx = tbase.ExecContext(TpuSession(
        {"spark.rapids.memory.spill.dir": str(tmp_path)},
        device="cpu").conf, query=neighbor)
    mgr.register_context(neighbor, nctx)
    nctx.catalog.add_batch(host_to_device(HostBatch.from_pydict(
        [("a", dt.INT64)], {"a": list(range(1000))}), device="cpu"))
    try:
        with pytest.raises(oom.OomRetryExhausted):
            df.collect()
        assert "evict-neighbors" in oom.last_ladder
        assert oom.last_ladder[-1] == oom.RUNG_SHRINK
        assert nctx.catalog.device_bytes == 0
        assert df._physical().last_ctx.last_leak_report in (None, [])
    finally:
        mgr.finish(neighbor)
        nctx.close()
        with SC._MANAGER_LOCK:
            SC._MANAGER = None
    assert JC.OOM_HOST_FALLBACK.key not in C._REGISTRY
