"""Port parity of out-of-core execution: the sample-sort and the
partition-chunked window (``ops/sort.py`` ``out_of_core_partition``), the
grace hash join (``ops/join.py``), spilling exchange pieces and the OOM
rung above the ladder (``ops/base.py`` ``execute_device_recovering``),
against the JAX package under the same ``budgetBytes``.

- Sort and window (``tests/test_out_of_core.py``'s cases): rows equal the
  JAX package's under the same budget and the port's in-core rows, and
  ``outOfCoreBuckets`` is at least 2 in both packages. The staged input
  reaches the disk tier through LZ4.
- Grace join for inner, left, right, full, semi and anti
  (``tests/test_grace_join.py``): ``graceJoinPartitions`` >= 2 in both
  packages, rows equal as multisets (the bucketed path
  emits in another order; values are gathers, so bit-identical).
- An ``OomRetryExhausted`` out of the join engages the grace rung; with
  grace off it reaches the caller. A failure while a side is staged
  leaves no catalog entry behind.
- A coalesced exchange's host half serves a partition's whole group.
- A group-by under an 8 KiB budget spills its exchange pieces and stays
  right, and the query's cache holds no raw device batch
  (``tests/test_spill_integration.py``).
- An exchange whose pieces spill to host and disk serves the unspilled
  run's rows, partition by partition.

Integer, string and order compare exactly; float sums by the harness's
``approx_float`` (the window's prefix sums run over other row sets).
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import numpy as np
import pytest

from harness import assert_rows_equal

from spark_rapids_tpu import FLOAT64 as JF64, INT64 as JI64
from spark_rapids_tpu.api.dataframe import TpuSession as JSession
from spark_rapids_tpu.plan import logical as JL

from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost
from spark_rapids_tpu_torch.memory import oom as toom
from spark_rapids_tpu_torch.memory.stores import SpillableBatch
from spark_rapids_tpu_torch.ops.base import ExecContext, InMemorySourceExec
from spark_rapids_tpu_torch.ops.join import ShuffledHashJoinExec
from spark_rapids_tpu_torch.parallel.exchange import ShuffleExchangeExec
from spark_rapids_tpu_torch.parallel.partitioning import HashPartitioning
from spark_rapids_tpu_torch.exprs.base import BoundReference
from spark_rapids_tpu_torch.plan import logical as TL

BUDGET_KEY = "spark.rapids.memory.tpu.budgetBytes"


@pytest.fixture(autouse=True)
def _clean_ladder():
    toom.reset_degradation()
    yield
    toom.reset_degradation()


def _metric(ctx_metrics, name: str) -> list:
    return [m.values.get(name, 0) for m in ctx_metrics.values()]


def _port(conf: dict, tmp_path):
    conf = dict(conf)
    conf.setdefault("spark.rapids.memory.spill.dir", str(tmp_path))
    return TpuSession(conf, device="cpu")


def _run_port(df):
    """(rows, ctx) of one collect, with the context kept for metrics."""
    phys = df._physical()
    ctx = ExecContext(phys.conf)
    rows = phys.collect(ctx)
    assert ctx.last_leak_report == []
    return rows, ctx


# ---------------------------------------------------------------------------
# Sort and window
# ---------------------------------------------------------------------------

N_SORT = 20_000


def _sort_data():
    rng = np.random.default_rng(7)
    return {"k": rng.integers(0, 1_000_000, N_SORT).tolist(),
            "v": rng.normal(size=N_SORT).tolist()}


def test_sort_larger_than_device_budget(tmp_path):
    data = _sort_data()
    budget = 128 * 1024
    js = JSession()
    js.set(BUDGET_KEY, budget)
    jdf = js.create_dataframe(data, [("k", JI64), ("v", JF64)],
                              num_partitions=8) \
        .order_by(JL.col("k").asc(), JL.col("v").asc())
    want = jdf.collect()
    jm = jdf._physical().last_ctx.metrics
    assert max(v for k, m in jm.items() if "SortExec" in k
               for v in [m.values.get("outOfCoreBuckets", 0)]) >= 2

    def port(conf):
        df = _port(conf, tmp_path).create_dataframe(
            data, [("k", tdt.INT64), ("v", tdt.FLOAT64)], num_partitions=8) \
            .order_by(TL.col("k").asc(), TL.col("v").asc())
        return _run_port(df)

    in_core, _ = port({})
    got, ctx = port({BUDGET_KEY: budget,
                     "spark.rapids.memory.host.spillStorageSize": 64 << 10})
    assert repr(got) == repr(want)
    assert repr(in_core) == repr(want)
    assert max(_metric(ctx.metrics, "outOfCoreBuckets")) >= 2
    sm = ctx.last_spill_metrics
    assert sm["spill_to_host"] > 0 and sm["spill_to_disk"] > 0
    assert sm["restore_from_disk"] > 0
    assert 0 < sm["disk_bytes_stored"] < sm["disk_bytes_raw"]


def test_window_larger_than_device_budget(tmp_path):
    n = 20_000
    rng = np.random.default_rng(11)
    data = {"g": rng.integers(0, 300, n).tolist(),
            "v": rng.normal(size=n).tolist()}
    budget = 48 * 1024
    js = JSession()
    js.set(BUDGET_KEY, budget)
    js.set("spark.rapids.sql.variableFloatAgg.enabled", True)
    jdf = js.create_dataframe(data, [("g", JI64), ("v", JF64)],
                              num_partitions=8)
    jw = JL.Window.partition_by(JL.col("g"))
    jout = jdf.with_column("s", JL.agg_sum(JL.col("v")).over(jw)) \
        .with_column("n", JL.agg_count(JL.col("v")).over(jw))
    want = sorted(jout.collect())
    assert max(m.values.get("outOfCoreBuckets", 0) for k, m in
               jout._physical().last_ctx.metrics.items()
               if "WindowExec" in k) >= 2

    def port(conf):
        s = _port(dict(conf, **{
            "spark.rapids.sql.variableFloatAgg.enabled": True}), tmp_path)
        df = s.create_dataframe(data, [("g", tdt.INT64), ("v", tdt.FLOAT64)],
                                num_partitions=8)
        w = TL.Window.partition_by(TL.col("g"))
        out = df.with_column("s", TL.agg_sum(TL.col("v")).over(w)) \
            .with_column("n", TL.agg_count(TL.col("v")).over(w))
        rows, ctx = _run_port(out)
        return sorted(rows), ctx

    in_core, _ = port({})
    got, ctx = port({BUDGET_KEY: budget})
    assert len(got) == n
    assert max(_metric(ctx.metrics, "outOfCoreBuckets")) >= 2
    assert ctx.last_spill_metrics["spill_to_host"] > 0
    assert_rows_equal(got, want, approx_float=True, msg="port vs JAX")
    assert_rows_equal(got, in_core, approx_float=True, msg="vs in-core")
    # Keys and counts exactly.
    assert [(r[0], r[1], r[3]) for r in got] == \
        [(r[0], r[1], r[3]) for r in want]


# ---------------------------------------------------------------------------
# Grace hash join
# ---------------------------------------------------------------------------

N_JOIN = 36_000
KEYS = 12_000
JOIN_BUDGET = 1 << 20


def _join_data(seed=42, n=N_JOIN, keys=KEYS):
    rng = np.random.default_rng(seed)
    left = {"k": rng.integers(0, keys, n).tolist(),
            "v": rng.normal(size=n).tolist()}
    right = {"k": rng.integers(0, keys, n).tolist(),
             "w": rng.normal(size=n).tolist()}
    return left, right


_LEFT, _RIGHT = _join_data()

_JOIN_CONF = {"spark.rapids.sql.autoBroadcastJoinThreshold": -1,
              "spark.rapids.sql.shuffle.partitions": 1}


def _jax_join(how, budget):
    s = JSession()
    for k, v in _JOIN_CONF.items():
        s.set(k, v)
    s.set("spark.rapids.sql.aqe.replan.enabled", False)
    s.set("spark.rapids.sql.cost.enabled", False)
    if budget:
        s.set(BUDGET_KEY, budget)
    left = s.create_dataframe(_LEFT, [("k", JI64), ("v", JF64)],
                              num_partitions=4)
    right = s.create_dataframe(_RIGHT, [("k", JI64), ("w", JF64)],
                               num_partitions=4)
    df = left.join(right, "k", how)
    rows = df.collect()
    parts = sum(m.values.get("graceJoinPartitions", 0)
                for m in df._physical().last_ctx.metrics.values())
    return rows, parts


def _port_join(tmp_path, how, budget, grace=True, left=_LEFT, right=_RIGHT,
               nparts=4):
    conf = dict(_JOIN_CONF)
    conf["spark.rapids.sql.join.grace.enabled"] = grace
    if budget:
        conf[BUDGET_KEY] = budget
    s = _port(conf, tmp_path)
    ldf = s.create_dataframe(left, [("k", tdt.INT64), ("v", tdt.FLOAT64)],
                             num_partitions=nparts)
    rdf = s.create_dataframe(right, [("k", tdt.INT64), ("w", tdt.FLOAT64)],
                             num_partitions=nparts)
    rows, ctx = _run_port(ldf.join(rdf, "k", how))
    return rows, ctx


def _same_multiset(got, want):
    assert sorted(map(repr, got)) == sorted(map(repr, want))


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi",
                                 "anti"])
def test_grace_join_types(tmp_path, how):
    want, jparts = _jax_join(how, JOIN_BUDGET)
    assert jparts >= 2
    in_core, ctx0 = _port_join(tmp_path, how, None)
    assert max(_metric(ctx0.metrics, "graceJoinPartitions")) == 0
    got, ctx = _port_join(tmp_path, how, JOIN_BUDGET)
    assert sum(_metric(ctx.metrics, "graceJoinPartitions")) == jparts
    _same_multiset(got, want)
    _same_multiset(in_core, want)


def _small_sides():
    return _join_data(seed=5, n=3_000, keys=400)


def test_exhausted_ladder_engages_grace_then_raises(tmp_path, monkeypatch):
    """OomRetryExhausted out of the join's device path retries through
    the grace rung (graceJoinEngaged); with grace closed the error
    reaches the caller, and the work never moves to the host."""
    left, right = _small_sides()
    plain, _ = _port_join(tmp_path, "inner", None, left=left, right=right,
                          nparts=2)
    real = ShuffledHashJoinExec.execute_device

    def oom_until_grace(self, ctx, partition):
        if not ctx.cache.get(self._grace_force_key()):
            raise toom.OomRetryExhausted(MemoryError("injected"),
                                         ["spill-all"])
        yield from real(self, ctx, partition)

    monkeypatch.setattr(ShuffledHashJoinExec, "execute_device",
                        oom_until_grace)
    got, ctx = _port_join(tmp_path, "inner", None, left=left, right=right,
                          nparts=2)
    rec = ctx.metrics["Recovery@query"].values
    assert rec["graceJoinEngaged"] == 1
    assert rec["graceJoinPartitions"] >= 2
    _same_multiset(got, plain)

    def always_oom(self, ctx, partition):
        raise toom.OomRetryExhausted(MemoryError("injected"), ["spill-all"])
        yield

    monkeypatch.setattr(ShuffledHashJoinExec, "execute_device", always_oom)
    with pytest.raises(toom.OomRetryExhausted):
        _port_join(tmp_path, "inner", None, grace=False, left=left,
                   right=right, nparts=2)


def test_failure_while_staging_leaves_no_entries(tmp_path, monkeypatch):
    """A probe side that fails part way through its staging, on both the
    first grace attempt and the grace rung's retry, leaves nothing in the
    catalog: the partial probe entries and the staged build side are
    closed before the error propagates."""
    from spark_rapids_tpu_torch.ops import join as tjoin
    real = tjoin.stage_spillables
    calls = []

    def fail_probe(ctx, child_iter):
        calls.append(1)
        if len(calls) % 2 == 1:
            return real(ctx, child_iter)

        def one_then_fail():
            yield next(iter(child_iter))
            raise toom.OomRetryExhausted(MemoryError("injected"),
                                         ["shrink"])
        return real(ctx, one_then_fail())

    monkeypatch.setattr(tjoin, "stage_spillables", fail_probe)
    conf = dict(_JOIN_CONF, **{BUDGET_KEY: JOIN_BUDGET})
    s = _port(conf, tmp_path)
    df = s.create_dataframe(
        _LEFT, [("k", tdt.INT64), ("v", tdt.FLOAT64)], num_partitions=4) \
        .join(s.create_dataframe(_RIGHT, [("k", tdt.INT64),
                                          ("w", tdt.FLOAT64)],
                                 num_partitions=4), "k", "inner")
    phys = df._physical()
    ctx = ExecContext(phys.conf)
    with pytest.raises(toom.OomRetryExhausted):
        phys.collect(ctx)
    assert len(calls) == 4          # the first attempt and the grace rung
    assert ctx.metrics["Recovery@query"].values["graceJoinEngaged"] == 1
    assert ctx.last_leak_report == []


def _exchange_under(node, cls):
    if isinstance(node, cls) and node.allow_coalesce:
        return node
    for c in node.children:
        found = _exchange_under(c, cls)
        if found is not None:
            return found
    return None


def test_execute_host_serves_a_coalesced_group(tmp_path):
    """Under the device engine a coalesced exchange numbers its
    partitions by AQE-lite group, so its host half must serve partition
    p's whole group of buckets, as its device half does, or a host
    subtree above it loses rows."""
    data = _agg_data()
    s = _port({"spark.rapids.sql.shuffle.partitions": 8}, tmp_path)
    q = s.create_dataframe(
        data, [("k", tdt.INT64), ("v", tdt.INT64)], num_partitions=4) \
        .group_by("k").agg(TL.agg_sum(TL.col("v")).alias("sv"))
    phys = q._physical()
    ex = _exchange_under(phys.root, ShuffleExchangeExec)
    assert ex is not None
    ctx = ExecContext(phys.conf)
    ctx.cache["engine"] = "device"
    toom.set_active_catalog(ctx.catalog)
    try:
        n = ex.num_partitions(ctx)
        assert n < 8, "the exchange coalesces its buckets"
        total = 0
        for p in range(n):
            dev = [r for b in ex.execute_device(ctx, p)
                   for r in thost.device_to_host(b).to_pylist()]
            host = [r for hb in ex.execute_host(ctx, p)
                    for r in hb.to_pylist()]
            assert sorted(host) == sorted(dev), p
            total += len(host)
        child = ex.children[0]
        assert total == sum(hb.num_rows
                            for cp in range(child.num_partitions(ctx))
                            for hb in child.execute_host(ctx, cp))
    finally:
        toom.set_active_catalog(None)
        ctx.close()
    assert ctx.last_leak_report == []


# ---------------------------------------------------------------------------
# Spilling exchanges
# ---------------------------------------------------------------------------

def _agg_data(keys=50):
    rng = np.random.default_rng(3)
    return {"k": rng.integers(0, keys, 4000).tolist(),
            "v": rng.integers(0, 1000, 4000).tolist()}


def test_groupby_spills_and_stays_correct(tmp_path):
    # 500 keys: the partial aggregates' pieces outgrow the budget before
    # they are served, so they spill and come back.
    data = _agg_data(keys=500)
    conf = {"spark.rapids.sql.shuffle.partitions": 4}
    js = JSession()
    js.set(BUDGET_KEY, 8 * 1024)
    js.set("spark.rapids.sql.shuffle.partitions", 4)
    jq = js.create_dataframe(data, [("k", JI64), ("v", JI64)],
                             num_partitions=4) \
        .group_by("k").agg(JL.agg_sum(JL.col("v")).alias("sv"),
                           JL.agg_count().alias("n")).order_by("k")
    want = jq.collect()

    def port(budget):
        s = _port(dict(conf, **({BUDGET_KEY: budget} if budget else {})),
                  tmp_path)
        q = s.create_dataframe(data, [("k", tdt.INT64), ("v", tdt.INT64)],
                               num_partitions=4) \
            .group_by("k").agg(TL.agg_sum(TL.col("v")).alias("sv"),
                               TL.agg_count().alias("n")).order_by("k")
        return q, _run_port(q)

    q, (got, ctx) = port(8 * 1024)
    sm = ctx.last_spill_metrics
    assert sm["spill_to_host"] > 0, "an 8 KiB budget spills the pieces"
    assert sm["restore_from_host"] > 0
    assert got == want == q.collect_host()
    assert port(None)[1][0] == want

    # Mid-query, the cache holds spillable handles, never raw batches
    # (the exchange's in-process transport session keeps them).
    phys = q._physical()
    ctx = ExecContext(phys.conf)
    toom.set_active_catalog(ctx.catalog)
    try:
        for p in range(phys.root.num_partitions(ctx)):
            list(phys.root.execute_device(ctx, p))
        seen = 0
        for key, val in ctx.cache.items():
            if key.startswith("shuffle:") and key.endswith(":dev"):
                seen += 1
                for bucket in val.buckets:
                    for item in bucket:
                        assert isinstance(item, SpillableBatch), key
        assert seen >= 1
    finally:
        toom.set_active_catalog(None)
        ctx.close()
    assert ctx.last_leak_report == []


def test_split_pieces_equal_gather_rows():
    """Each map-side piece is its own batch of ``bucket_capacity(count)``
    rows, equal bit for bit (dead slots zeroed whole) to ``gather_rows``
    of its rows, from a batch with strings, NULLs, a dead tail and rows
    a selection vector deletes."""
    import torch
    from spark_rapids_tpu_torch.columnar.batch import bucket_capacity
    from spark_rapids_tpu_torch.columnar.rowmove import gather_rows
    rng = np.random.default_rng(4)
    n = 900
    schema = (("k", tdt.INT64), ("s", tdt.STRING), ("f", tdt.FLOAT64))
    hb = thost.HostBatch.from_pydict(schema, {
        "k": rng.integers(0, 60, n).tolist(),
        "s": [None if x % 5 == 0 else f"v{x}"
              for x in rng.integers(0, 300, n).tolist()],
        "f": rng.normal(size=n).tolist()})
    b = thost.host_to_device(hb, capacity=1024, device="cpu", mode="plain")
    b = b.with_sel(torch.from_numpy(rng.random(1024) < 0.8))
    ex = ShuffleExchangeExec(
        InMemorySourceExec(schema, [[hb]], device="cpu"),
        HashPartitioning([BoundReference(0, tdt.INT64)], 5))
    pids, counts = ex._pids_counts(b)
    counts = counts.tolist()
    pieces = ex._split(b, pids, counts)
    skey = torch.where(b.row_mask(), pids.to(torch.int64), torch.tensor(5))
    perm = torch.sort(skey, stable=True).indices
    o = 0
    for p, piece in enumerate(pieces):
        if not counts[p]:
            assert piece is None
            continue
        cap = bucket_capacity(counts[p])
        idx = torch.cat([perm[o:o + counts[p]],
                         torch.zeros(cap - counts[p], dtype=torch.int64)])
        want = gather_rows(b, idx, counts[p])
        assert piece.capacity == cap and piece.rows_hint == counts[p]
        assert int(piece.num_rows) == counts[p] and piece.sel is None
        for got_c, want_c in zip(piece.columns, want.columns):
            assert torch.equal(got_c.data, want_c.data)
            assert torch.equal(got_c.validity, want_c.validity)
            if want_c.lengths is not None:
                assert torch.equal(got_c.lengths, want_c.lengths)
        o += counts[p]
    assert o == int(b.live_count())


def test_exchange_pieces_spill_and_serve_the_same_rows(tmp_path):
    rng = np.random.default_rng(9)
    schema = (("k", tdt.INT64), ("s", tdt.STRING), ("f", tdt.FLOAT64))
    parts = []
    for i in range(3):
        n = 700 + 100 * i
        parts.append([thost.HostBatch.from_pydict(schema, {
            "k": rng.integers(0, 90, n).tolist(),
            "s": [None if x % 7 == 0 else f"s{x}"
                  for x in rng.integers(0, 500, n).tolist()],
            "f": rng.normal(size=n).tolist()})])

    def serve(conf):
        ex = ShuffleExchangeExec(
            InMemorySourceExec(schema, parts, device="cpu"),
            HashPartitioning([BoundReference(0, tdt.INT64)], 4))
        ctx = ExecContext() if conf is None else ExecContext(conf)
        out = []
        for p in range(4):
            out.append([r for b in ex.execute_device(ctx, p)
                        for r in thost.device_to_host(b).to_pylist()])
        sizes = [sb.size_bytes
                 for bucket in ctx.cache[ex._cache_key(True)].buckets
                 for sb in bucket]
        ctx.close()
        assert ctx.last_leak_report == []
        return out, ctx.last_spill_metrics, sizes

    want, m0, _ = serve(None)
    assert m0["spill_to_host"] == 0
    from spark_rapids_tpu_torch import config as C
    conf = C.TpuConf({BUDGET_KEY: 16 * 1024,
                      "spark.rapids.memory.host.spillStorageSize": 8 * 1024,
                      "spark.rapids.memory.spill.dir": str(tmp_path)})
    got, m1, sizes = serve(conf)
    assert m1["spill_to_host"] > 0 and m1["spill_to_disk"] > 0
    assert m1["restore_from_disk"] > 0
    assert repr(got) == repr(want)
    assert sum(len(p) for p in got) == sum(700 + 100 * i for i in range(3))
    # Each piece owns its storage: registered bytes are its own capacity.
    assert len(sizes) == 12 and all(s < 40_000 for s in sizes)
