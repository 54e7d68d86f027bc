"""Port parity: the planner's collective shuffle
(``parallel/mesh_exchange.py``), as ``tests/test_mesh_planner.py`` and
``tests/test_mesh_tpch.py`` pin the JAX package's, at 8 local CPU slots
(``SRT_MESH_SLOTS=8``) beside the reference's 8 virtual devices.

- Plan shapes: with the mesh transport, the port plans the reference's
  tree (the same execs in the same order, ``MeshExchangeExec`` for hash
  shuffles and hash repartitions, at the same partition counts) for a
  group-by, a shuffled join + aggregate and TPC-H q3 from files.
- Rows: those queries and a hash repartition over the mesh equal the
  port's single-process exchange and the reference's rows.
- ``MeshExchangeExec`` alone, over a filtered child in several batches
  with a string key: each logical partition holds the reference's rows
  (as a multiset) unfolded (8 partitions) and folded (1, 3, 5 and 16
  partitions), with ``meshPartitionFolds`` where the count is not 8.
- A partitioning that is not collective-capable is skipped with a
  warning and ``meshCollectiveSkipped``; an armed ``mesh.exchange``
  fault degrades the query to the single-process exchange with
  ``meshDegrades`` 1, as in the reference; with the degrade off the
  fault reaches the recovery ladder.
- The two-phase path, with ``TWO_PHASE_MIN_SHARD_ROWS`` lowered in both
  packages: the same per-slot counts and the same piece capacity.
- TPC-H q3, q4 and q18 from files through the mesh at 8 slots and at
  ``shuffle.partitions=5`` (folded): the port's single-process rows, and
  at 8 slots the reference's rows (its host engine).

Integer rows exact; float sums within ``approx_float`` (the harness's
rel 1e-6): partial sums merge in another grouping across the mesh.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import logging
from collections import Counter

import numpy as np
import pytest

from harness import assert_rows_equal

from spark_rapids_tpu import config as JC
from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu import faults as jfaults
from spark_rapids_tpu.api.dataframe import TpuSession as JSession
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.ops import base as jbase
from spark_rapids_tpu.ops import basic as jbasic
from spark_rapids_tpu.ops import kernel_cache as jkc
from spark_rapids_tpu.parallel import mesh_exchange as JMX
from spark_rapids_tpu.parallel import partitioning as jpart
from spark_rapids_tpu.plan import logical as JL

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch import ops as TO
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar import host as thost
from spark_rapids_tpu_torch.ops.base import ExecContext
from spark_rapids_tpu_torch.parallel import mesh as M
from spark_rapids_tpu_torch.parallel import mesh_exchange as MX
from spark_rapids_tpu_torch.parallel import partitioning as tpart
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan import plan_cache as pc

SLOTS = 8


@pytest.fixture(autouse=True)
def _slots(monkeypatch):
    monkeypatch.setenv(M.SLOTS_ENV, str(SLOTS))
    state = faults.snapshot()
    faults.configure("")
    faults.reset_counters()
    jfaults.configure("")
    jfaults.reset_counters()
    yield
    faults.restore(state)
    jfaults.configure("")
    pc.cache().clear()


def _port(mesh: bool, **extra):
    conf = {C.MESH_ENABLED.key: mesh,
            "spark.rapids.sql.variableFloatAgg.enabled": True,
            "spark.rapids.sql.cost.enabled": False}
    conf.update(extra)
    return TpuSession(conf, device="cpu")


def _ref(mesh: bool, **extra):
    s = JSession()
    s.set("spark.rapids.sql.mesh.enabled", mesh)
    s.set("spark.rapids.sql.variableFloatAgg.enabled", True)
    s.set("spark.rapids.sql.cost.enabled", False)
    for k, v in extra.items():
        s.set(k, v)
    return s


def _tables(s, D, n=800, parts=5):
    rng = np.random.default_rng(11)
    facts = s.create_dataframe(
        {"k": rng.integers(0, 37, n).tolist(),
         "v": rng.integers(-100, 100, n).tolist(),
         "tag": [f"t{i % 7}" for i in range(n)]},
        [("k", D.INT64), ("v", D.INT64), ("tag", D.STRING)],
        num_partitions=parts)
    dims = s.create_dataframe(
        {"dk": list(range(37)), "w": [i * 10 for i in range(37)]},
        [("dk", D.INT64), ("w", D.INT64)], num_partitions=2)
    return facts, dims


def _q_groupby(s, D, Lm):
    facts, _ = _tables(s, D)
    return facts.group_by("k").agg(
        Lm.agg_sum(Lm.col("v")).alias("sv"),
        Lm.agg_count().alias("n")).order_by("k")


def _q_join_agg(s, D, Lm):
    facts, dims = _tables(s, D)
    j = facts.join_on(dims, ["k"], ["dk"], strategy="shuffle")
    return j.group_by("tag").agg(
        Lm.agg_sum(Lm.col("v") + Lm.col("w")).alias("s"),
        Lm.agg_count().alias("n")).order_by("tag")


def _shape(e, out=None):
    """Preorder (exec name, partitions of an exchange) of a tree."""
    out = [] if out is None else out
    part = getattr(e, "partitioning", None)
    out.append((type(e).__name__,
                None if part is None else (type(part).__name__,
                                           part.num_partitions)))
    for c in e.children:
        _shape(c, out)
    return out


QUERIES = {"groupby": _q_groupby, "join_agg": _q_join_agg}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_mesh_plan_shape_matches_reference(name):
    qf = QUERIES[name]
    got = _shape(qf(_port(True), dt, L)._physical().root)
    want = _shape(qf(_ref(True), jdt, JL)._physical().root)
    assert got == want
    assert ("MeshExchangeExec", ("HashPartitioning", SLOTS)) in got
    assert not any(n == "ShuffleExchangeExec" and p is not None
                   and p[0] == "HashPartitioning" for n, p in got)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_mesh_rows_match_single_process_and_reference(name):
    qf = QUERIES[name]
    mesh_rows = qf(_port(True), dt, L).collect()
    assert mesh_rows == qf(_port(False), dt, L).collect()
    assert mesh_rows == qf(_ref(False), jdt, JL).collect_host()


def test_mesh_repartition_rows_and_plan():
    s = _port(True)
    facts, _ = _tables(s, dt)
    df = facts.repartition(5, "k")
    root = df._physical().root
    assert ("MeshExchangeExec", ("HashPartitioning", 5)) in _shape(root)
    assert sorted(df.collect()) == sorted(facts.collect())
    assert faults.counters().get("meshPartitionFolds", 0) >= 1


# ---------------------------------------------------------------------------
# MeshExchangeExec alone, against the reference's
# ---------------------------------------------------------------------------

SCHEMA = (("k", "int64"), ("s", "string"), ("v", "int32"))


def _parts(seed=5, n_parts=5, batches=3, rows=37):
    rng = np.random.default_rng(seed)
    pool = ["", "a", "héllo", "日本語", "spark", "sparks", "a" * 19]
    out = []
    for _ in range(n_parts):
        bl = []
        for _ in range(batches):
            n = int(rng.integers(0, rows))
            bl.append({"k": rng.integers(-50, 50, n).tolist(),
                       "s": [pool[i] for i in rng.integers(0, len(pool),
                                                           n)],
                       "v": rng.integers(0, 10, n).tolist()})
        out.append(bl)
    return out


def _mesh_exchange(port: bool, parts, n, partitioning=None):
    E_, O_, P_, D_, H_ = (TE, TO, tpart, dt, thost) if port else \
        (JE, jbasic, jpart, jdt, jhost)
    schema = tuple((nm, D_.type_named(t)) for nm, t in SCHEMA)
    Src = TO.InMemorySourceExec if port else jbase.InMemorySourceExec
    kw = {"device": "cpu"} if port else {}
    src = Src(schema, [[H_.HostBatch.from_pydict(schema, b) for b in p]
                       for p in parts], **kw)
    R = E_.BoundReference
    child = O_.FilterExec(src, E_.Not(E_.EqualTo(R(2, D_.INT32),
                                                 E_.lit(4))))
    part = partitioning or P_.HashPartitioning(
        [R(0, D_.INT64), R(1, D_.STRING)], n)
    X = MX if port else JMX
    return X.MeshExchangeExec(child, part)


def _exec_rows(ex, ctx, port: bool):
    H_ = thost if port else jhost
    out = []
    for p in range(ex.num_partitions(ctx)):
        rows = [r for hb in H_.download_batches(
            list(ex.execute_device(ctx, p))) for r in hb.to_pylist()]
        out.append(Counter(repr(r) for r in rows))
    return out


@pytest.mark.parametrize("n", [8, 1, 3, 5, 16])
def test_mesh_exchange_partitions_match_reference(n):
    parts = _parts()
    want = _exec_rows(_mesh_exchange(False, parts, n),
                      jbase.ExecContext(), False)
    jfolds = jfaults.counters().get("meshPartitionFolds", 0)
    ex = _mesh_exchange(True, parts, n)
    ctx = ExecContext()
    got = _exec_rows(ex, ctx, True)
    assert got == want
    assert sum(sum(c.values()) for c in got) == sum(
        1 for p in parts for b in p for v in b["v"] if v != 4)
    c = faults.counters()
    assert c.get("meshPartitionFolds", 0) == jfolds == (0 if n == SLOTS
                                                        else 1)
    assert not c.get("meshCollectiveSkipped")
    assert not c.get("meshDegrades")
    # Served from the mesh session's catalog handles; invalidating the
    # stage drops them and the next read recomputes the same rows.
    ex.stage_invalidate(ctx)
    assert _exec_rows(ex, ctx, True) == want
    ctx.close()


def test_unsupported_partitioning_is_skipped_observably(caplog):
    parts = _parts(seed=9)

    class PortHostBound(tpart.HashPartitioning):
        collective = False

    class RefHostBound(jpart.HashPartitioning):
        @property
        def jittable(self):
            return False

    R, JR = TE.BoundReference, JE.BoundReference
    jx = _mesh_exchange(False, parts, 4, RefHostBound(
        [JR(0, jdt.INT64)], 4))
    # The reference diagnoses the skip before any compile; its host half
    # serves the single-process exchange's buckets, which its device
    # fallback serves too.
    jctx = jbase.ExecContext()
    assert jx._materialize(jctx) is None
    want = [Counter(repr(r) for hb in jx.execute_host(jctx, p)
                    for r in hb.to_pylist()) for p in range(4)]
    tx = _mesh_exchange(True, parts, 4, PortHostBound([R(0, dt.INT64)], 4))
    with caplog.at_level(logging.WARNING, "spark_rapids_tpu_torch"):
        got = _exec_rows(tx, ExecContext(), True)
    assert got == want
    assert faults.counters().get("meshCollectiveSkipped") == \
        jfaults.counters().get("meshCollectiveSkipped") == 1
    assert any("mesh collective skipped" in r.message
               for r in caplog.records)
    # The range partitioning takes its bounds from a host sample: not
    # collective-capable in the port.
    assert tpart.RangePartitioning.collective is False
    assert tpart.HashPartitioning.collective is True


def test_fault_point_degrades_like_the_reference():
    """The armed ``mesh.exchange`` site: the port's query degrades to the
    single-process exchange with the rows of its inprocess run and the
    reference's; the reference's exchange, armed the same way, degrades
    with the same counters (its fault fires before any compile)."""
    arm = "transient@mesh.exchange:1"
    jfaults.configure(arm)
    jx = _mesh_exchange(False, _parts(seed=17), 8)
    jctx = jbase.ExecContext()
    assert jx._materialize(jctx) is None and jctx.cache["mesh.degraded"]
    jc = jfaults.counters()
    df = _q_groupby(_port(True, **{"spark.rapids.sql.test.faults": arm}),
                    dt, L)
    got = df.collect()
    assert got == _q_groupby(_port(False), dt, L).collect()
    assert got == _q_groupby(_ref(False), jdt, JL).collect_host()
    c = faults.counters()
    assert c.get("meshDegrades") == jc.get("meshDegrades") == 1
    assert c.get("faultsInjected") == jc.get("faultsInjected") == 1
    deg = [v for k, v in df.metrics().items()
           if k.startswith("MeshExchangeExec") and "meshDegrades" in v]
    assert len(deg) == 1 and deg[0]["meshDegrades"] == 1


def test_fault_without_degrade_reaches_the_recovery_ladder():
    df = _q_join_agg(_port(True, **{
        "spark.rapids.sql.test.faults": "transient@mesh.exchange:1",
        C.MESH_DEGRADE_ENABLED.key: False,
        "spark.rapids.sql.retry.backoffMs": 1}), dt, L)
    assert df.collect() == _q_join_agg(_port(False), dt, L).collect()
    assert not faults.counters().get("meshDegrades")
    assert df.metrics()["Recovery@query"]["retriesAttempted"] == 1
    assert C.MESH_DEGRADE_ENABLED.default is True
    assert C.MESH_DEGRADE_ENABLED.key == JC.MESH_DEGRADE_ENABLED.key
    assert C.MESH_DEGRADE_ENABLED.default == JC.MESH_DEGRADE_ENABLED.default


def test_two_phase_counts_and_piece_capacity_match_reference(monkeypatch):
    monkeypatch.setattr(MX, "TWO_PHASE_MIN_SHARD_ROWS", 8)
    monkeypatch.setattr(JMX, "TWO_PHASE_MIN_SHARD_ROWS", 8)
    seen = {"port": [], "ref": [], "port_cap": [], "ref_cap": []}

    counts_fn = M.exchange_counts

    def port_counts(*a, **kw):
        out = counts_fn(*a, **kw)
        seen["port"].append([c.tolist() for c in out])
        return out

    a2a = M.all_to_all_exchange

    def port_a2a(*a, **kw):
        seen["port_cap"].append(kw.get("piece_capacity"))
        return a2a(*a, **kw)

    monkeypatch.setattr(M, "exchange_counts", port_counts)
    monkeypatch.setattr(M, "all_to_all_exchange", port_a2a)

    counts_step = JMX.MeshExchangeExec._counts_step
    build_step = JMX.MeshExchangeExec._build_step

    def ref_counts_step(self, mesh, n, fold):
        fn = counts_step(self, mesh, n, fold)

        def wrapped(*a):
            out = fn(*a)
            seen["ref"].append(np.asarray(out).tolist())
            return out
        return wrapped

    def ref_build_step(self, mesh, n, fold, piece_capacity=None):
        seen["ref_cap"].append(piece_capacity)
        return build_step(self, mesh, n, fold, piece_capacity=piece_capacity)

    monkeypatch.setattr(JMX.MeshExchangeExec, "_counts_step",
                        ref_counts_step)
    monkeypatch.setattr(JMX.MeshExchangeExec, "_build_step",
                        ref_build_step)
    jkc.cache().clear()
    parts = _parts(seed=13, n_parts=8, batches=2, rows=300)
    want = _exec_rows(_mesh_exchange(False, parts, 8), jbase.ExecContext(),
                      False)
    got = _exec_rows(_mesh_exchange(True, parts, 8), ExecContext(), True)
    assert got == want
    assert len(seen["ref"]) == len(seen["port"]) == 1
    ref_counts = np.asarray(seen["ref"][0]).reshape(SLOTS, SLOTS).tolist()
    assert seen["port"][0] == ref_counts
    assert seen["ref_cap"] == seen["port_cap"]
    cap = seen["port_cap"][0]
    assert cap is not None and cap >= max(max(r) for r in ref_counts)


# ---------------------------------------------------------------------------
# TPC-H from files
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_mesh"))
    jtpch.generate(d, scale=0.004, files_per_table=4, seed=0)
    return d


def _mesh_exchanges(e, out=None):
    out = [] if out is None else out
    if isinstance(e, MX.MeshExchangeExec):
        out.append(e)
    for c in e.children:
        _mesh_exchanges(c, out)
    return out


def test_q3_mesh_plan_matches_reference(data_dir):
    got = tpch.QUERIES["q3"](_port(True), data_dir)._physical().root
    want = jtpch.QUERIES["q3"](_ref(True), data_dir)._physical().root
    assert _shape(got) == _shape(want)
    assert len(_mesh_exchanges(got)) >= 1


@pytest.mark.parametrize("q", ["q3", "q4", "q18"])
@pytest.mark.parametrize("parts", [None, 5])
def test_tpch_through_the_mesh(q, parts, data_dir):
    extra = {} if parts is None else {
        "spark.rapids.sql.shuffle.partitions": parts}
    df = tpch.QUERIES[q](_port(True, **extra), data_dir)
    assert _mesh_exchanges(df._physical().root)
    got = df.collect()
    single = tpch.QUERIES[q](_port(False, **dict(
        extra or {"spark.rapids.sql.shuffle.partitions": SLOTS})),
        data_dir).collect()
    assert_rows_equal(got, single, approx_float=True,
                      msg=f"{q} mesh vs inprocess")
    c = faults.counters()
    assert bool(c.get("meshPartitionFolds")) == (parts is not None)
    assert not c.get("meshDegrades") and not c.get("meshCollectiveSkipped")
    if parts is None:
        want = jtpch.QUERIES[q](_ref(True), data_dir).collect_host()
        assert_rows_equal(got, want, approx_float=True,
                          msg=f"{q} port mesh vs reference")
