"""Port parity: stage fusion and the structural fingerprint
(``plan/fusion.py``, ``ops/fused.py``, ``ops/kernel_cache.py``), as
``tests/test_stage_fusion.py`` pins the JAX package's.

- A Project -> Filter -> Project chain plans as one ``FusedStageExec`` of
  three members, as the JAX package's planner fuses it, and runs as one
  step; ``stageFusion.enabled`` off restores the unfused tree.
- Stages break at an aggregate, at a host island (a string cast, a LIKE
  with ``_``) and at a task-context expression.
- A LocalLimit budget and an Expand's fan-out thread through a fused
  stage; fused rows equal the unfused plan's, bit for bit, on the device
  engine and on the host engine.
- A repeated query through a fresh session plans stages of the same
  fingerprint (what a cache of composed steps keys on); the fingerprint is
  structural and value-free for bind slots; ``explain`` and ``tree`` name
  each fused stage's members; its metrics carry ``numFusedStages`` and
  ``numFusedOps``.

Tolerance: bit-identical (fused against unfused: the same torch ops in the
same order); against the JAX package, float sums at ``approx_float``.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import pytest

from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.ops.fused import FusedStageExec as JFused
from spark_rapids_tpu.plan import logical as JL

from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import suites, tpch
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.ops import ExecContext
from spark_rapids_tpu_torch.ops import kernel_cache as kc
from spark_rapids_tpu_torch.ops.basic import (
    ExpandExec, FilterExec, LocalLimitExec, ProjectExec)
from spark_rapids_tpu_torch.ops.fused import FusedStageExec
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan import plan_cache as pc
from spark_rapids_tpu_torch.plan.fusion import fusible

from harness import assert_rows_equal

VFA = {"spark.rapids.sql.variableFloatAgg.enabled": True}
UNFUSED = {"spark.rapids.sql.stageFusion.enabled": False}
REF_OFF = {"spark.rapids.sql.cost.enabled": False,
           "spark.rapids.sql.pipeline.enabled": False,
           "spark.rapids.sql.shuffle.partitions": 1}


@pytest.fixture(autouse=True)
def _fresh_caches():
    pc.cache().clear()
    yield
    pc.cache().clear()


def _chain(M, s, dtmod):
    df = s.create_dataframe(
        {"k": [1, 2, 3, 4, 5, 6], "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]},
        [("k", dtmod.INT64), ("v", dtmod.FLOAT64)], num_partitions=2)
    return df.select((M.col("v") * 2).alias("v2"), "k") \
        .filter(M.col("v2") > 2.0) \
        .select((M.col("v2") + 1).alias("v3"), "k")


def _find(node, cls):
    out = []

    def rec(n):
        if isinstance(n, cls):
            out.append(n)
        for c in n.children:
            rec(c)
    rec(node)
    return out


def _members(fused):
    return [[type(o).__name__ for o in f.ops] for f in fused]


# ---------------------------------------------------------------------------
# Shape
# ---------------------------------------------------------------------------

def test_project_filter_project_fuses_to_one_stage():
    phys = _chain(L, TpuSession(device="cpu"), dt)._physical()
    jphys = _chain(JL, JSession(REF_OFF), jdt)._physical()
    fused = _find(phys.root, FusedStageExec)
    assert _members(fused) == _members(_find(jphys.root, JFused)) == [
        ["ProjectExec", "FilterExec", "ProjectExec"]]
    assert phys.num_fused_stages == 1
    assert not _find(phys.root, ProjectExec)
    assert not _find(phys.root, FilterExec)


def test_chain_runs_as_one_cached_step():
    """One step a batch, the stage's: no member runs on its own."""
    q = _chain(L, TpuSession(device="cpu"), dt)
    phys = q._physical()
    ctx = ExecContext(phys.conf)
    got = sorted(phys.collect(ctx))
    assert got == sorted(q.collect_host()) == [(5.0, 2), (7.0, 3), (9.0, 4),
                                               (11.0, 5), (13.0, 6)]
    owners = [k.split("@")[0].split("[")[0] for k in ctx.metrics]
    assert owners.count("FusedStageExec") == 1
    assert "ProjectExec" not in owners and "FilterExec" not in owners


def test_gate_off_restores_unfused_plan():
    q = _chain(L, TpuSession(UNFUSED, device="cpu"), dt)
    phys = q._physical()
    assert not _find(phys.root, FusedStageExec)
    assert len(_find(phys.root, ProjectExec)) == 2
    assert _find(phys.root, FilterExec)
    assert phys.num_fused_stages == 0
    fused = _chain(L, TpuSession(device="cpu"), dt)
    assert q.collect() == fused.collect()


def test_stage_breaks_at_aggregate():
    def q(M, s, dtmod):
        df = s.create_dataframe(
            {"k": [1, 1, 2, 2], "v": [1.0, 2.0, 3.0, 4.0]},
            [("k", dtmod.INT64), ("v", dtmod.FLOAT64)])
        return df.filter(M.col("v") > 1.0) \
            .select("k", (M.col("v") * 10).alias("w")) \
            .group_by("k").agg(M.agg_sum(M.col("w")).alias("sw")) \
            .select("k", (M.col("sw") + 1).alias("sw1"))
    t = q(L, TpuSession(VFA, device="cpu"), dt)
    j = q(JL, JSession(dict(VFA, **REF_OFF)), jdt)
    fused = _find(t._physical().root, FusedStageExec)
    assert _members(fused) == _members(_find(j._physical().root, JFused)) \
        == [["FilterExec", "ProjectExec"]]
    assert sorted(t.collect()) == sorted(j.collect()) == [(1, 21.0),
                                                          (2, 71.0)]


BREAKS = {
    # A string cast and a LIKE with ``_`` are host islands; spark_partition_id
    # needs the task context. Each stays out of the stage.
    "string_cast": lambda M: M.col("s").cast(
        (jdt if M is JL else dt).INT64).alias("c"),
    "like_underscore": lambda M: M.col("s").like("1_").alias("c"),
    "partition_id": lambda M: M.spark_partition_id().alias("c"),
}


@pytest.mark.parametrize("name", sorted(BREAKS))
def test_stage_breaks_at_islands_and_context(name):
    def q(M, s, dtmod):
        df = s.create_dataframe({"k": [1, 2, 3, 4], "s": ["10", "12", "7",
                                                          "13"]},
                                [("k", dtmod.INT64), ("s", dtmod.STRING)])
        return df.filter(M.col("k") > 1).select("k", "s") \
            .select("k", BREAKS[name](M)).filter(M.col("k") < 4) \
            .select((M.col("k") * 3).alias("k3"), "c")
    t = q(L, TpuSession(VFA, device="cpu"), dt)
    j = q(JL, JSession(dict(VFA, **REF_OFF)), jdt)
    phys = t._physical()
    island = [op for op in _find(phys.root, ProjectExec)
              if not fusible(op)]
    assert len(island) == 1
    assert _members(_find(phys.root, FusedStageExec)) == _members(
        _find(j._physical().root, JFused)) == [
            ["FilterExec", "ProjectExec"], ["FilterExec", "ProjectExec"]]
    assert t.collect() == j.collect()
    assert t.collect() == q(L, TpuSession(dict(VFA, **UNFUSED),
                                          device="cpu"), dt).collect()


def test_local_limit_budget_threads_through_fusion():
    """The limit's per-partition budget carries across batches inside the
    stage (batches of 5 rows, a budget of 12)."""
    def q(conf):
        s = TpuSession(dict(conf, **{"spark.rapids.sql.batchSizeRows": 5}),
                       device="cpu")
        df = s.range(0, 40, num_partitions=2)
        return df.select((L.col("id") * 2).alias("v")) \
            .filter(L.col("v") % 3 != 0).limit(12)
    fused, unfused = q({}), q(UNFUSED)
    stages = _find(fused._physical().root, FusedStageExec)
    assert _members(stages) == [["ProjectExec", "FilterExec",
                                 "LocalLimitExec"]]
    ctx = ExecContext(fused._physical().conf)
    rows = fused._physical().collect(ctx)
    assert rows == unfused.collect() and len(rows) == 12
    m = next(v for k, v in ctx.metrics.items()
             if k.startswith("FusedStageExec["))
    assert m.values["numFusedStages"] == 1 and m.values["numFusedOps"] == 3


def test_expand_fans_out_through_a_fused_stage():
    """A ROLLUP's Expand under a projection: one input batch, one output
    batch per grouping set, from one cached step."""
    def q(M, s, dtmod):
        df = s.create_dataframe(
            {"a": [1, 1, 2, 2, 3], "b": [10, 20, 10, 20, 10],
             "v": [1, 2, 3, 4, 5]},
            [("a", dtmod.INT64), ("b", dtmod.INT64), ("v", dtmod.INT64)])
        return df.select("a", "b", (M.col("v") * 2).alias("w")) \
            .rollup("a", "b").agg(M.agg_sum(M.col("w")).alias("sw")) \
            .order_by("a", "b")
    t = q(L, TpuSession(VFA, device="cpu"), dt)
    stages = _find(t._physical().root, FusedStageExec)
    assert any("ExpandExec" in ms for ms in _members(stages))
    got = t.collect()
    assert got == q(L, TpuSession(dict(VFA, **UNFUSED), device="cpu"),
                    dt).collect()
    assert got == q(JL, JSession(dict(VFA, **REF_OFF)), jdt).collect()
    assert len(got) == 9


# ---------------------------------------------------------------------------
# Fused against unfused on whole queries
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tables():
    s = TpuSession(VFA, device="cpu")
    return tpch.tpch_tables(s, E.tpch_columns(0.002, seed=9))


@pytest.mark.parametrize("q", ["q1", "q6", "q3"])
@pytest.mark.parametrize("engine", ["device", "host"])
def test_fused_rows_equal_unfused(q, engine, tables):
    conf = dict(VFA) if engine == "device" else \
        dict(VFA, **{"spark.rapids.sql.enabled": False})
    fused = tpch.QUERIES[q](TpuSession(conf, device="cpu"), tables[q])
    unfused = tpch.QUERIES[q](TpuSession(dict(conf, **UNFUSED),
                                         device="cpu"), tables[q])
    if engine == "device":
        # q6's lone filter under its aggregate has nothing to fuse with.
        assert (fused._physical().num_fused_stages >= 1) == (q != "q6")
    assert [tuple(map(repr, r)) for r in fused.collect()] == \
        [tuple(map(repr, r)) for r in unfused.collect()]


def test_q67_fused_rows_equal_unfused():
    cols = suites.suite_columns(0.002)
    conf = dict(VFA, **{"spark.rapids.sql.shuffle.partitions": 1})
    got = {}
    for name, extra in (("fused", {}), ("unfused", UNFUSED)):
        s = TpuSession(dict(conf, **extra), device="cpu")
        t = suites.suite_tables(s, cols, ("q67",))
        df = suites.QUERIES["q67"](s, t["q67"])
        if name == "fused":
            assert df._physical().num_fused_stages >= 1
        got[name] = [tuple(map(repr, r)) for r in df.collect()]
    assert got["fused"] == got["unfused"] and got["fused"]


def test_repeat_through_a_fresh_session_misses_nothing(tables):
    first = tpch.QUERIES["q1"](TpuSession(VFA, device="cpu"),
                               tables["q1"]).collect()
    keys = _stage_keys(tpch.QUERIES["q1"](TpuSession(VFA, device="cpu"),
                                          tables["q1"])._physical().root)
    pc.cache().clear()
    df = tpch.QUERIES["q1"](TpuSession(VFA, device="cpu"), tables["q1"])
    second = df.collect()
    assert not df._physical().cache_hit
    assert keys and _stage_keys(df._physical().root) == keys
    assert first == second


def _stage_keys(root):
    """The fingerprints of a plan's fused stages, in tree order."""
    return [kc.fingerprint(tuple(op._specs))
            for op in _find(root, FusedStageExec)]


def test_fused_rows_match_reference(tables, monkeypatch):
    from test_torch_logical import jax_query, jax_tables
    js = JSession(dict(VFA, **REF_OFF))
    jt = jax_tables(js, tables)
    for q in ("q1", "q6"):
        got = tpch.QUERIES[q](TpuSession(VFA, device="cpu"),
                              tables[q]).collect()
        want = jax_query(monkeypatch, q, js, jt[q]).collect()
        assert_rows_equal(got, want, approx_float=True, msg=q)


# ---------------------------------------------------------------------------
# Observability and the fingerprint
# ---------------------------------------------------------------------------

def test_explain_and_tree_render_fused_stage():
    phys = _chain(L, TpuSession(device="cpu"), dt)._physical()
    assert "FusedStageExec [ProjectExec, FilterExec, ProjectExec]" \
        in phys.tree()
    report = phys.explain()
    assert "Fused stages: 1" in report
    assert ("*Stage #0 <FusedStageExec[ProjectExec->FilterExec->"
            "ProjectExec]> fuses [ProjectExec, FilterExec, ProjectExec]"
            in report)


def test_fused_metrics_owner_and_cache_counters():
    phys = _chain(L, TpuSession(device="cpu"), dt)._physical()
    ctx = ExecContext(phys.conf)
    phys.collect(ctx)
    key = next(k for k in ctx.metrics if k.startswith("FusedStageExec["))
    vals = ctx.metrics[key].values
    assert vals["numFusedStages"] == 1 and vals["numFusedOps"] == 3
    assert vals["numOutputBatches"] == 2
    assert "compileTime" not in vals


def test_fingerprint_is_structural_and_value_free_for_slots():
    from spark_rapids_tpu_torch.exprs.bindslots import BindSlotExpr
    from spark_rapids_tpu_torch.exprs.base import lit
    assert kc.fingerprint(BindSlotExpr(0, dt.INT32)) == \
        ("bindslot", 0, "int32")
    assert kc.fingerprint(lit(3)) != kc.fingerprint(lit(4))
    assert kc.fingerprint(lit(float("nan"))) == kc.fingerprint(
        lit(float("nan")))
    import torch
    a, b = torch.arange(4), torch.arange(4)
    assert kc.fingerprint(a) == kc.fingerprint(b) != kc.fingerprint(a + 1)


def test_limit_member_exec_keeps_its_binding():
    """A LocalLimit member with a bind-slot budget resolves it per
    execution inside the stage."""
    s = TpuSession(device="cpu")
    df = s.range(0, 30)
    a = df.select((L.col("id") + 1).alias("x")).filter(
        L.col("x") > 2).limit(4)
    b = df.select((L.col("id") + 1).alias("x")).filter(
        L.col("x") > 2).limit(7)
    assert a.collect() == [(3,), (4,), (5,), (6,)]
    assert b.collect() == [(i,) for i in range(3, 10)]
    assert b._physical().cache_hit
    lim = [op for f in _find(b._physical().root, FusedStageExec)
           for op in f.ops if isinstance(op, LocalLimitExec)]
    assert lim and not isinstance(lim[0].limit, int)
    assert not _find(b._physical().root, ExpandExec)
