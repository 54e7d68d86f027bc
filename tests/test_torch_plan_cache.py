"""Port parity: the parameterized plan cache and bind slots
(``plan/plan_cache.py``, ``exprs/bindslots.py``), as
``tests/test_plan_cache.py`` pins the JAX package's (without its
scheduler, span and fault cases, whose layers are not ported).

- ``parameterize`` hoists only the safe positions, numbers slots in one
  order and gives a wide literal an int64 slot, as the reference's does.
- A rebind of the same shape is a plan-cache hit whose per-batch steps
  fingerprint as a fresh plan of that binding's do (bind slots are
  value-free); a DataFrame built anew with the same literals hits too and
  reuses the template's packed sources; limits bind; a file scan's pushed
  predicates resolve per binding; conf, schema and device changes miss,
  and so does a scanned file rewritten in place;
  uncacheable shapes plan fresh; the disabled control returns a plain
  ``PhysicalPlan``; ``explain`` names the provenance; ``prepare()``
  returns the bound handle.
- Two bindings each of TPC-H q1 (the ship-date cutoff) and q6 (date band,
  discount band, quantity bound) give the JAX package's rows, and a bind
  slot gives the inline literal's type promotion (int32 slot against
  int64 and date columns, a float slot against a double column, a
  subnormal double binding).

Tolerance: rows bit-identical to the cache-off control (the same
operations in the same order); against the JAX package, float SUM/AVG
at ``approx_float`` (harness), everything else exact. Every case clears
the plan cache around it.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import numpy as np
import pytest

from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu.plan import plan_cache as jpc

from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch.api import DataFrame, TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.ops import ExecContext
from spark_rapids_tpu_torch.ops import kernel_cache as kc
from spark_rapids_tpu_torch.ops.basic import FilterExec, ProjectExec
from spark_rapids_tpu_torch.ops.fused import FusedStageExec
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan import plan_cache as pc
from spark_rapids_tpu_torch.plan.plan_cache import BoundPlan

from harness import assert_rows_equal
from test_torch_logical import jax_parts, jschema

VFA = {"spark.rapids.sql.variableFloatAgg.enabled": True}
OFF = {"spark.rapids.sql.planCache.enabled": False}
# The reference's layers the port has not ported, off for the comparison.
REF = dict(VFA, **{"spark.rapids.sql.cost.enabled": False,
                   "spark.rapids.sql.shuffle.partitions": 1})


@pytest.fixture(autouse=True)
def _fresh_cache():
    pc.cache().clear()
    yield
    pc.cache().clear()


@pytest.fixture(scope="module")
def cols():
    return E.tpch_columns(0.002, seed=4)


@pytest.fixture(scope="module")
def lineitem(cols):
    """(port lineitem partitions, their schema: q1's columns, which hold
    q6's): one table object shared by every session of the module, so
    templates can be shared."""
    t = tpch.tpch_tables(TpuSession(VFA, device="cpu"), cols)["q1"]
    li = t["lineitem"]
    return li._plan.partitions, li._plan.source_schema


def _li(session, lineitem):
    parts, schema = lineitem
    return DataFrame(session, L.InMemoryScan(schema, parts))


def _jli(jsession, lineitem):
    from spark_rapids_tpu.api import DataFrame as JDataFrame
    parts, schema = lineitem
    return JDataFrame(jsession, JL.InMemoryScan(jschema(schema),
                                                jax_parts(parts)))


def _q6(M, li, lo="1994-01-01", hi="1995-01-01", d=(0.05, 0.07),
        qty=24.0):
    f = li.filter((M.col("l_shipdate") >= M.lit_col(tpch.days(lo)))
                  & (M.col("l_shipdate") < M.lit_col(tpch.days(hi)))
                  & (M.col("l_discount") >= d[0])
                  & (M.col("l_discount") <= d[1])
                  & (M.col("l_quantity") < qty))
    return f.agg(M.agg_sum(M.col("l_extendedprice") * M.col("l_discount"))
                 .alias("revenue"))


def _q1(M, li, cutoff="1998-09-02"):
    disc = li.filter(M.col("l_shipdate") <= M.lit_col(tpch.days(cutoff))) \
        .with_column("disc_price",
                     M.col("l_extendedprice") * (1.0 - M.col("l_discount")))
    return disc.group_by("l_returnflag", "l_linestatus").agg(
        M.agg_sum(M.col("l_quantity")).alias("sum_qty"),
        M.agg_sum(M.col("disc_price")).alias("sum_disc_price"),
        M.agg_avg(M.col("l_quantity")).alias("avg_qty"),
        M.agg_count().alias("n"),
    ).order_by("l_returnflag", "l_linestatus")


# ---------------------------------------------------------------------------
# Parameterization rules (against the reference's parameterize)
# ---------------------------------------------------------------------------

def _shaped(M, session, dtmod):
    df = session.create_dataframe({"a": [1], "s": ["xy"]},
                                  [("a", dtmod.INT64), ("s", dtmod.STRING)])
    return df.filter((M.col("a") > M.lit_col(5))
                     & (M.col("s") == M.lit_col("xy"))
                     & M.col("s").isin("p", "q")) \
        .with_column("b", M.col("a") * 2 + M.lit_col(2 ** 40)) \
        .with_column("r", M.round_col(M.col("a") * 1.5, 2)).limit(4)


def test_parameterize_hoists_only_safe_positions():
    got = pc.parameterize(_shaped(L, TpuSession(device="cpu"), dt)._plan)
    want = jpc.parameterize(_shaped(JL, JSession(), jdt)._plan)
    # The int comparison, the arithmetic operands and the limit hoist; the
    # string literal, the isin set and round's scale stay inline.
    assert got[1] == want[1] == (5, 2, 2 ** 40, 1.5, 4)
    assert [t.name for t in got[2]] == [t.name for t in want[2]] == [
        "int32", "int32", "int64", "float64", "int64"]
    assert pc.plan_key(got[0]) is not None


def test_parameterize_slot_order_deterministic():
    df = _shaped(L, TpuSession(device="cpu"), dt)
    a, b = pc.parameterize(df._plan), pc.parameterize(df._plan)
    assert a[1] == b[1] and a[2] == b[2]
    assert pc.plan_key(a[0]) == pc.plan_key(b[0])


def test_int64_literal_gets_wide_slot():
    s = TpuSession(VFA, device="cpu")
    df = s.create_dataframe({"a": [2 ** 40, 5]}, [("a", dt.INT64)])
    q = df.filter(L.col("a") > L.lit_col(2 ** 35))
    assert q.collect() == [(2 ** 40,)]
    _, values, dtypes = pc.parameterize(q._plan)
    assert values == (2 ** 35,) and dtypes == (dt.INT64,)


def test_uncacheable_shapes_plan_fresh():
    s = TpuSession(VFA, device="cpu")
    df = s.create_dataframe({"a": [1, 2]}, [("a", dt.INT64)])
    c0 = pc.counters().get("planCacheUncacheable", 0)
    out = df.select("a", L.explode(L.col("a"), L.col("a") + 1).alias("e"))
    phys = out._physical()
    assert not isinstance(phys, BoundPlan)
    assert sorted(out.collect()) == [(1, 1), (1, 2), (2, 2), (2, 3)]
    assert pc.counters().get("planCacheUncacheable", 0) == c0 + 1
    with pytest.raises(pc.Uncacheable):
        pc.plan_key(out._plan)


# ---------------------------------------------------------------------------
# Hits, binds and invalidation
# ---------------------------------------------------------------------------

def _step_keys(root):
    """The structural fingerprint of every per-batch device step in a plan
    (fused stages, projections, filters): what a cache of composed steps
    keys on."""
    out = []

    def rec(n):
        if isinstance(n, FusedStageExec):
            out.append(kc.fingerprint(tuple(n._specs)))
        elif isinstance(n, ProjectExec):
            out.append(kc.fingerprint(tuple(n.exprs)))
        elif isinstance(n, FilterExec):
            out.append(kc.fingerprint(n.condition))
        for c in n.children:
            rec(c)
    rec(root)
    return out


def test_rebind_hits_with_value_free_step_keys(lineitem):
    s = TpuSession(VFA, device="cpu")
    first = _q6(L, _li(s, lineitem))
    first.collect()
    st0 = pc.cache().stats()
    df = _q6(L, _li(s, lineitem), "1995-01-01", "1996-01-01", (0.02, 0.04),
             30.0)
    got = df.collect()
    assert df._physical().cache_hit
    assert df._physical().template is first._physical().template
    assert pc.cache().stats()["hits"] == st0["hits"] + 1
    # Planned afresh, the second binding's steps key as the template's.
    keys = _step_keys(first._physical().root)
    pc.cache().clear()
    fresh = _q6(L, _li(s, lineitem), "1995-01-01", "1996-01-01",
                (0.02, 0.04), 30.0)._physical()
    assert not fresh.cache_hit and keys and _step_keys(fresh.root) == keys
    control = _q6(L, _li(TpuSession(dict(VFA, **OFF), device="cpu"),
                         lineitem), "1995-01-01", "1996-01-01",
                  (0.02, 0.04), 30.0).collect()
    assert got == control


def test_same_literals_rebuild_is_a_hit_and_shares_the_packing(lineitem):
    s = TpuSession(VFA, device="cpu")
    a = _q1(L, _li(s, lineitem))
    ctx_a = ExecContext(s.conf)
    rows_a = a._physical().collect(ctx_a)
    b = _q1(L, _li(s, lineitem))
    ctx_b = ExecContext(s.conf)
    rows_b = b._physical().collect(ctx_b)
    assert b._physical().cache_hit and rows_a == rows_b
    assert b._physical().template is a._physical().template

    def pack_ns(ctx):
        return sum(m.values.get("packTime", 0) for k, m in
                   ctx.metrics.items() if k.startswith("InMemorySourceExec"))
    # The template's source packed its batches once; the rebuilt
    # DataFrame's collect only looks them up.
    assert pack_ns(ctx_a) > 0
    src = [k for k in ctx_b.metrics if k.startswith("InMemorySourceExec")]
    assert src and set(src) == {k for k in ctx_a.metrics
                                if k.startswith("InMemorySourceExec")}


def test_limit_values_bind(lineitem):
    s = TpuSession(VFA, device="cpu")
    base = _li(s, lineitem).select("l_shipdate", "l_quantity")
    a = base.limit(3).collect()
    st0 = pc.cache().stats()
    df = base.limit(9)
    b = df.collect()
    assert len(a) == 3 and len(b) == 9
    assert pc.cache().stats()["hits"] == st0["hits"] + 1
    assert df._physical().bind_values == (9,)
    want = _jli(JSession(REF), lineitem).select(
        "l_shipdate", "l_quantity").limit(9).collect()
    assert b == want


def test_pushdown_predicates_resolve_per_binding(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as papq
    path = str(tmp_path / "t.parquet")
    papq.write_table(pa.table({"x": pa.array(np.arange(400, dtype=np.int64)),
                               "y": pa.array(np.arange(400.0))}), path,
                     row_group_size=100)
    s = TpuSession(VFA, device="cpu")
    base = s.read.parquet(path)

    def q(lo, hi):
        return base.filter((L.col("x") >= L.lit_col(lo))
                           & (L.col("x") < L.lit_col(hi)))

    def run(df):
        ctx = ExecContext(s.conf)
        rows = df._physical().collect(ctx)
        skipped = sum(m.values.get("numSkippedRowGroups", 0)
                      for m in ctx.metrics.values())
        return rows, skipped

    a, skipped_a = run(q(10, 20))
    assert [r[0] for r in a] == list(range(10, 20)) and skipped_a == 3
    st0 = pc.cache().stats()
    # Binding B lives in the LAST row group: skipping by the template's
    # first predicates would return no row.
    df = q(350, 360)
    b, skipped_b = run(df)
    assert pc.cache().stats()["hits"] == st0["hits"] + 1
    assert [r[0] for r in b] == list(range(350, 360)) and skipped_b == 3
    c, skipped_c = run(q(50, 250))
    assert [r[0] for r in c] == list(range(50, 250)) and skipped_c == 1


def test_file_rewritten_in_place_misses(tmp_path):
    """A template's scan fixed its row groups at plan time: the same path
    rewritten with more row groups must plan anew and read every row."""
    import pyarrow as pa
    import pyarrow.parquet as papq
    path = str(tmp_path / "t.parquet")

    def write(n):
        papq.write_table(pa.table({"x": pa.array(np.arange(n,
                                                           dtype=np.int64))}),
                         path, row_group_size=100)
    s = TpuSession(VFA, device="cpu")

    def read():
        df = s.read.parquet(path).filter(L.col("x") >= L.lit_col(0))
        return df, df.collect()
    write(200)
    df, rows = read()
    assert len(rows) == 200 and not df._physical().cache_hit
    df, rows = read()
    assert len(rows) == 200 and df._physical().cache_hit
    write(450)
    df, rows = read()
    assert not df._physical().cache_hit
    assert [r[0] for r in rows] == list(range(450))


def test_conf_change_invalidates(lineitem):
    s = TpuSession(VFA, device="cpu")
    _q6(L, _li(s, lineitem)).collect()
    st0 = pc.cache().stats()
    s.set("spark.rapids.sql.shuffle.partitions", 3)
    _q6(L, _li(s, lineitem)).collect()
    assert pc.cache().stats()["misses"] == st0["misses"] + 1


def test_schema_change_misses():
    s = TpuSession(VFA, device="cpu")
    data = {"a": [1, 2, 3]}
    d32 = s.create_dataframe(data, [("a", dt.INT32)])
    d64 = s.create_dataframe(data, [("a", dt.INT64)])
    r32 = d32.filter(L.col("a") > L.lit_col(1)).collect()
    st0 = pc.cache().stats()
    r64 = d64.filter(L.col("a") > L.lit_col(1)).collect()
    assert pc.cache().stats()["misses"] == st0["misses"] + 1
    assert r32 == r64 == [(2,), (3,)]


def test_device_change_misses(lineitem):
    cpu = TpuSession(VFA, device="cpu")
    # Planning touches no device, so a session for the card plans here.
    card = TpuSession(VFA, device="cuda")
    a = _q6(L, _li(cpu, lineitem)).prepare()
    b = _q6(L, _li(card, lineitem)).prepare()
    assert not a.cache_hit and not b.cache_hit
    assert a.template is not b.template
    assert pc.cache().stats()["entries"] == 2
    assert _q6(L, _li(cpu, lineitem)).prepare().template is a.template


def test_disabled_control_returns_plain_physical_plan(lineitem):
    df = _q6(L, _li(TpuSession(dict(VFA, **OFF), device="cpu"), lineitem))
    phys = df._physical()
    assert not isinstance(phys, BoundPlan)
    assert not hasattr(phys, "provenance")
    assert "plan-cache" not in phys.explain("ALL")


def test_env_switch(monkeypatch, lineitem):
    monkeypatch.setenv("SRT_PLAN_CACHE", "0")
    phys = _q6(L, _li(TpuSession(VFA, device="cpu"), lineitem))._physical()
    assert not isinstance(phys, BoundPlan)
    # The conf key beats the env.
    s = TpuSession(dict(VFA, **{"spark.rapids.sql.planCache.enabled": True}),
                   device="cpu")
    assert isinstance(_q6(L, _li(s, lineitem))._physical(), BoundPlan)


def test_lru_bound(lineitem):
    s = TpuSession(dict(VFA, **{"spark.rapids.sql.planCache.maxEntries": 2}),
                   device="cpu")
    for qty in (10.0, 20.0):
        _q6(L, _li(s, lineitem), qty=qty).prepare()
    assert pc.cache().stats()["entries"] == 1       # one shape, two binds
    s.set("spark.rapids.sql.shuffle.partitions", 2)
    _q6(L, _li(s, lineitem)).prepare()
    s.set("spark.rapids.sql.shuffle.partitions", 3)
    _q6(L, _li(s, lineitem)).prepare()
    st = pc.cache().stats()
    assert st["entries"] == 2 and st["evictions"] == 1


# ---------------------------------------------------------------------------
# Provenance and handles
# ---------------------------------------------------------------------------

def test_explain_annotates_provenance(lineitem):
    s = TpuSession(VFA, device="cpu")
    rep0 = _q6(L, _li(s, lineitem))._physical().explain("ALL")
    assert rep0.startswith("[plan-cache miss, template planned; 5 bind")
    rep1 = _q6(L, _li(s, lineitem), "1995-01-01",
               "1996-01-01")._physical().explain("ALL")
    assert rep1.startswith("[plan-cache hit, bind-only; 5 bind slot(s)]")


def test_prepare_returns_bound_handle(lineitem):
    s = TpuSession(VFA, device="cpu")
    _q6(L, _li(s, lineitem)).collect()
    handle = _q6(L, _li(s, lineitem), "1995-01-01", "1996-01-01").prepare()
    assert isinstance(handle, BoundPlan) and handle.cache_hit
    assert handle.bind_values == (tpch.days("1995-01-01"),
                                  tpch.days("1996-01-01"), 0.05, 0.07, 24.0)
    control = _q6(L, _li(TpuSession(dict(VFA, **OFF), device="cpu"),
                         lineitem), "1995-01-01", "1996-01-01").collect()
    assert handle.collect() == control
    c = pc.counters()
    assert c["bindOnlyExecutions"] >= 1 and c["planBindNs"] > 0


@pytest.mark.parametrize("band", [("1994-01-01", "1995-01-01"),
                                  ("1993-01-01", "1997-01-01")])
def test_host_engine_binds_per_execution(lineitem, band):
    """Every node on the host engine: the bound literals reach the host
    closures, each execution its own, on a miss and on a hit."""
    conf = dict(VFA, **{"spark.rapids.sql.enabled": False})
    s = TpuSession(conf, device="cpu")
    _q6(L, _li(s, lineitem), "1992-01-01", "1993-01-01").collect()
    df = _q6(L, _li(s, lineitem), *band)
    got = df._physical().collect(ExecContext(s.conf))
    assert df._physical().cache_hit and not df._physical().root_on_device
    control = _q6(L, _li(TpuSession(dict(conf, **OFF), device="cpu"),
                         lineitem), *band).collect()
    assert got == control


# ---------------------------------------------------------------------------
# Two bindings of q1 and q6 against the JAX package
# ---------------------------------------------------------------------------

Q6_BINDINGS = [("1994-01-01", "1995-01-01", (0.05, 0.07), 24.0),
               ("1995-01-01", "1996-06-01", (0.01, 0.09), 40.0)]
Q1_BINDINGS = ["1998-09-02", "1995-06-17"]


def test_q6_two_bindings_match_reference(lineitem):
    s = TpuSession(VFA, device="cpu")
    js = JSession(REF)
    hits = []
    for lo, hi, d, qty in Q6_BINDINGS:
        df = _q6(L, _li(s, lineitem), lo, hi, d, qty)
        got = df.collect()
        hits.append(df._physical().cache_hit)
        want = _q6(JL, _jli(js, lineitem), lo, hi, d, qty).collect()
        assert_rows_equal(got, want, approx_float=True, msg=lo)
        control = _q6(L, _li(TpuSession(dict(VFA, **OFF), device="cpu"),
                             lineitem), lo, hi, d, qty).collect()
        assert got == control
    assert hits == [False, True]


def test_q1_two_bindings_match_reference(lineitem):
    s = TpuSession(VFA, device="cpu")
    js = JSession(REF)
    hits = []
    for cutoff in Q1_BINDINGS:
        df = _q1(L, _li(s, lineitem), cutoff)
        got = df.collect()
        hits.append(df._physical().cache_hit)
        want = _q1(JL, _jli(js, lineitem), cutoff).collect()
        assert_rows_equal(got, want, approx_float=True, msg=cutoff)
        control = _q1(L, _li(TpuSession(dict(VFA, **OFF), device="cpu"),
                             lineitem), cutoff).collect()
        assert got == control
    assert hits == [False, True]


# ---------------------------------------------------------------------------
# A bind slot promotes as the inline literal does
# ---------------------------------------------------------------------------

PROMOTION = {
    # name -> (column dtype, column values, literal, op, arithmetic too)
    "int32_slot_vs_int64": (dt.INT64, [2 ** 40, -3, 7, None, 0], 7, "ge",
                            True),
    "int32_slot_vs_date": (dt.DATE, [9000, 9131, 9500, None, -1], 9131,
                           "lt", False),
    "float_slot_vs_double": (dt.FLOAT64, [0.5, -0.0, float("nan"), None,
                                          1e300], 0.25, "gt", True),
    # The comparison only: the port's device add / multiply keep a
    # subnormal result where XLA:CPU flushes it (ROADMAP queue C), with a
    # literal as with a slot.
    "subnormal_double": (dt.FLOAT64, [1e-310, -1e-310, 0.0, -0.0, 5e-324,
                                      1.0, None], 1e-310, "eq", False),
}


@pytest.mark.parametrize("name", sorted(PROMOTION))
@pytest.mark.parametrize("engine", ["device", "host"])
def test_bind_slot_promotes_as_the_literal(name, engine):
    t, vals, literal, op, arith = PROMOTION[name]
    conf = dict(VFA) if engine == "device" else \
        dict(VFA, **{"spark.rapids.sql.enabled": False})

    def frame(session, M, dtmod):
        df = session.create_dataframe(
            {"x": vals}, [("x", dtmod.type_named(t.name))])
        c, lit = M.col("x"), M.lit_col(literal)
        cond = {"ge": c >= lit, "lt": c < lit, "gt": c > lit,
                "eq": c == lit}[op]
        out = df.filter(cond)
        if arith:
            out = out.select("x", (M.col("x") + lit).alias("y"),
                             (lit * M.col("x")).alias("z"))
        return out

    cached = frame(TpuSession(conf, device="cpu"), L, dt)
    got = cached.collect()
    assert cached._physical().bind_values == (literal,) * (3 if arith
                                                           else 1)
    want = frame(TpuSession(dict(conf, **OFF), device="cpu"), L, dt)
    assert [tuple(map(repr, r)) for r in got] == \
        [tuple(map(repr, r)) for r in want.collect()]
    ref = frame(JSession(dict(REF, **conf)), JL, jdt).collect()
    assert_rows_equal(got, ref, msg=name)


def test_subnormal_arithmetic_matches_reference():
    """The port's device add flushes a subnormal result as the JAX
    package's XLA:CPU does (1e-310 + 1e-310 = 0.0 there, denormals are
    zero and results flush to zero); a bind slot and an inline literal
    give the same rows as the reference."""
    def frame(session, M, dtmod):
        df = session.create_dataframe({"x": [1e-310, 1.0]},
                                      [("x", dtmod.FLOAT64)])
        return df.select((M.col("x") + M.lit_col(1e-310)).alias("y"))
    slot = frame(TpuSession(VFA, device="cpu"), L, dt)
    inline = frame(TpuSession(dict(VFA, **OFF), device="cpu"), L, dt)
    ref = frame(JSession(REF), JL, jdt).collect()
    assert ref == [(0.0,), (1.0,)]
    assert slot.collect() == inline.collect() == ref
    assert slot._physical().bind_values == (1e-310,)


_TINY64 = float(np.finfo(np.float64).tiny)
_TINY32 = float(np.finfo(np.float32).tiny)
# Subnormal, least-normal, normal, signed-zero, NaN and infinite operands
# (float32 ones exactly representable in float32).
_GRID = {
    "FLOAT64": [1e-310, -1e-310, 5e-324, _TINY64, -_TINY64, 1.5 * _TINY64,
                1.0, -2.5, 0.0, -0.0, float("nan"), float("inf"),
                float("-inf"), 1e308],
    "FLOAT32": [float(np.float32(1e-40)), float(np.float32(-1e-40)),
                _TINY32, -_TINY32, 1.5 * _TINY32, 1.0, -2.5, 0.0, -0.0,
                float("nan"), float("inf"), float("-inf"), 3e38],
}
_GRID_OPS = {
    "add": lambda M, a, b: a + b,
    "sub": lambda M, a, b: a - b,
    "mul": lambda M, a, b: a * b,
    "div": lambda M, a, b: a / b,
    "rem": lambda M, a, b: a % b,
    "pmod": lambda M, a, b: M.pmod(a, b),
    "neg": lambda M, a, b: -a,
}


@pytest.mark.parametrize("op", sorted(_GRID_OPS))
@pytest.mark.parametrize("tname", sorted(_GRID))
def test_subnormal_arithmetic_grid(tname, op):
    """Every pair of the grid through each arithmetic operator of the
    port's device half gives the JAX package's device rows, bit for bit
    (compared by ``repr``, so -0.0 and NaN count): denormals are zero and
    subnormal results flush for + - * / and pmod's inner addition; fmod
    and unary minus flush nothing."""
    vals = _GRID[tname]
    a = [x for x in vals for _ in vals]
    b = [y for _ in vals for y in vals]

    def frame(session, M, dtmod):
        t = getattr(dtmod, tname)
        df = session.create_dataframe(
            {"i": list(range(len(a))), "a": a, "b": b},
            [("i", dtmod.INT64), ("a", t), ("b", t)])
        return df.select(M.col("i"), _GRID_OPS[op](
            M, M.col("a"), M.col("b")).alias("r"))
    got = sorted(frame(TpuSession(VFA, device="cpu"), L, dt).collect())
    want = sorted(frame(JSession(REF), JL, jdt).collect())
    assert [repr(r) for r in got] == [repr(r) for r in want]


def test_pushdown_by_date_binding(tmp_path):
    """A date column's row groups skip by day number under each binding
    (ROADMAP queue C: the reference keeps every unit there)."""
    import datetime
    import pyarrow as pa
    import pyarrow.parquet as papq
    from spark_rapids_tpu.io import scan as JS
    from spark_rapids_tpu_torch.io import scan as S
    days = np.arange(400, dtype=np.int32) * 3 + 8000
    path = str(tmp_path / "d.parquet")
    papq.write_table(pa.table({
        "d": pa.array([datetime.date(1970, 1, 1) + datetime.timedelta(
            days=int(x)) for x in days], pa.date32()),
        "v": pa.array(np.arange(400, dtype=np.int64))}), path,
        row_group_size=100)
    s = TpuSession(VFA, device="cpu")
    base = s.read.parquet(path)
    counts = []
    for lo, hi in ((8000, 8150), (8600, 9300), (20000, 20001)):
        df = base.filter((L.col("d") >= L.lit_col(lo))
                         & (L.col("d") < L.lit_col(hi))).agg(
            L.agg_count().alias("n"))
        ctx = ExecContext(s.conf)
        rows = df._physical().collect(ctx)
        assert rows == [(int(((days >= lo) & (days < hi)).sum()),)]
        groups = days.reshape(4, 100)
        want = int(((groups.max(1) < lo) | (groups.min(1) >= hi)).sum())
        got = sum(m.values.get("numSkippedRowGroups", 0)
                  for m in ctx.metrics.values())
        assert got == want
        counts.append(got)
    assert counts == [3, 2, 4]
    unit = S.enumerate_units("parquet", [path])[3]
    assert not S._unit_survives("parquet", unit, [("d", "lt", 8300)])
    junit = JS.enumerate_units("parquet", [path])[3]
    assert JS._unit_survives("parquet", junit, [("d", "lt", 8300)])
