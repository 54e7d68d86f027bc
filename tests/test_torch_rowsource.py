"""Port parity of the row-source surface: the nondeterministic
expressions (``exprs/nondeterministic.py``), ``RangeExec`` and
``UnionExec`` (``ops/basic.py``), First / Last (``ops/aggregate.py``),
and the DataFrame front end over them (``TpuSession.range``,
``DataFrame.union``, the new DSL functions), against the JAX package on
the CPU.

- ``Rand``'s stream equals the reference's bit for bit on both halves
  (the device half computes the uint64 SplitMix64 in int64), over large
  row indexes, several seeds and partitions; SparkPartitionID,
  MonotonicallyIncreasingID, Rand and InputFileName under an
  ``EvalContext`` (a partition, a row base, a filtered batch with a dead
  tail) equal the reference's ``eval`` and ``eval_host``.
- ``RangeExec``'s batches (capacity, live rows, data) equal the
  reference's on both engines: negative steps, an empty range, steps that
  do not divide the span, more partitions than rows.
- The queries of ``benchmarks/rowsource.py`` (``range``, the LINEITEM
  projection, its grouping with first / last, the two unions), at about
  20,000 rows, and a union of a device child and a host child, through
  ``TpuSession`` of both packages under ``variableFloatAgg`` +
  ``improvedFloatOps`` and under the default conf, at 1 and 4 partitions:
  the same placement and exec tree, the same rows on the device and on
  the host engine (integers, dates and booleans exact; floats within
  rtol 1e-14, the transcendentals' tolerance).
- First / Last over partitions of several batches, through partial ->
  final at 4 partitions, equal the reference's on both engines; the
  DISTINCT form raises the reference's error.
- A task-context expression outside a projection or a filter raises the
  reference's analysis error; every new DSL function resolves to the
  reference's expression tree; chip_smoke.py's numpy oracles of phase 19
  agree with the port's rows.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu import ops as JO
from spark_rapids_tpu.api import DataFrame as JDataFrame
from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.exprs import nondeterministic as JN
from spark_rapids_tpu.ops.base import ExecContext as JCtx
from spark_rapids_tpu.plan import logical as JL

from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch import ops as TO
from spark_rapids_tpu_torch.api import DataFrame, TpuSession
from spark_rapids_tpu_torch.benchmarks import rowsource as R
from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.exprs import nondeterministic as TN
from spark_rapids_tpu_torch.ops.base import ExecContext as TCtx
from spark_rapids_tpu_torch.plan import logical as L

from test_torch_logical import jax_parts, jschema
from test_torch_placement import REF_OFF, _shape

pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# Rand's stream and the task-context expressions
# ---------------------------------------------------------------------------

SEEDS = [0, 7, -3, 2 ** 40 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_rand_stream_bit_for_bit(seed):
    idx = np.concatenate([np.arange(4096, dtype=np.int64),
                          np.array([2 ** 33 - 1, 2 ** 40, 2 ** 62],
                                   np.int64)])
    for pid in (0, 3, 1023):
        want = np.asarray(JN._uniform(jnp, seed, jnp.asarray(pid, jnp.int64),
                                      jnp.asarray(idx)))
        host_want = JN._uniform(np, seed, np.int64(pid), idx)
        got = TN._uniform_device(seed, pid, torch.from_numpy(idx)).numpy()
        host = TN._uniform_host(seed, pid, idx)
        assert got.tobytes() == want.tobytes()
        assert host.tobytes() == host_want.tobytes() == want.tobytes()
        assert ((got >= 0) & (got < 1)).all()


CAP, LIVE = 96, 83


def _ctx_batches():
    """A device batch (a filtered row every third row, a dead tail) and a
    host batch of one int32 column, in both packages."""
    v = np.arange(CAP, dtype=np.int32)
    sel = (np.arange(CAP) % 3) != 1
    jb = jbatch.DeviceBatch(
        (jbatch.DeviceColumn(jdt.INT32, jnp.asarray(v),
                             jnp.asarray(np.ones(CAP, bool))),),
        jnp.asarray(LIVE, jnp.int32), sel=jnp.asarray(sel))
    tb = tbatch.DeviceBatch(
        (tbatch.DeviceColumn(tdt.INT32, torch.from_numpy(v.copy()),
                             torch.ones(CAP, dtype=torch.bool)),),
        torch.tensor(LIVE, dtype=torch.int32), sel=torch.from_numpy(sel))
    from spark_rapids_tpu.columnar import host as jhost
    from spark_rapids_tpu_torch.columnar import host as thost
    jh = jhost.HostBatch(("v",), [jhost.HostColumn(
        jdt.INT32, v[:LIVE].copy(), np.ones(LIVE, bool))])
    th = thost.HostBatch(("v",), [thost.HostColumn(
        tdt.INT32, v[:LIVE].copy(), np.ones(LIVE, bool))])
    return jb, tb, jh, th


CONTEXTUAL = {
    "spark_partition_id": lambda M: M.SparkPartitionID(),
    "monotonically_increasing_id": lambda M: M.MonotonicallyIncreasingID(),
    "rand": lambda M: M.Rand(11),
    "rand_negative_seed": lambda M: M.Rand(-5),
    "input_file_name": lambda M: M.InputFileName(),
}


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("case", sorted(CONTEXTUAL))
def test_contextual_matches_reference(case, engine):
    jb, tb, jh, th = _ctx_batches()
    je, te = CONTEXTUAL[case](JE), CONTEXTUAL[case](TE)
    for pid, base in ((0, 0), (3, 1000), (517, 2 ** 33 - 7)):
        if engine == "device":
            with JN.eval_context(JN.EvalContext(
                    jnp.asarray(pid, jnp.int32),
                    jnp.asarray(base, jnp.int64))):
                want = je.eval(jb)
            with TN.eval_context(TN.EvalContext(
                    pid, torch.tensor(base, dtype=torch.int64))):
                got = te.eval(tb)
        else:
            with JN.eval_context(JN.EvalContext(pid, base)):
                want = je.eval_host(jh)
            with TN.eval_context(TN.EvalContext(pid, base)):
                got = te.eval_host(th)
        if case == "input_file_name":
            assert got.value == want.value == ""
            continue
        gd = got.data.numpy() if engine == "device" else got.data
        assert np.asarray(gd).tobytes() == np.asarray(want.data).tobytes()
        gv = got.validity.numpy() if engine == "device" else got.validity
        np.testing.assert_array_equal(gv, np.asarray(want.validity))


# ---------------------------------------------------------------------------
# RangeExec
# ---------------------------------------------------------------------------

RANGES = {
    "plain": (0, 1000, 1, 1, 256),
    "parts": (0, 1000, 1, 3, 128),
    "step": (5, 1003, 7, 2, 64),
    "negative": (100, -57, -3, 3, 16),
    "negative_step_one": (10, 0, -1, 1, 4),
    "empty": (5, 5, 1, 2, 8),
    "wrong_direction": (0, 10, -1, 2, 8),
    "more_parts_than_rows": (0, 3, 1, 5, 8),
    "big_start": (2 ** 40, 2 ** 40 + 50, 3, 2, 12),
}


@pytest.mark.parametrize("case", sorted(RANGES))
def test_range_exec_matches_reference(case):
    start, end, step, parts, rows = RANGES[case]
    j = JO.RangeExec(start, end, step, parts, batch_rows=rows)
    t = TO.RangeExec(start, end, step, parts, batch_rows=rows,
                     device="cpu")
    jctx, tctx = JCtx(), TCtx()
    assert t.num_partitions(tctx) == j.num_partitions(jctx) == parts
    for p in range(parts):
        jd = list(j.execute_device(jctx, p))
        td = list(t.execute_device(tctx, p))
        assert len(td) == len(jd)
        for a, b in zip(td, jd):
            assert a.capacity == b.capacity and \
                int(a.num_rows) == int(b.num_rows) == a.rows_hint
            c, d = a.columns[0], b.columns[0]
            assert c.data.numpy().tobytes() == np.asarray(d.data).tobytes()
            np.testing.assert_array_equal(c.validity.numpy(),
                                          np.asarray(d.validity))
        jh = list(j.execute_host(jctx, p))
        th = list(t.execute_host(tctx, p))
        assert [h.to_pylist() for h in th] == [h.to_pylist() for h in jh]


# ---------------------------------------------------------------------------
# The DataFrame front end
# ---------------------------------------------------------------------------

ALL_DEVICE = {"spark.rapids.sql.variableFloatAgg.enabled": True,
              "spark.rapids.sql.improvedFloatOps.enabled": True}
CONFS = {"device": ALL_DEVICE, "default": {}}
SCALE = 0.0035          # 21,323 LINEITEM rows
BATCH = {"spark.rapids.sql.batchSizeRows": 8192}
RANGE_N = 20_000


@pytest.fixture(scope="module")
def lineitem_cols():
    return E.tpch_columns(SCALE, seed=1)


def _lineitem(P, session, cols, parts, batches=1):
    """LINEITEM in ``parts`` partitions of ``batches`` host batches."""
    pieces = E.table_partitions(cols["lineitem"], R.LINEITEM,
                                parts * batches)
    grouped = [[b for piece in pieces[i * batches:(i + 1) * batches]
                for b in piece] for i in range(parts)]
    if P == "port":
        return DataFrame(session, L.InMemoryScan(R.LINEITEM, grouped))
    return JDataFrame(session, JL.InMemoryScan(jschema(R.LINEITEM),
                                               jax_parts(grouped)))


def _union_mixed(M, li):
    """A union of a device child and a child the default conf puts on the
    host (``log`` is a transcendental): the bridge under the union."""
    c = M.col
    a = li.select(c("l_orderkey"), c("l_tax").alias("x"))
    b = li.select(c("l_orderkey"), M.log_col(c("l_tax") + 1.0).alias("x"))
    return a.union(b).filter(c("x") > 0.02)


QUERIES = {
    "range": lambda M, s, li, n: R.range_query(M, s, RANGE_N, n),
    "projection": lambda M, s, li, n: R.lineitem_projection(M, li),
    "projection_head": lambda M, s, li, n: R.projection_head(M, li, 5000),
    "groups": lambda M, s, li, n: R.lineitem_groups(M, li),
    "union_dates": lambda M, s, li, n: R.union_dates(M, li),
    "range_union": lambda M, s, li, n: R.range_union(M, s, RANGE_N // 2, n),
    "union_mixed": lambda M, s, li, n: _union_mixed(M, li),
    "range_negative_step": lambda M, s, li, n: s.range(
        RANGE_N, -7, -13, num_partitions=n).select(
        M.col("id"), M.monotonically_increasing_id().alias("m"),
        M.rand(3).alias("r")).filter(M.col("r") < 0.5),
    "range_empty": lambda M, s, li, n: s.range(
        9, 9, num_partitions=n).agg(M.agg_count().alias("n"),
                                    M.agg_sum(M.col("id")).alias("s")),
}


@pytest.fixture(scope="module")
def frames(lineitem_cols):
    """(query, conf, partitions) -> (port DataFrame, reference DataFrame),
    built on first use."""
    out = {}

    def get(q, conf, n):
        key = (q, conf, n)
        if key not in out:
            pconf = dict(CONFS[conf], **BATCH)
            t = TpuSession(pconf, device="cpu")
            j = JSession(dict(pconf, **REF_OFF, **{
                "spark.rapids.sql.shuffle.partitions": 1}))
            out[key] = (
                QUERIES[q](L, t, _lineitem("port", t, lineitem_cols, n), n),
                QUERIES[q](JL, j, _lineitem("jax", j, lineitem_cols, n), n))
        return out[key]
    return get


def assert_rows_close(got, want, rtol=1e-14):
    """Same rows in the same order: floats within ``rtol`` (NaN where
    NaN), everything else exact."""
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert isinstance(a, float), (g, w)
                assert (np.isnan(a) and np.isnan(b)) or np.isclose(
                    a, b, rtol=rtol, atol=0), (g, w)
            else:
                assert a == b and type(a) is type(b), (g, w)


def _ordered(q, rows):
    # Projections and unions have no ORDER BY: compare them as multisets.
    return rows if q in ("range", "groups", "union_dates", "range_union",
                         "range_empty", "projection_head") \
        else sorted(rows, key=repr)


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("conf", sorted(CONFS))
@pytest.mark.parametrize("q", sorted(QUERIES))
def test_query_matches_reference(q, conf, n, frames):
    tdf, jdf = frames(q, conf, n)
    tphys, jphys = tdf._physical(), jdf._physical()
    assert tphys.host_fallback_nodes() == jphys.host_fallback_nodes()
    assert _shape(tphys.root) == _shape(jphys.root)
    if conf == "device":
        assert tphys.host_fallback_nodes() == []
    want = jdf.collect()
    assert want, f"{q}: nothing compared"
    assert_rows_close(_ordered(q, tdf.collect()), _ordered(q, want))
    assert_rows_close(_ordered(q, tdf.collect_host()),
                      _ordered(q, jdf.collect_host()))


def test_queries_are_not_vacuous(frames):
    """The range query's ids are dense per partition and its rand values
    in [0, 1); the projection holds NaN rows (isnan / nanvl) and NULLs
    (at_least_n_non_nulls over a NULL log); the negative-step range
    filters some rows out; the mixed union bridges its host child."""
    tdf, _j = frames("range", "device", 4)
    rows = tdf.collect()
    assert len(rows) == R.RANGE_GROUPS and sum(r[1] for r in rows) == RANGE_N
    assert all(0.0 <= r[3] <= r[4] < 1.0 for r in rows)
    assert {r[-1] for r in rows} <= {0, 1, 2, 3}
    tdf, _j = frames("projection", "default", 1)
    names = [n for n, _ in R.PROJECTION]
    rows = tdf.collect()
    isnan = [r[names.index("isnan")] for r in rows]
    assert any(isnan) and not all(isnan)
    assert any(not r[names.index("nn2")] for r in rows)
    tdf, _j = frames("union_mixed", "default", 1)
    assert "HostToDeviceExec" in tdf._physical().tree() or \
        "DeviceToHostExec" in tdf._physical().tree()
    assert tdf._physical().host_fallback_nodes() == ["LogicalProject"]
    tdf, _j = frames("range_empty", "device", 4)
    assert tdf.collect() == [(0, None)]


# ---------------------------------------------------------------------------
# First / Last across batches and partitions
# ---------------------------------------------------------------------------

def _first_last(M, li):
    c = M.col
    return li.group_by(M.dayofweek(c("l_shipdate")).alias("dow")).agg(
        M.agg_first(c("l_orderkey")).alias("f"),
        M.agg_last(c("l_orderkey")).alias("l"),
        M.agg_first(c("nk"), False).alias("fn"),
        M.agg_last(c("nk"), False).alias("ln"),
        M.agg_first(c("nk")).alias("fi"),
        M.agg_last(c("nk")).alias("li"),
        M.agg_count().alias("n")).order_by("dow")


def _first_last_zero_key(M, li):
    c = M.col
    return li.agg(M.agg_first(c("l_orderkey")).alias("f"),
                  M.agg_last(c("l_orderkey")).alias("l"),
                  M.agg_first(c("nk"), False).alias("fn"),
                  M.agg_last(c("nk")).alias("li"))


FIRST_LAST = {"keyed": _first_last, "zero_key": _first_last_zero_key}


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("case", sorted(FIRST_LAST))
def test_first_last_match_reference(case, n, lineitem_cols):
    """Partitions of three host batches each (an arrival index that
    crosses batches), a nullable column (``nk``: NULL on odd discounts),
    through partial -> exchange -> final."""
    conf = dict(ALL_DEVICE, **{"spark.rapids.sql.batchSizeRows": 1024})
    t = TpuSession(conf, device="cpu")
    j = JSession(dict(conf, **REF_OFF,
                      **{"spark.rapids.sql.shuffle.partitions": 1}))

    def frame(M, s, P):
        c = M.col
        li = _lineitem(P, s, lineitem_cols, n, batches=3)
        nk = M.when((c("l_discount") * 100.0) % 2.0 == 0.0,
                    c("l_orderkey"))
        return FIRST_LAST[case](M, li.with_column("nk", nk))
    tdf, jdf = frame(L, t, "port"), frame(JL, j, "jax")
    assert _shape(tdf._physical().root) == _shape(jdf._physical().root)
    want = jdf.collect()
    assert want and tdf.collect() == want
    assert tdf.collect_host() == jdf.collect_host()


def test_first_distinct_raises():
    t = TpuSession(device="cpu").range(10)
    with pytest.raises(L.ResolutionError, match="not meaningful"):
        t.group_by(L.pmod(L.col("id"), 2)).agg(
            L.Column(("aggd", "first", L.col("id")))).collect()


# ---------------------------------------------------------------------------
# Analysis errors and the DSL
# ---------------------------------------------------------------------------

CONTEXT_ERRORS = {
    "group_by": lambda M, df: df.group_by(
        M.monotonically_increasing_id()).agg(M.agg_count().alias("n")),
    "aggregate": lambda M, df: df.group_by("v").agg(
        M.agg_sum(M.rand(1)).alias("s")),
    "order_by": lambda M, df: df.order_by(M.rand(42)),
    "join_key": lambda M, df: df.join_on(
        df.select(M.col("v").alias("w")), [M.spark_partition_id()],
        ["w"]),
    "repartition": lambda M, df: df.repartition(
        4, M.monotonically_increasing_id()),
    "window_key": lambda M, df: df.select(
        M.col("v"), M.agg_sum(M.col("v")).over(
            M.Window.partition_by(M.rand(3))).alias("w")),
}


@pytest.mark.parametrize("case", sorted(CONTEXT_ERRORS))
def test_forbid_contextual_matches_reference(case):
    data = {"v": list(range(20))}
    jdf = CONTEXT_ERRORS[case](JL, JSession(dict(REF_OFF)).create_dataframe(
        data, [("v", jdt.INT32)], num_partitions=2))
    tdf = CONTEXT_ERRORS[case](L, TpuSession(device="cpu").create_dataframe(
        data, [("v", tdt.INT32)], num_partitions=2))
    with pytest.raises(JL.ResolutionError, match="task-context") as je:
        jdf.collect()
    with pytest.raises(L.ResolutionError, match="task-context") as te:
        tdf.collect()
    assert str(te.value) == str(je.value)


RSCHEMA = (("x", "float64"), ("y", "float64"), ("i", "int32"),
           ("l", "int64"), ("d", "date"), ("t", "timestamp"))


def _dsl():
    u = ["sqrt_col", "abs_col", "floor_col", "ceil_col", "exp_col",
         "log_col", "log10_col", "log2_col", "signum_col", "isnan_col",
         "sin_col", "cos_col", "tan_col", "asin_col", "acos_col", "atan_col",
         "sinh_col", "cosh_col", "tanh_col", "asinh_col", "acosh_col",
         "atanh_col", "cbrt_col", "expm1_col", "log1p_col", "degrees_col",
         "radians_col", "rint_col"]
    cases = {f: (lambda M, f=f: getattr(M, f)(M.col("x"))) for f in u}
    for f in ("quarter", "dayofweek", "weekday", "dayofyear", "last_day",
              "to_unix_timestamp"):
        cases[f] = lambda M, f=f: getattr(M, f)(M.col("d"))
    for f in ("hour", "minute", "second"):
        cases[f] = lambda M, f=f: getattr(M, f)(M.col("t"))
    cases.update({
        "neg": lambda M: -M.col("l"),
        "from_unixtime": lambda M: M.from_unixtime(M.col("l")),
        "round_col": lambda M: M.round_col(M.col("x"), 2),
        "bround_col": lambda M: M.bround_col(M.col("i"), -1),
        "pow_col": lambda M: M.pow_col(M.col("x"), 2),
        "logb": lambda M: M.logb(10.0, M.col("x")),
        "nanvl": lambda M: M.nanvl(M.col("x"), M.col("y")),
        "least": lambda M: M.least(M.col("x"), M.col("y"), 1.5),
        "greatest": lambda M: M.greatest(M.col("i"), M.col("l")),
        "at_least_n_non_nulls": lambda M: M.at_least_n_non_nulls(
            2, M.col("x"), M.col("i"), M.col("d")),
        "date_add": lambda M: M.date_add(M.col("d"), 30),
        "date_sub": lambda M: M.date_sub(M.col("d"), M.col("i")),
        "datediff": lambda M: M.datediff(M.col("d"), M.col("d")),
        "add_months": lambda M: M.add_months(M.col("d"), -13),
        "trunc": lambda M: M.trunc(M.col("d"), "quarter"),
        "rand": lambda M: M.rand(17),
        "spark_partition_id": lambda M: M.spark_partition_id(),
        "monotonically_increasing_id": lambda M:
        M.monotonically_increasing_id(),
        "input_file_name": lambda M: M.input_file_name(),
    })
    return cases


DSL = _dsl()


def _same_expr(j, p, path="root"):
    assert type(p).__name__ == type(j).__name__, path
    assert p.data_type().name == j.data_type().name, path
    for attr in ("value", "ordinal", "scale", "fmt", "seed", "n"):
        if hasattr(j, attr):
            assert getattr(p, attr) == getattr(j, attr), (path, attr)
    jc, pc = tuple(j.children), tuple(p.children)
    assert len(pc) == len(jc), path
    for i, (a, b) in enumerate(zip(jc, pc)):
        _same_expr(a, b, f"{path}.{i}")


@pytest.mark.parametrize("name", sorted(DSL))
def test_dsl_resolves_as_reference(name):
    want = JL.resolve(DSL[name](JL), tuple(
        (n, jdt.type_named(t)) for n, t in RSCHEMA))
    got = L.resolve(DSL[name](L), tuple(
        (n, tdt.type_named(t)) for n, t in RSCHEMA))
    _same_expr(want, got)
    assert DSL[name](L).node[0] in L.PORTED_KINDS


@pytest.mark.parametrize("which", ["agg_first", "agg_last"])
def test_first_last_resolve(which):
    from spark_rapids_tpu.plan.planner import resolve_agg as jresolve
    from spark_rapids_tpu_torch.plan.planner import resolve_agg
    schema = (("l", tdt.INT64),)
    for ignore in (True, False):
        want = jresolve(getattr(JL, which)(JL.col("l"), ignore),
                        (("l", jdt.INT64),))
        got = resolve_agg(getattr(L, which)(L.col("l"), ignore), schema)
        assert type(got).__name__ == type(want).__name__
        assert got.ignore_nulls == want.ignore_nulls == ignore
        assert got.buffer_types == (tdt.INT64, tdt.INT64)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase-19 oracles
# ---------------------------------------------------------------------------

def test_chip_smoke_oracles_agree(lineitem_cols):
    """The numpy oracles chip_smoke.py holds phase 19 to give the port's
    rows at this scale (all-device conf, one partition)."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as C
    finally:
        sys.path.remove(ROOT)
    s = TpuSession(dict(ALL_DEVICE, **BATCH), device="cpu")
    li_cols = lineitem_cols["lineitem"]
    C.check_range_rows(R.range_query(L, s, RANGE_N, 4).collect(), RANGE_N,
                       4)
    li = R.lineitem(s, lineitem_cols)
    worst = C.check_projection(R.projection_head(
        L, li, C.HEAD_ROWS)._physical().collect_batches(), li_cols,
        C.HEAD_ROWS)
    assert set(worst) == {"log_price", "sqrt_price", "exp_tax", "disc_sq"}
    C.check_group_rows(R.lineitem_groups(L, li).collect(), li_cols)
    C.check_union_rows(R.union_dates(L, li).collect(), li_cols)
    C.check_range_union_rows(R.range_union(L, s, RANGE_N // 2, 4).collect(),
                             RANGE_N // 2, 4)
