"""Port parity of the host engine: every ported expression's ``eval_host``
and every ported exec's ``execute_host`` against the JAX package's, on
the same host batches, bit for bit.

- Inputs are numpy columns from a seed, with nulls, NaN, +-0.0, +-inf,
  subnormals (1e-310 in f64, 1e-40 in f32), int64 extremes whose sums
  overflow, and strings in both host layouts (``object`` arrays of bytes,
  as ``from_values`` builds them, and the byte matrix a download gives).
- Expressions: Add, Subtract, Multiply, the comparisons (NaN greatest,
  no subnormal flush on the host), And / Or / Not (three-valued),
  IsNull / IsNotNull, Contains / StartsWith / EndsWith (empty and NULL
  needles).
- Execs: Project, Filter, Coalesce and the limits; HashAggregate in
  partial, final and complete modes over Count, CountStar, Sum, Min, Max
  and Avg by int, double, string, two and no keys (the vectorized path,
  and the python-row path a string Min/Max or an empty input takes);
  Sort; BroadcastHashJoin of each of the five join types by int, double,
  string and two keys, with and without a condition, and over an empty
  build side.
- Both engines of both packages on a subnormal filter and group key: the
  host halves keep 1e-310 apart from 0.0, the device halves flush it.
- The bridges on the CPU: ``DeviceToHostExec`` and ``HostToDeviceExec``
  give back the rows they were given.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import types

import numpy as np
import pytest

from spark_rapids_tpu import config as JC
from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu import ops as JO
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.ops.join import BroadcastHashJoinExec as JJoin

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch import ops as TO
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost

# NaN and inf arithmetic is part of the inputs on purpose.
pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")

JAX = types.SimpleNamespace(E=JE, O=JO, D=jdt, H=jhost, Join=JJoin,
                            ctx=lambda: JO.ExecContext(JC.TpuConf()),
                            src=lambda s, p: JO.InMemorySourceExec(s, p))
PORT = types.SimpleNamespace(E=TE, O=TO, D=tdt, H=thost,
                             Join=TO.BroadcastHashJoinExec,
                             ctx=lambda: TO.ExecContext(C.TpuConf()),
                             src=lambda s, p: TO.InMemorySourceExec(
                                 s, p, device="cpu"))

F64_POOL = np.array([0.0, -0.0, 1e-310, -1e-310, np.nan, np.inf, -np.inf,
                     1.5, -2.25, 3.0, 1e300])
F32_POOL = np.array([0.0, -0.0, 1e-40, -1e-40, np.nan, 1.5, -2.5],
                    np.float32)
I64_POOL = np.array([2 ** 63 - 1, -2 ** 63, 2 ** 62, 7, -3, 0], np.int64)
STR_POOL = [b"", b"A", b"AB", b"ABA", b"BA", b"B\x00", b"\xc3\xa9t\xc3\xa9",
            b"ABABAB"]

# (name, type) of the generated columns.
SCHEMA = (("i32", "int32"), ("i64", "int64"), ("f64", "float64"),
          ("f32", "float32"), ("d", "date"), ("b", "bool"), ("s", "string"),
          ("f64b", "float64"), ("i64b", "int64"), ("s2", "string"))


def _columns(seed: int, n: int) -> list:
    """(type name, data, validity) per SCHEMA column; string data is a
    list of bytes."""
    rng = np.random.default_rng(seed)
    out = []
    for _name, t in SCHEMA:
        if t == "int32":
            data = rng.integers(-4, 5, n).astype(np.int32)
        elif t == "int64":
            data = rng.choice(I64_POOL, n)
        elif t == "float64":
            data = rng.choice(F64_POOL, n)
        elif t == "float32":
            data = rng.choice(F32_POOL, n)
        elif t == "date":
            data = rng.integers(10_440, 10_460, n).astype(np.int32)
        elif t == "bool":
            data = rng.random(n) < 0.5
        else:
            data = [STR_POOL[i] for i in rng.integers(0, len(STR_POOL), n)]
        valid = rng.random(n) < 0.8
        out.append((t, data, valid))
    return out


def _host_batch(P, cols, layout: str, names=None):
    """One host batch of ``cols`` in package ``P``; strings as an object
    array or as the byte matrix of a download."""
    names = names or tuple(n for n, _ in SCHEMA)
    hcols = []
    for t, data, valid in cols:
        dtype = P.D.type_named(t)
        valid = np.asarray(valid, np.bool_).copy()
        if dtype.is_string:
            vals = [b if v else b"" for b, v in zip(data, valid)]
            if layout == "matrix":
                w = max([len(b) for b in vals] + [1])
                m = np.zeros((len(vals), w), np.uint8)
                for i, b in enumerate(vals):
                    m[i, :len(b)] = np.frombuffer(b, np.uint8)
                lens = np.array([len(b) for b in vals], np.int32)
                hcols.append(P.H.HostColumn(dtype, None, valid,
                                            str_matrix=m, str_lengths=lens))
            else:
                obj = np.empty(len(vals), dtype=object)
                obj[:] = vals
                hcols.append(P.H.HostColumn(dtype, obj, valid))
        else:
            d = np.where(valid, data, np.zeros(1, data.dtype)) \
                .astype(dtype.np_dtype)
            hcols.append(P.H.HostColumn(dtype, d, valid))
    return P.H.HostBatch(tuple(names), hcols)


def _schema(P, names_types):
    return tuple((n, P.D.type_named(t)) for n, t in names_types)


def _same_col(pc, jc, what=""):
    assert pc.dtype.name == jc.dtype.name, what
    np.testing.assert_array_equal(np.asarray(pc.validity, np.bool_),
                                  np.asarray(jc.validity, np.bool_), what)
    if pc.dtype.is_string:
        assert pc.to_list() == jc.to_list(), what
        return
    pd, jd = np.asarray(pc.data), np.asarray(jc.data)
    assert pd.dtype == jd.dtype, what
    # Bit for bit: NaN payloads and the sign of zero included.
    assert pd.tobytes() == jd.tobytes(), (what, pd, jd)


def _same_batches(pbs, jbs, what=""):
    assert len(pbs) == len(jbs), what
    for i, (p, j) in enumerate(zip(pbs, jbs)):
        assert tuple(p.names) == tuple(j.names), what
        assert len(p.columns) == len(j.columns), what
        for ci, (pc, jc) in enumerate(zip(p.columns, j.columns)):
            _same_col(pc, jc, f"{what} batch {i} col {ci}")


def _run_host(P, exec_):
    ctx = P.ctx()
    return [list(exec_.execute_host(ctx, p))
            for p in range(exec_.num_partitions(ctx))]


def _run_both(build):
    """``build(P)`` -> exec in package P; both run on their host engine
    and give bit-identical batches per partition."""
    got = _run_host(PORT, build(PORT))
    want = _run_host(JAX, build(JAX))
    assert len(got) == len(want)
    for p, (g, w) in enumerate(zip(got, want)):
        _same_batches(g, w, f"partition {p}")
    return got


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

def _exprs(P):
    M, D = P.E, P.D
    R = M.BoundReference
    i32, i64, f64, f32 = (R(0, D.INT32), R(1, D.INT64), R(2, D.FLOAT64),
                          R(3, D.FLOAT32))
    date, b, s = R(4, D.DATE), R(5, D.BOOL), R(6, D.STRING)
    f64b, i64b, s2 = R(7, D.FLOAT64), R(8, D.INT64), R(9, D.STRING)
    null_s = M.Literal(D.STRING, None)
    return {
        "add_i64_wrap": M.Add(i64, i64b),
        "sub_i64_wrap": M.Subtract(i64, i64b),
        "mul_i64_wrap": M.Multiply(i64, M.lit(3)),
        "sub_i32_lit": M.Subtract(i32, M.lit(7)),
        "mul_i32_i64": M.Multiply(i32, i64),
        "add_f64": M.Add(f64, f64b),
        "mul_f64_tiny": M.Multiply(f64, M.lit(1e-10)),
        "sub_lit_f64": M.Subtract(M.lit(1.0), f64),
        "add_i32_f64": M.Add(i32, f64),
        "mul_f32_f64": M.Multiply(f32, f64),
        "eq_f64": M.EqualTo(f64, f64b),
        "lt_f64": M.LessThan(f64, f64b),
        "le_f64": M.LessThanOrEqual(f64, f64b),
        "gt_f64_zero": M.GreaterThan(f64, M.lit(0.0)),
        "ge_f64_zero": M.GreaterThanOrEqual(f64, M.lit(0.0)),
        "eq_f64_zero": M.EqualTo(f64, M.lit(0.0)),
        "lt_f32_zero": M.LessThan(f32, M.Literal(D.FLOAT32, 0.0)),
        "eq_i32_i64": M.EqualTo(i32, i64),
        "gt_i64": M.GreaterThan(i64, i64b),
        "lt_date": M.LessThan(date, M.Literal(D.DATE, 10_450)),
        "ge_date": M.GreaterThanOrEqual(date, M.Literal(D.DATE, 10_450)),
        "eq_str": M.EqualTo(s, s2),
        "lt_str": M.LessThan(s, s2),
        "ge_str_lit": M.GreaterThanOrEqual(s, M.lit("AB")),
        "eqns_f64": M.EqualNullSafe(f64, f64b),
        "eqns_str": M.EqualNullSafe(s, s2),
        "eqns_i32_null": M.EqualNullSafe(i32, M.Literal(D.INT32, None)),
        "and": M.And(b, M.LessThan(f64, M.lit(1.0))),
        "or": M.Or(b, M.GreaterThan(i32, M.lit(0))),
        "not": M.Not(M.EqualTo(s, s2)),
        "and_or_not": M.Or(M.And(M.Not(b), M.IsNotNull(f64)),
                           M.EqualTo(i32, M.lit(2))),
        "isnull": M.IsNull(s),
        "isnotnull": M.IsNotNull(f64),
        "contains": M.Contains(s, M.lit("BA")),
        "contains_empty": M.Contains(s, M.lit("")),
        "contains_null": M.Contains(s, null_s),
        "startswith": M.StartsWith(s, M.lit("AB")),
        "startswith_long": M.StartsWith(s, M.lit("ABABABAB")),
        "endswith": M.EndsWith(s, M.lit("A")),
        "endswith_utf8": M.EndsWith(s, M.lit("é")),
        "endswith_empty": M.EndsWith(s, M.lit("")),
    }


@pytest.mark.parametrize("layout", ["object", "matrix"])
@pytest.mark.parametrize("name", sorted(_exprs(PORT)))
def test_eval_host_matches_reference(name, layout):
    cols = _columns(1, 97)
    pb, jb = _host_batch(PORT, cols, layout), _host_batch(JAX, cols, layout)
    got = _exprs(PORT)[name].eval_host(pb)
    want = _exprs(JAX)[name].eval_host(jb)
    _same_col(got, want, name)


@pytest.mark.parametrize("layout", ["object", "matrix"])
def test_eval_exprs_host_on_an_empty_batch(layout):
    cols = _columns(2, 0)
    pb, jb = _host_batch(PORT, cols, layout), _host_batch(JAX, cols, layout)
    names = sorted(_exprs(PORT))
    got = TE.base.eval_exprs_host([_exprs(PORT)[n] for n in names], pb)
    want = JE.base.eval_exprs_host([_exprs(JAX)[n] for n in names], jb)
    _same_batches([got], [want])
    assert got.num_rows == 0


# ---------------------------------------------------------------------------
# Basic execs
# ---------------------------------------------------------------------------

def _source(P, layout, seed=3, sizes=(40, 0, 57)):
    """An in-memory source of the generated columns: one partition a
    size (an empty batch among them)."""
    parts = [[_host_batch(P, _columns(seed + i, n), layout)]
             for i, n in enumerate(sizes)]
    return P.src(_schema(P, SCHEMA), parts)


def _basic(P, case, layout):
    M, O, D = P.E, P.O, P.D
    R = M.BoundReference
    src = _source(P, layout)
    f64, i32, s = R(2, D.FLOAT64), R(0, D.INT32), R(6, D.STRING)
    if case == "project":
        return O.ProjectExec(src, [
            ("x", M.Multiply(f64, M.lit(2.0))), ("s", s),
            ("c", M.Add(i32, R(1, D.INT64))), ("k", M.lit(5))])
    if case == "filter_subnormal":
        return O.FilterExec(src, M.GreaterThan(f64, M.lit(0.0)))
    if case == "filter_string":
        return O.FilterExec(src, M.Or(M.StartsWith(s, M.lit("A")),
                                      M.IsNull(s)))
    if case == "coalesce":
        return O.CoalescePartitionsExec(O.FilterExec(
            src, M.IsNotNull(i32)), 1)
    if case == "local_limit":
        return O.LocalLimitExec(src, 7)
    if case == "global_limit":
        return O.GlobalLimitExec(O.CoalescePartitionsExec(
            O.LocalLimitExec(src, 50), 1), 50)
    raise KeyError(case)


@pytest.mark.parametrize("layout", ["object", "matrix"])
@pytest.mark.parametrize("case", ["project", "filter_subnormal",
                                  "filter_string", "coalesce",
                                  "local_limit", "global_limit"])
def test_basic_execute_host_matches_reference(case, layout):
    got = _run_both(lambda P: _basic(P, case, layout))
    if case == "filter_subnormal":
        # The host filter keeps 1e-310 > 0.0 (no flush).
        vals = np.concatenate([b.columns[2].data for p in got for b in p])
        assert (vals == 1e-310).any()


# ---------------------------------------------------------------------------
# Aggregates
# ---------------------------------------------------------------------------

KEYS = {"int": [("k", 0, "int32")], "double": [("k", 2, "float64")],
        "string": [("k", 6, "string")],
        "two": [("k1", 6, "string"), ("k2", 0, "int32")], "none": []}


def _aggs(P, which):
    O, R, D = P.O, P.E.BoundReference, P.D
    i32, i64, f64 = R(0, D.INT32), R(1, D.INT64), R(2, D.FLOAT64)
    specs = [("n", O.CountStar(None)), ("c", O.Count(f64)),
             ("si", O.Sum(i64)), ("sf", O.Sum(f64)), ("ai", O.Average(i32)),
             ("af", O.Average(f64)), ("mnf", O.Min(f64)),
             ("mxf", O.Max(f64)), ("mni", O.Min(i64)), ("mxi", O.Max(i32))]
    if which == "string_minmax":
        # A string Min/Max sends the whole aggregate down the python-row
        # path (int sums wrap per element there).
        specs = [("mns", O.Min(R(6, D.STRING))),
                 ("mxs", O.Max(R(9, D.STRING)))] + specs
    return [O.AggSpec(n, fn) for n, fn in specs]


def _agg_plan(P, keys, which, mode, empty, layout):
    O, R, D = P.O, P.E.BoundReference, P.D
    src = _source(P, layout, sizes=(0, 0) if empty else (40, 0, 57))
    group_by = [(n, R(o, D.type_named(t))) for n, o, t in KEYS[keys]]
    aggs = _aggs(P, which)
    if mode == "complete":
        return O.HashAggregateExec(src, group_by, aggs, mode="complete")
    partial = O.HashAggregateExec(src, group_by, aggs, mode="partial")
    if mode == "partial":
        return partial
    final_groups = [(n, R(i, e.data_type()))
                    for i, (n, e) in enumerate(group_by)]
    return O.HashAggregateExec(O.CoalescePartitionsExec(partial, 1),
                               final_groups, aggs, mode="final")


# (keys, input, string layout): the matrix layout matters to string keys
# over data only.
AGG_INPUTS = [(k, "data", "object") for k in sorted(KEYS)] + \
    [(k, "empty", "object") for k in sorted(KEYS)] + \
    [(k, "data", "matrix") for k in ("string", "two")]


@pytest.mark.parametrize("mode", ["partial", "final", "complete"])
@pytest.mark.parametrize("which", ["numeric", "string_minmax"])
@pytest.mark.parametrize("keys,data,layout", AGG_INPUTS)
def test_aggregate_execute_host_matches_reference(keys, data, layout, which,
                                                  mode):
    empty = data == "empty"
    got = _run_both(lambda P: _agg_plan(P, keys, which, mode, empty,
                                        layout))
    if keys == "none" and mode == "final":
        assert sum(b.num_rows for p in got for b in p) == 1


def test_aggregate_sums_wrap_as_the_reference():
    """Integer sums over int64 extremes wrap, on the vectorized path
    (reduceat) and on the python-row path, as the reference's do."""
    for which in ("numeric", "string_minmax"):
        got = _run_both(lambda P: _agg_plan(P, "none", which, "final",
                                            False, "object"))
        (batch,), = [p for p in got if p]
        si = batch.column("si")
        assert si.validity[0]
        i64 = np.concatenate([np.where(c[2], c[1], 0) for c in (
            _columns(3 + i, n)[1] for i, n in enumerate((40, 0, 57)))])
        with np.errstate(over="ignore"):
            assert int(si.data[0]) == int(np.sum(i64, dtype=np.int64))


# ---------------------------------------------------------------------------
# Sort
# ---------------------------------------------------------------------------

SORTS = {
    "f64_asc": [(2, "float64", True, True)],
    "f64_desc_nulls_last": [(2, "float64", False, False)],
    "f32_asc_nulls_last": [(3, "float32", True, False)],
    "string_asc": [(6, "string", True, True)],
    "string_desc_then_f64": [(6, "string", False, True),
                             (2, "float64", True, False)],
    "i32_desc_then_date": [(0, "int32", False, True),
                           (4, "date", True, True)],
    "i64_asc": [(1, "int64", True, True)],
}


@pytest.mark.parametrize("layout", ["object", "matrix"])
@pytest.mark.parametrize("case", sorted(SORTS))
def test_sort_execute_host_matches_reference(case, layout):
    def build(P):
        R = P.E.BoundReference
        orders = [P.O.SortOrder(R(o, P.D.type_named(t)), asc, nf)
                  for o, t, asc, nf in SORTS[case]]
        return P.O.SortExec(P.O.CoalescePartitionsExec(
            _source(P, layout), 1), orders)
    _run_both(build)


# ---------------------------------------------------------------------------
# Joins
# ---------------------------------------------------------------------------

JOIN_KEYS = {"int": [(0, "int32")], "double": [(2, "float64")],
             "string": [(6, "string")], "two": [(6, "string"), (0, "int32")]}


def _join_plan(P, jt, keys, cond, layout, empty_build=False):
    R, D = P.E.BoundReference, P.D
    left = _source(P, layout, seed=11, sizes=(30, 25))
    right = _source(P, layout, seed=21,
                    sizes=(0,) if empty_build else (20, 0, 16))
    lk = [R(o, D.type_named(t)) for o, t in JOIN_KEYS[keys]]
    rk = [R(o, D.type_named(t)) for o, t in JOIN_KEYS[keys]]
    condition = None
    if cond:
        # left.i64 > right.i64 over the pair schema (left cols first).
        n = len(SCHEMA)
        condition = P.E.GreaterThanOrEqual(R(1, D.INT64), R(n + 1, D.INT64))
    return P.Join(left, right, lk, rk, jt, condition)


JOIN_INPUTS = [(k, "object") for k in sorted(JOIN_KEYS)] + \
    [(k, "matrix") for k in ("string", "two")]


@pytest.mark.parametrize("cond", [False, True], ids=["plain", "cond"])
@pytest.mark.parametrize("keys,layout", JOIN_INPUTS)
@pytest.mark.parametrize("jt", ["inner", "left", "right", "semi", "anti"])
def test_join_execute_host_matches_reference(jt, keys, layout, cond):
    _run_both(lambda P: _join_plan(P, jt, keys, cond, layout))


@pytest.mark.parametrize("jt", ["inner", "left", "right", "semi", "anti"])
def test_join_execute_host_over_an_empty_build(jt):
    _run_both(lambda P: _join_plan(P, jt, "int", False, "object",
                                   empty_build=True))


def test_join_keys_match_nan_and_signed_zero_not_subnormal():
    """The host join's key semantics: NaN joins NaN, -0.0 joins 0.0, and
    a subnormal joins only itself (no flush)."""
    def build(P):
        D, H = P.D, P.H
        vals = np.array([np.nan, -0.0, 1e-310, 2.0])
        rvals = np.array([np.nan, 0.0, 0.0, 2.0])
        mk = lambda v: [[H.HostBatch(("k",), [H.HostColumn(
            D.FLOAT64, v.copy(), np.ones(len(v), np.bool_))])]]
        sch = (("k", D.FLOAT64),)
        R = P.E.BoundReference
        return P.Join(P.src(sch, mk(vals)), P.src(sch, mk(rvals)),
                      [R(0, D.FLOAT64)], [R(0, D.FLOAT64)], "inner")
    (batches,), = [_run_both(build)]
    pairs = [(a, b) for b_ in batches for a, b in b_.to_pylist()]
    assert len(pairs) == 4          # NaN-NaN, -0.0 with both zeros, 2-2
    assert all(a != 1e-310 for a, _ in pairs)


# ---------------------------------------------------------------------------
# Subnormals on both engines of both packages
# ---------------------------------------------------------------------------

def test_subnormal_filter_and_group_key_on_both_engines():
    """x > 0.0 and GROUP BY x over [1e-310, 0.0, -1e-310, 1.0, 1e-310]:
    the host engines (numpy) keep the subnormals as values of their own;
    the device engines compare and group them as zeros of their sign, as
    XLA flushes them. Each engine of the port equals the same engine of
    the reference."""
    vals = np.array([1e-310, 0.0, -1e-310, 1.0, 1e-310])

    def plans(P):
        D, H, O, M = P.D, P.H, P.O, P.E
        R = M.BoundReference
        sch = (("x", D.FLOAT64),)
        src = P.src(sch, [[H.HostBatch(("x",), [H.HostColumn(
            D.FLOAT64, vals.copy(), np.ones(len(vals), np.bool_))])]])
        filt = O.FilterExec(src, M.GreaterThan(R(0, D.FLOAT64),
                                               M.lit(0.0)))
        agg = O.HashAggregateExec(src, [("x", R(0, D.FLOAT64))],
                                  [O.AggSpec("n", O.CountStar(None))],
                                  mode="complete")
        sort = O.SortExec(agg, [O.SortOrder(R(0, D.FLOAT64))])
        return filt, sort

    def rows(P, device):
        return [e.collect(P.ctx(), device=device) for e in plans(P)]

    port_host, ref_host = rows(PORT, False), rows(JAX, False)
    port_dev, ref_dev = rows(PORT, True), rows(JAX, True)
    assert port_host == ref_host
    assert port_dev == ref_dev
    (h_filt, h_agg), (d_filt, d_agg) = port_host, port_dev
    assert sorted(r[0] for r in h_filt) == [1e-310, 1e-310, 1.0]
    assert [r[0] for r in d_filt] == [1.0]
    assert {r[0]: r[1] for r in h_agg} == {-1e-310: 1, 0.0: 1,
                                           1e-310: 2, 1.0: 1}
    # The device flushes +-1e-310 to +-0.0, and -0.0 groups with 0.0.
    assert sorted(r[1] for r in d_agg) == [1, 4]


# ---------------------------------------------------------------------------
# The bridges on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["object", "matrix"])
def test_bridges_round_trip_on_the_cpu(layout):
    """Device -> host -> device -> host over a filtered source gives the
    host filter's rows; the download counts its rows and bytes."""
    M, O, D = TE, TO, tdt
    R = M.BoundReference
    cond = M.IsNotNull(R(0, D.INT32))
    plain = _run_host(PORT, O.FilterExec(_source(PORT, layout), cond))
    d2h = O.DeviceToHostExec(O.FilterExec(_source(PORT, layout), cond))
    h2d = O.HostToDeviceExec(O.ProjectExec(d2h, [
        (n, R(i, D.type_named(t))) for i, (n, t) in enumerate(SCHEMA)]),
        device="cpu")
    ctx = PORT.ctx()
    rows = h2d.collect(ctx)
    want = [r for p in plain for b in p for r in b.to_pylist()]

    def key(r):
        return repr(r)
    assert sorted(map(key, rows)) == sorted(map(key, want))
    m = ctx.metrics_for(d2h).values
    assert m["downloadRows"] == len(want) and m["downloadBytes"] > 0
