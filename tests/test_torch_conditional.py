"""Port parity of the conditional, IN-list, Divide and date-part
expressions: If, CaseWhen (numeric and string, with and without ELSE),
Coalesce, Nvl, InSet (numeric, float with NaN / -0.0 / subnormals,
string, NULL in the list), Divide, and the date parts Year, Month,
DayOfMonth and Quarter, against the JAX package's, on the CPU.

- The same seeded numpy columns go through both packages on both of the
  reference's engines: ``eval`` on a device batch (the JAX package on the
  JAX CPU device, the port in torch on the CPU) and ``eval_host`` on a
  host batch (numpy in both; strings in both host layouts, the ``bytes``
  object array and the byte matrix a download gives).
- Results compare bit for bit: data (under dead rows too, NaN payloads
  and the sign of zero included), validity and string lengths.
- Parity points pinned here: ``lit(1)`` is INT32, so a CASE of it sums as
  INT64; an int64 column against an int32 literal; string branches of
  different widths with NULLs in both branches and the predicate;
  Divide's x / 0.0, x / -0.0, 0.0 / 0.0, NaN / x and subnormal operands
  and quotients (the reference's device engine reads a subnormal as a
  zero of its sign and flushes a subnormal quotient, its host engine
  does neither; the port follows each); the date parts on 1969-12-31,
  1900-03-01, 2000-02-29, negative day counts and NULL, and on
  timestamps before 1970; InSet's NULL in the list, NaN in the list,
  -0.0 against 0.0 and a value longer than the column's matrix.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.exprs import base as jbase
from spark_rapids_tpu.plan import logical as JL

from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost
from spark_rapids_tpu_torch.exprs import base as tbase
from spark_rapids_tpu_torch.plan import logical as L

# NaN and inf arithmetic is part of the inputs on purpose.
pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")

CAP = 128
LIVE = 117

# Divide's operands: every dividend against every divisor (77 rows).
DIVIDENDS = [1.0, -1.0, 0.0, -0.0, np.nan, np.inf, 1e-300, 1e-310, 5e-324,
             3.0, -2.5]
DIVISORS = [0.0, -0.0, 2.0, 1e10, 1e-310, np.inf, np.nan]
F64_POOL = np.array([0.0, -0.0, 1e-310, -1e-310, 5e-324, np.nan, np.inf,
                     -np.inf, 1.5, -2.25, 3.0])
# Days: 1969-12-31, 1970-01-01, 1900-03-01, 2000-02-29, 1600-02-29,
# 0000-03-01 and far negative / positive counts, among random ones.
SPECIAL_DAYS = np.array([-1, 0, -25508, 11016, -135081, -719468,
                         -1_000_000, 2_932_896], np.int32)
STR_POOL = [b"", b"A", b"AB", b"ABA", b"BA", b"\xc3\xa9t\xc3\xa9",
            b"ABABABAB", b"ABABABABABAB"]

# (name, type) of the generated columns.
SCHEMA = (("b", "bool"), ("b2", "bool"), ("i32", "int32"), ("i64", "int64"),
          ("f64", "float64"), ("f64b", "float64"), ("num", "float64"),
          ("den", "float64"), ("d", "date"), ("ts", "timestamp"),
          ("s", "string"), ("s2", "string"), ("f32", "float32"))


def _columns(seed: int) -> list:
    """(type, data, validity) per SCHEMA column, CAP rows; string data
    is a list of bytes. Rows at LIVE and above are dead on the device."""
    rng = np.random.default_rng(seed)
    cross = np.array([(a, b) for a in DIVIDENDS for b in DIVISORS])
    out = []
    for name, t in SCHEMA:
        valid = rng.random(CAP) < 0.8
        if t == "bool":
            data = rng.random(CAP) < 0.5
        elif t == "int32":
            data = rng.integers(-3, 4, CAP).astype(np.int32)
        elif t == "int64":
            data = rng.integers(-3, 4, CAP).astype(np.int64)
            data[:3] = [2 ** 63 - 1, -2 ** 63, 2 ** 40]
        elif name in ("num", "den"):
            data = np.resize(cross[:, 0 if name == "num" else 1], CAP)
            valid[:len(cross)] = True
        elif t == "float64":
            data = rng.choice(F64_POOL, CAP)
        elif t == "float32":
            data = rng.choice(F64_POOL, CAP).astype(np.float32)
        elif t == "date":
            data = rng.integers(-800_000, 800_000, CAP).astype(np.int32)
            data[:len(SPECIAL_DAYS)] = SPECIAL_DAYS
            valid[:len(SPECIAL_DAYS)] = True
        elif t == "timestamp":
            data = rng.integers(-10 ** 17, 10 ** 17, CAP)
            data[:4] = [-1, 0, -86_400_000_000, -86_400_000_001]
            valid[:4] = True
        else:
            pool = STR_POOL[:5] if name == "s" else STR_POOL
            data = [pool[i] for i in rng.integers(0, len(pool), CAP)]
        out.append((t, data, valid))
    return out


def _device_batch(P, cols):
    """A device batch of ``cols`` in package P (JAX or the port)."""
    D = jdt if P == JAX else tdt
    B = jbatch if P == JAX else tbatch
    live = np.arange(CAP) < LIVE
    dcols = []
    for t, data, valid in cols:
        v = valid & live
        lengths = None
        if t == "string":
            w = max(len(b) for b in data)
            m = np.zeros((CAP, w), np.uint8)
            for i, b in enumerate(data):
                if v[i]:
                    m[i, :len(b)] = np.frombuffer(b, np.uint8)
            lengths = np.array([len(b) if ok else 0 for b, ok in
                                zip(data, v)], np.int32)
            d = m
        else:
            d = np.where(v, np.asarray(data), np.zeros(1, np.asarray(
                data).dtype)).astype(D.type_named(t).np_dtype)
        conv = (lambda a: jnp.asarray(a)) if P == JAX else \
            (lambda a: torch.from_numpy(np.ascontiguousarray(a).copy()))
        dcols.append(B.DeviceColumn(
            D.type_named(t), conv(d), conv(v),
            None if lengths is None else conv(lengths)))
    n = jnp.asarray(LIVE, jnp.int32) if P == JAX else \
        torch.tensor(LIVE, dtype=torch.int32)
    return B.DeviceBatch(tuple(dcols), n)


def _host_batch(P, cols, layout):
    H = jhost if P == JAX else thost
    D = jdt if P == JAX else tdt
    hcols = []
    for t, data, valid in cols:
        dtype = D.type_named(t)
        valid = np.asarray(valid, np.bool_).copy()
        if dtype.is_string:
            vals = [b if ok else b"" for b, ok in zip(data, valid)]
            if layout == "matrix":
                w = max(len(b) for b in vals)
                m = np.zeros((CAP, w), np.uint8)
                for i, b in enumerate(vals):
                    m[i, :len(b)] = np.frombuffer(b, np.uint8)
                hcols.append(H.HostColumn(
                    dtype, None, valid, str_matrix=m,
                    str_lengths=np.array([len(b) for b in vals], np.int32)))
            else:
                obj = np.empty(CAP, dtype=object)
                obj[:] = vals
                hcols.append(H.HostColumn(dtype, obj, valid))
        else:
            d = np.where(valid, np.asarray(data),
                         np.zeros(1, np.asarray(data).dtype))
            hcols.append(H.HostColumn(dtype, d.astype(dtype.np_dtype),
                                      valid))
    return H.HostBatch(tuple(n for n, _ in SCHEMA), hcols)


JAX, PORT = "jax", "port"


def _tree(which, P):
    """The same expression over package P's classes."""
    M = JE if P == JAX else TE
    D = jdt if P == JAX else tdt
    R = {n: M.BoundReference(i, D.type_named(t), n)
         for i, (n, t) in enumerate(SCHEMA)}
    lit = M.lit
    trees = {
        "if_int": lambda: M.If(R["b"], R["i32"], lit(7)),
        "if_widen": lambda: M.If(R["b"], R["i64"], R["i32"]),
        "if_float": lambda: M.If(M.LessThan(R["i32"], lit(0)), R["f64"],
                                 R["f64b"]),
        "if_str_widths": lambda: M.If(R["b"], R["s"], R["s2"]),
        "if_str_wide_first": lambda: M.If(R["b"], R["s2"], R["s"]),
        "if_str_literal": lambda: M.If(R["b"], lit("BRAZIL"), R["s"]),
        "case_int_else": lambda: M.CaseWhen(
            [(R["b"], lit(1)), (R["b2"], R["i32"])], lit(0)),
        "case_int_no_else": lambda: M.CaseWhen(
            [(R["b"], R["i32"]), (R["b2"], lit(2))]),
        "case_long_literal": lambda: M.CaseWhen(
            [(M.EqualTo(R["i64"], lit(2)), lit(1))], lit(0)),
        "case_float": lambda: M.CaseWhen(
            [(M.EqualTo(R["s"], lit("AB")), R["f64"])], lit(0.0)),
        "case_str_else": lambda: M.CaseWhen(
            [(R["b"], R["s"]), (R["b2"], R["s2"])],
            lit("A LONGER ELSE VALUE")),
        "case_str_no_else": lambda: M.CaseWhen(
            [(R["b"], R["s2"]), (R["b2"], R["s"])]),
        "coalesce_float": lambda: M.Coalesce(R["f64"], R["f64b"],
                                             lit(1.5)),
        "coalesce_str": lambda: M.Coalesce(R["s"], R["s2"]),
        "coalesce_one": lambda: M.Coalesce(R["i64"]),
        "nvl_long_int": lambda: M.Nvl(R["i64"], lit(0)),
        "nvl_str_literal": lambda: M.Nvl(R["s2"], lit("none")),
        "inset_int": lambda: M.InSet(R["i32"], [1, 3, -2]),
        "inset_int_null": lambda: M.InSet(R["i32"], [1, None]),
        "inset_long": lambda: M.InSet(R["i64"], [2 ** 40, -3]),
        "inset_zero": lambda: M.InSet(R["f64"], [0.0, 1.5]),
        "inset_neg_zero": lambda: M.InSet(R["f64"], [-0.0]),
        "inset_subnormal": lambda: M.InSet(R["f64"], [1e-310]),
        "inset_nan_null": lambda: M.InSet(R["f64"], [float("nan"), None]),
        "inset_f32": lambda: M.InSet(R["f32"], [1.5, float("nan")]),
        "inset_date": lambda: M.InSet(R["d"], [-1, 11016]),
        "inset_str": lambda: M.InSet(R["s"], ["AB", "", "ABABABABABAB"]),
        "inset_str_null": lambda: M.InSet(R["s2"], ["A", None]),
        "inset_str_wider": lambda: M.InSet(R["s"], ["ABAXX", "ABA"]),
        "divide_edges": lambda: M.Divide(R["num"], R["den"]),
        "divide_random": lambda: M.Divide(R["f64"], R["f64b"]),
        "divide_ints": lambda: M.Divide(R["i64"], R["i32"]),
        "divide_by_zero_literal": lambda: M.Divide(R["f64"], lit(0.0)),
        "divide_literal_by": lambda: M.Divide(lit(1.0), R["num"]),
        "year": lambda: M.Year(R["d"]),
        "month": lambda: M.Month(R["d"]),
        "dayofmonth": lambda: M.DayOfMonth(R["d"]),
        "quarter": lambda: M.Quarter(R["d"]),
        "quarter_ts": lambda: M.Quarter(R["ts"]),
        "year_ts": lambda: M.Year(R["ts"]),
        "dayofmonth_ts": lambda: M.DayOfMonth(R["ts"]),
    }
    return trees[which]()


EXPRS = ["if_int", "if_widen", "if_float", "if_str_widths",
         "if_str_wide_first", "if_str_literal", "case_int_else",
         "case_int_no_else", "case_long_literal", "case_float",
         "case_str_else", "case_str_no_else", "coalesce_float",
         "coalesce_str", "coalesce_one", "nvl_long_int", "nvl_str_literal",
         "inset_int", "inset_int_null", "inset_long", "inset_zero",
         "inset_neg_zero", "inset_subnormal", "inset_nan_null", "inset_f32",
         "inset_date", "inset_str", "inset_str_null", "inset_str_wider",
         "divide_edges", "divide_random", "divide_ints",
         "divide_by_zero_literal", "divide_literal_by", "year", "month",
         "dayofmonth", "quarter", "quarter_ts", "year_ts", "dayofmonth_ts"]


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8) if a.dtype != np.bool_ else a


@pytest.mark.parametrize("which", EXPRS)
def test_device_eval_matches_reference(which):
    cols = _columns(0)
    jb, tb = _device_batch(JAX, cols), _device_batch(PORT, cols)
    jc = jbase.as_device_column(_tree(which, JAX).eval(jb), jb)
    tc = tbase.as_device_column(_tree(which, PORT).eval(tb), tb)
    assert tc.dtype.name == jc.dtype.name
    want, got = np.asarray(jc.data), tc.data.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(tc.validity.numpy(),
                                  np.asarray(jc.validity))
    if jc.lengths is not None:
        np.testing.assert_array_equal(tc.lengths.numpy(),
                                      np.asarray(jc.lengths))


@pytest.mark.parametrize("layout", ["object", "matrix"])
@pytest.mark.parametrize("which", EXPRS)
def test_host_eval_matches_reference(which, layout):
    cols = _columns(1)
    jb, pb = _host_batch(JAX, cols, layout), _host_batch(PORT, cols, layout)
    jc = jbase.as_host_column(_tree(which, JAX).eval_host(jb), jb)
    pc = tbase.as_host_column(_tree(which, PORT).eval_host(pb), pb)
    assert pc.dtype.name == jc.dtype.name
    np.testing.assert_array_equal(np.asarray(pc.validity, np.bool_),
                                  np.asarray(jc.validity, np.bool_))
    if pc.dtype.is_string:
        assert pc.to_list() == jc.to_list()
        return
    pd, jd = np.asarray(pc.data), np.asarray(jc.data)
    assert pd.dtype == jd.dtype
    assert pd.tobytes() == jd.tobytes(), (pd, jd)


# ---------------------------------------------------------------------------
# Pinned answers (what each engine gives, recorded)
# ---------------------------------------------------------------------------

def _one(expr_of, engine, *cols):
    """Evaluate the port's expression over columns given as (type, values,
    validity) on one engine; returns (values, validity) as lists."""
    n = len(cols[0][1])
    names = tuple(f"c{i}" for i in range(len(cols)))
    refs = [TE.BoundReference(i, tdt.type_named(t), names[i])
            for i, (t, _v, _ok) in enumerate(cols)]
    e = expr_of(*refs)
    if engine == "host":
        hb = thost.HostBatch(names, [
            thost.HostColumn(tdt.type_named(t), np.asarray(
                v, tdt.type_named(t).np_dtype), np.asarray(ok, np.bool_))
            for t, v, ok in cols])
        c = tbase.as_host_column(e.eval_host(hb), hb)
        return np.asarray(c.data).tolist(), np.asarray(c.validity).tolist()
    tb = tbatch.DeviceBatch(tuple(
        tbatch.DeviceColumn(tdt.type_named(t), torch.from_numpy(np.asarray(
            v, tdt.type_named(t).np_dtype)), torch.tensor(ok))
        for t, v, ok in cols), torch.tensor(n, dtype=torch.int32))
    c = tbase.as_device_column(e.eval(tb), tb)
    return c.data.numpy().tolist(), c.validity.numpy().tolist()


def _signed(x):
    return (x, np.signbit(x)) if x == x else ("nan",)


@pytest.mark.parametrize("engine", ["device", "host"])
def test_divide_edges_pinned(engine):
    a = [1.0, 1.0, 0.0, np.nan, 1e-300, 1e-310, -5.0, -1e-300]
    b = [0.0, -0.0, 0.0, 2.0, 1e10, 2.0, 1e-310, 1e10]
    got, valid = _one(TE.Divide, engine, ("float64", a, [True] * 8),
                      ("float64", b, [True] * 8))
    # x / 0.0 and x / -0.0 are NULL; NaN / x is NaN.
    assert valid[:3] == [False] * 3 and valid[3] and np.isnan(got[3])
    if engine == "device":
        # Subnormal quotients flush to a zero of their sign; a subnormal
        # divisor reads as zero, so the quotient is NULL.
        assert [_signed(x) for x in got[4:6] + got[7:]] == [
            (0.0, False), (0.0, False), (0.0, True)]
        assert valid[4:] == [True, True, False, True]
    else:
        assert got[4:6] == [1e-310, 5e-311] and got[7] == -1e-310
        assert got[6] == -np.inf and all(valid[3:])


@pytest.mark.parametrize("engine", ["device", "host"])
def test_date_parts_pinned(engine):
    days = [-1, -25508, 11016, 0, -719468, 5]
    ok = [True] * 5 + [False]
    col = ("date", days, ok)
    parts = {k: _one(f, engine, col) for k, f in (
        ("y", TE.Year), ("m", TE.Month), ("d", TE.DayOfMonth),
        ("q", TE.Quarter))}
    assert list(zip(parts["y"][0], parts["m"][0], parts["d"][0]))[:5] == [
        (1969, 12, 31), (1900, 3, 1), (2000, 2, 29), (1970, 1, 1),
        (0, 3, 1)]
    assert parts["q"][0][:5] == [4, 1, 1, 1, 1]
    for v, valid in parts.values():
        assert valid == ok and v[5] == 0          # NULL: zeroed data


@pytest.mark.parametrize("engine", ["device", "host"])
def test_inset_pinned(engine):
    col = ("float64", [0.0, -0.0, 1e-310, np.nan, 2.0, 1.0],
           [True] * 5 + [False])
    got, valid = _one(lambda c: TE.InSet(c, [0.0, float("nan"), None]),
                      engine, col)
    # -0.0 matches 0.0; the NULL value and a miss against a list holding
    # a NULL are NULL. A subnormal matches 0.0 on the device only.
    assert got[:2] == [True, True] and got[3] and not got[4]
    assert valid[:2] == [True, True] and valid[3] and valid[4:] == [
        False, False]
    assert got[2] == (engine == "device") and valid[2] == got[2]


# ---------------------------------------------------------------------------
# The DSL: the new builders resolve as the reference's
# ---------------------------------------------------------------------------

RSCHEMA = (("i32", "int32"), ("i64", "int64"), ("f64", "float64"),
           ("d", "date"), ("s", "string"), ("b", "bool"))

DSL = {
    "when_lit_int": lambda M: M.when(M.col("b"), 1).otherwise(0),
    "when_int64_vs_int32": lambda M: M.when(
        M.col("i64") == M.lit_col(3), 1).otherwise(0),
    "when_chain_no_else": lambda M: M.when(M.col("i32") > 1, M.col("f64"))
    .when(M.col("b"), 0.5),
    "when_str": lambda M: M.when(M.col("s") == M.lit_col("M"), "male")
    .otherwise(M.col("s")),
    "isin_str": lambda M: M.col("s").isin("MAIL", "SHIP"),
    "isin_list": lambda M: M.col("i32").isin([1, 2, None]),
    "coalesce": lambda M: M.coalesce_cols(M.col("f64"), 0.0),
    "div": lambda M: M.col("i64") / M.col("f64"),
    "div_lit": lambda M: M.col("f64") * 100.0 / M.col("f64"),
    "year": lambda M: M.year(M.col("d")),
    "month": lambda M: M.month(M.col("d")),
    "dayofmonth": lambda M: M.dayofmonth(M.col("d")),
}


def _same_expr(j, p, path="root"):
    assert type(p).__name__ == type(j).__name__, path
    assert p.data_type().name == j.data_type().name, path
    for attr in ("values", "ordinal", "value"):
        if hasattr(j, attr):
            assert getattr(p, attr) == getattr(j, attr) and type(
                getattr(p, attr)) is type(getattr(j, attr)), (path, attr)
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


def test_lit_one_sums_as_int64():
    """``when(..., 1).otherwise(0)`` is INT32, as ``lit(1)`` is in the
    reference, so its Sum is INT64 (the pivot sums of TPCxBB q5 and
    TPC-H q12)."""
    from spark_rapids_tpu_torch.plan.planner import resolve_agg
    schema = tuple((n, tdt.type_named(t)) for n, t in RSCHEMA)
    c = L.agg_sum(L.when(L.col("b"), 1).otherwise(0))
    assert L.resolve(c.node[2], schema).data_type() == tdt.INT32
    assert resolve_agg(c, schema).result_type == tdt.INT64
