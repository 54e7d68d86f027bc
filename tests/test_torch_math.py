"""Port parity of the math and the rest of the arithmetic, predicate and
conditional expressions: every class of ``exprs/math.py``, the rest of
``exprs/arithmetic.py`` (IntegralDivide, UnaryMinus, UnaryPositive, Abs,
Least, Greatest, the bitwise operations and the shifts), IsNan,
AtLeastNNonNulls, NaNvl, NormalizeNaNAndZero and
KnownFloatingPointNormalized, against the JAX package's classes on the
CPU.

- The same seeded numpy columns go through both packages on both of the
  reference's engines: ``eval`` on a device batch (the JAX package on its
  CPU device, the port in torch on the CPU) and ``eval_host`` on a host
  batch (numpy in both).
- The inputs hold the reference's edge values (``tests/test_exprs.py``
  TestArithmetic, TestMath, TestAtLeastNNonNulls and
  ``test_least_nan_is_greatest``), subnormal operands and results
  (``exp(-740)``, ``1e-310``, ``5e-324``), +-0.0, NaN, +-Inf, the
  largest double, ``INT64_MIN`` / ``INT64_MAX``, NULLs and a dead tail.
- Results compare bit for bit (data under dead and NULL rows too, the
  sign of zero included, validity; any NaN matches any NaN, as the NaN an
  invalid operation makes is the hardware's: x86's, CUDA's), except the
  transcendentals on the device half, which compare within rtol 1e-14
  (XLA's and torch's libm differ in the last bits). Where the reference's
  device engine flushes a subnormal and where it keeps one is pinned row
  by row.
- Divergences (``DIVERGENT``): where the reference's transcendental is
  less accurate than the CPU's libm (``cbrt`` of a subnormal, ``atan2``
  with a subnormal operand, ``sinh`` / ``cosh`` near overflow, ``log1p``
  / ``atanh`` in part of (-1, 0)), a row may differ from the reference
  only when numpy's value is not subnormal, the port is within 4 ulp of
  numpy's value and the reference is not within rtol 1e-14 of it. ``test_divergences_pinned``
  lists those rows.
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

from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost
from spark_rapids_tpu_torch.exprs import base as tbase

# NaN and inf arithmetic is part of the inputs on purpose.
pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")

CAP = 192
LIVE = 181
JAX, PORT = "jax", "port"
I64_MIN, I64_MAX = -2 ** 63, 2 ** 63 - 1

F64_EDGES = [0.0, -0.0, 1e-310, -1e-310, 5e-324, -5e-324,
             2.2250738585072014e-308, np.nan, np.inf, -np.inf, 1.0, -1.0,
             0.5, -0.5, 2.5, -2.5, 3.5, 1.25, 1.35, -1.35, 4.0, 0.25, 8.0,
             100.0, 1e300, -1e300, 1.7976931348623157e308, 709.0, 710.0,
             -740.0, -745.5, -708.0, 1e-300, -1e-300, 1e-160, 0.9999999,
             -0.9999999, 2.0, 1e15 + 0.5, 123456.789, -0.049999999]
I64_EDGES = [I64_MIN, I64_MAX, -1, 0, 1, 2 ** 60 + 1, -(2 ** 60 + 1), 125,
             25, 35, -25, -35, 24, 26, 10, -7, 2 ** 53 + 1, -3, 64, 65,
             -64, 2 ** 62]
I32_EDGES = [-2 ** 31, 2 ** 31 - 1, -1, 0, 1, 3, 7, -8, 256, 33, 31, 32,
             -2, 5, 2, 63]


def _columns(seed: int):
    """[(name, type, data, validity)]: the edge values first (valid),
    then seeded random values with NULLs."""
    rng = np.random.default_rng(seed)

    def fill(edges, rand, dtype):
        data = np.asarray(rand, dtype)
        data[:len(edges)] = np.asarray(edges, dtype)
        valid = rng.random(CAP) < 0.85
        valid[:len(edges)] = True
        return data, valid

    def shuffled(edges):
        e = list(edges)
        rng.shuffle(e)
        return e

    f_rand = np.where(rng.random(CAP) < 0.5, rng.normal(0, 10, CAP),
                      rng.normal(0, 1e12, CAP))
    cols = [
        ("x", "float64") + fill(F64_EDGES, f_rand, np.float64),
        ("y", "float64") + fill(shuffled(F64_EDGES),
                                rng.normal(0, 3, CAP), np.float64),
        ("u", "float64") + fill(
            [0.5, -0.5, 1.0, -1.0, 0.0, -0.0, 1.5, -1.5, np.nan, 1e-310],
            rng.uniform(-1.2, 1.2, CAP), np.float64),
        ("f32", "float32") + fill(
            [0.0, -0.0, 1e-40, np.nan, np.inf, -np.inf, 2.5, -2.5, 3.4e38],
            rng.normal(0, 100, CAP), np.float32),
        ("i64", "int64") + fill(I64_EDGES,
                                rng.integers(-10 ** 12, 10 ** 12, CAP),
                                np.int64),
        ("j64", "int64") + fill(
            [-1, 0, 3, I64_MIN, -1, 1, 2, 5, 7, 10, -10, 3, 64, -5, 2, 0],
            rng.integers(-20, 20, CAP), np.int64),
        ("i32", "int32") + fill(I32_EDGES, rng.integers(-1000, 1000, CAP),
                                np.int32),
        ("k32", "int32") + fill(
            [0, 1, 3, 33, 31, 32, -1, 64, 65, -33, 5, 2, 1, 0, 7, 63],
            rng.integers(-70, 70, CAP), np.int32),
        ("i8", "int8") + fill([-128, 127, -1, 0, 1, -8, 64],
                              rng.integers(-128, 128, CAP), np.int8),
    ]
    return [(n, t, d, v) for n, t, d, v in cols]


SCHEMA = tuple((n, t) for n, t, _d, _v in _columns(0))


def device_batch(P, cols, live=LIVE):
    """A device batch of package P over (name, type, data, validity)."""
    D = jdt if P == JAX else tdt
    B = jbatch if P == JAX else tbatch
    alive = np.arange(len(cols[0][2])) < live
    out = []
    for _n, t, data, valid in cols:
        v = valid & alive
        d = np.where(v, data, np.zeros(1, data.dtype)).astype(
            D.type_named(t).np_dtype)
        if P == JAX:
            out.append(B.DeviceColumn(D.type_named(t), jnp.asarray(d),
                                      jnp.asarray(v)))
        else:
            out.append(B.DeviceColumn(D.type_named(t),
                                      torch.from_numpy(d.copy()),
                                      torch.from_numpy(v.copy())))
    n = jnp.asarray(live, jnp.int32) if P == JAX else \
        torch.tensor(live, dtype=torch.int32)
    return B.DeviceBatch(tuple(out), n)


def host_batch(P, cols):
    H = jhost if P == JAX else thost
    D = jdt if P == JAX else tdt
    hcols = []
    for _n, t, data, valid in cols:
        dtype = D.type_named(t)
        d = np.where(valid, data, np.zeros(1, data.dtype)).astype(
            dtype.np_dtype)
        hcols.append(H.HostColumn(dtype, d, np.asarray(valid, np.bool_)))
    return H.HostBatch(tuple(n for n, _t, _d, _v in cols), hcols)


@pytest.fixture(scope="module")
def batches():
    """(device batches, host batches) of both packages, and the port's
    host batch of the device batches' values (numpy's libm values)."""
    dcols, hcols = _columns(0), _columns(1)
    live = np.arange(CAP) < LIVE
    libm = host_batch(PORT, [(n, t, d, v & live) for n, t, d, v in dcols])
    return ({P: device_batch(P, dcols) for P in (JAX, PORT)},
            {P: host_batch(P, hcols) for P in (JAX, PORT)}, libm)


def bits(a):
    """Row-comparable bytes; every NaN as the one canonical NaN."""
    a = np.array(a, copy=True)
    if a.dtype.kind == "f":
        a[np.isnan(a)] = np.nan
    a = np.ascontiguousarray(a)
    return a.view(np.uint8).reshape(len(a), -1) if a.dtype != np.bool_ \
        else a


def ulps(a, b):
    """Distance in units in the last place between float64 arrays (NaN to
    NaN is 0, NaN to a number is huge)."""
    def key(x):
        i = np.asarray(x, np.float64).view(np.int64)
        return np.where(i < 0, np.int64(-2 ** 63) - i, i)
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    with np.errstate(over="ignore"):
        d = np.abs(key(a).astype(np.float64) - key(b).astype(np.float64))
    both_nan = np.isnan(a) & np.isnan(b)
    d = np.where(np.isnan(a) != np.isnan(b), np.inf, d)
    return np.where(both_nan, 0.0, d)


def assert_same(got_data, got_valid, want_data, want_valid, rtol=None,
                libm=None):
    """Validity equal; data bit for bit, or within ``rtol`` (NaN where
    NaN, equal infinities) for a transcendental. Returns the rows allowed
    as divergences: with ``libm`` (numpy's values), a row outside rtol
    passes where numpy's value is not subnormal, the port is within 4 ulp
    of it and the reference is not within rtol of it."""
    got_data, want_data = np.asarray(got_data), np.asarray(want_data)
    assert got_data.dtype == want_data.dtype
    np.testing.assert_array_equal(np.asarray(got_valid, np.bool_),
                                  np.asarray(want_valid, np.bool_))
    if rtol is None:
        np.testing.assert_array_equal(bits(got_data), bits(want_data))
        return []
    close = np.isclose(got_data, want_data, rtol=rtol, atol=0,
                       equal_nan=True)
    if libm is not None:
        v = np.asarray(libm, np.float64)
        normal = ~((v != 0) & (np.abs(v) < np.finfo(np.float64).tiny))
        ref_off = ~np.isclose(want_data, v, rtol=rtol, atol=0,
                              equal_nan=True)
        diverge = ~close & normal & (ulps(got_data, v) <= 4) & ref_off
        close = close | diverge
    else:
        diverge = np.zeros(len(close), bool)
    bad = np.flatnonzero(~close)
    assert not len(bad), [(int(i), got_data[i], want_data[i])
                          for i in bad[:8]]
    return np.flatnonzero(diverge).tolist()


def eval_both(tree, batches, engine):
    """(port column, reference column) of ``tree(P)`` on one engine."""
    dev, host = batches[:2]
    if engine == "device":
        jc = jbase.as_device_column(tree(JAX).eval(dev[JAX]), dev[JAX])
        tc = tbase.as_device_column(tree(PORT).eval(dev[PORT]), dev[PORT])
        return (tc.data.numpy(), tc.validity.numpy()), \
            (np.asarray(jc.data), np.asarray(jc.validity))
    jc = jbase.as_host_column(tree(JAX).eval_host(host[JAX]), host[JAX])
    tc = tbase.as_host_column(tree(PORT).eval_host(host[PORT]), host[PORT])
    return (tc.data, tc.validity), (jc.data, jc.validity)


def _refs(P):
    M = JE if P == JAX else TE
    D = jdt if P == JAX else tdt
    return M, {n: M.BoundReference(i, D.type_named(t), n)
               for i, (n, t) in enumerate(SCHEMA)}


# name -> (a function of the package, transcendental on the device)
UNARY_MATH = ["Sqrt", "Cbrt", "Exp", "Expm1", "Sin", "Cos", "Tan", "Asin",
              "Acos", "Atan", "Sinh", "Cosh", "Tanh", "Asinh", "Acosh",
              "Atanh", "ToDegrees", "ToRadians", "Signum", "Rint", "Log",
              "Log10", "Log2", "Log1p", "Floor", "Ceil"]
TRANSCENDENTAL = {"Cbrt", "Exp", "Expm1", "Sin", "Cos", "Tan", "Asin",
                  "Acos", "Atan", "Sinh", "Cosh", "Tanh", "Asinh", "Acosh",
                  "Atanh", "Log", "Log10", "Log2", "Log1p", "Pow", "Atan2",
                  "Logarithm"}


def _cases():
    cases = {}
    for name in UNARY_MATH:
        for col in ("x", "u", "f32", "i64"):
            cases[f"{name}[{col}]"] = (
                lambda P, name=name, col=col:
                getattr(_refs(P)[0], name)(_refs(P)[1][col]),
                name in TRANSCENDENTAL)
    lit = {JAX: JE.lit, PORT: TE.lit}

    def add(key, fn, transcendental=False):
        cases[key] = (fn, transcendental)

    def b(name, *cols, **kw):
        def build(P):
            M, R = _refs(P)
            return getattr(M, name)(*[R[c] if isinstance(c, str)
                                      else c(P) for c in cols], **kw)
        return build

    for name in ("Pow", "Atan2", "Logarithm"):
        add(f"{name}[x,y]", b(name, "x", "y"), True)
        add(f"{name}[y,x]", b(name, "y", "x"), True)
        add(f"{name}[u,i32]", b(name, "u", "i32"), True)
    add("Pow[x,2]", b("Pow", "x", lambda P: lit[P](2.0)), True)
    add("Logarithm[2,x]", b("Logarithm", lambda P: lit[P](2.0), "x"), True)
    add("Logarithm[10,y]", b("Logarithm", lambda P: lit[P](10.0), "y"), True)
    for scale in (-12, -2, 0, 1, 2, 5):
        for col in ("x", "y", "f32", "i64", "i32", "i8"):
            add(f"Round[{col},{scale}]", b("Round", col, scale=scale))
            add(f"BRound[{col},{scale}]", b("BRound", col, scale=scale))
    add("Round[x,lit1]", lambda P: _refs(P)[0].Round(
        _refs(P)[1]["x"], lit[P](1)))
    for l, r in (("i64", "j64"), ("i32", "j64"), ("j64", "i32"),
                 ("i64", "i32"), ("x", "j64")):
        add(f"IntegralDivide[{l},{r}]", b("IntegralDivide", l, r))
    for name in ("UnaryMinus", "UnaryPositive", "Abs"):
        for col in ("x", "f32", "i64", "i32", "i8"):
            add(f"{name}[{col}]", b(name, col))
    for name in ("Least", "Greatest"):
        add(f"{name}[x,y]", b(name, "x", "y"))
        add(f"{name}[x,y,u]", b(name, "x", "y", "u"))
        add(f"{name}[i64,i32,j64]", b(name, "i64", "i32", "j64"))
        add(f"{name}[f32,x]", b(name, "f32", "x"))
        add(f"{name}[i32,lit]", b(name, "i32", lambda P: lit[P](5)))
    for name in ("BitwiseAnd", "BitwiseOr", "BitwiseXor"):
        add(f"{name}[i64,j64]", b(name, "i64", "j64"))
        add(f"{name}[i32,k32]", b(name, "i32", "k32"))
        add(f"{name}[i8,i32]", b(name, "i8", "i32"))
    for col in ("i64", "i32", "i8"):
        add(f"BitwiseNot[{col}]", b("BitwiseNot", col))
    for name in ("ShiftLeft", "ShiftRight", "ShiftRightUnsigned"):
        for l in ("i64", "i32", "j64"):
            add(f"{name}[{l},k32]", b(name, l, "k32"))
        add(f"{name}[i64,lit]", b(name, "i64", lambda P: lit[P](3)))
    for col in ("x", "f32", "u"):
        add(f"IsNan[{col}]", b("IsNan", col))
        add(f"NaNvl[{col},y]", b("NaNvl", col, "y"))
        add(f"NormalizeNaNAndZero[{col}]", b("NormalizeNaNAndZero", col))
        add(f"KnownFloatingPointNormalized[{col}]",
            b("KnownFloatingPointNormalized", col))
    add("NaNvl[x,i32]", b("NaNvl", "x", "i32"))
    for n in (0, 1, 2, 3, 5):
        add(f"AtLeastNNonNulls[{n}]", lambda P, n=n: _refs(P)[0]
            .AtLeastNNonNulls(n, *[_refs(P)[1][c] for c in
                                   ("x", "i64", "f32", "u")]))
    return cases


CASES = _cases()


# The functions whose reference is less accurate than numpy on some rows
# (ROADMAP queue C), and the rows of ``_columns(0)`` where it shows.
DIVERGENT = {
    "Cbrt[x]": [2, 3, 4, 5], "Cbrt[u]": [9],
    "Sinh[x]": [27, 28, 31], "Cosh[x]": [27, 28, 31],
    "Log1p[u]": [23, 91], "Atanh[u]": [91],
    "Atan2[x,y]": [2, 3], "Atan2[y,x]": [2, 3],
}


def _divergent_rows(case, batches):
    tree, _t = CASES[case]
    got, want = eval_both(tree, batches, "device")
    libm = batches[2]
    v = tbase.as_host_column(tree(PORT).eval_host(libm), libm).data
    return assert_same(*got, *want, rtol=1e-14,
                       libm=v if case in DIVERGENT else None)


# Rows where torch's CPU square root, after the port's Newton step, may
# stay an ulp off: a root within ~2^-54 ulp of a rounding midpoint (the
# largest double). CUDA's square root is correctly rounded.
SQRT_NEAR_MIDPOINT = {"Sqrt[x]": [26]}


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_reference(case, engine, batches):
    tree, transcendental = CASES[case]
    if transcendental and engine == "device":
        _divergent_rows(case, batches)
        return
    (gd, gv), want = eval_both(tree, batches, engine)
    if engine == "device" and case in SQRT_NEAR_MIDPOINT:
        rows = SQRT_NEAR_MIDPOINT[case]
        assert ulps(gd[rows], want[0][rows]).max() <= 1
        gd = gd.copy()
        gd[rows] = want[0][rows]
    assert_same(gd, gv, *want)


@pytest.mark.parametrize("case", sorted(DIVERGENT))
def test_divergences_pinned(case, batches):
    """The rows where the port follows numpy's libm against the
    reference are exactly the ones listed (each checked by the rule in
    ``assert_same``)."""
    assert _divergent_rows(case, batches) == DIVERGENT[case]


# ---------------------------------------------------------------------------
# Pinned answers: the reference's edge tests, and the subnormal policy
# ---------------------------------------------------------------------------

def _one(expr_of, engine, *cols):
    """The port's expression over (type, values, validity) columns on one
    engine -> (values, validity) lists."""
    n = len(cols[0][1])
    tcols = [(f"c{i}", t, np.asarray(v, tdt.type_named(t).np_dtype),
              np.asarray(ok, np.bool_)) for i, (t, v, ok) in enumerate(cols)]
    refs = [TE.BoundReference(i, tdt.type_named(t), f"c{i}")
            for i, (t, _v, _ok) in enumerate(cols)]
    e = expr_of(*refs)
    if engine == "host":
        hb = host_batch(PORT, tcols)
        c = tbase.as_host_column(e.eval_host(hb), hb)
        return np.asarray(c.data).tolist(), np.asarray(c.validity).tolist()
    tb = device_batch(PORT, tcols, live=n)
    c = tbase.as_device_column(e.eval(tb), tb)
    return c.data.numpy().tolist(), c.validity.numpy().tolist()


ENGINES = ["device", "host"]


@pytest.mark.parametrize("engine", ENGINES)
def test_subnormals_pinned(engine):
    """exp(-740) is subnormal: the device half flushes it to 0.0 (the
    reference's engine does), the host keeps it; a subnormal operand of
    sqrt / log reads as zero on the device only (log: NULL); cbrt keeps
    a subnormal operand on both."""
    x = [-740.0, 1e-310, 1e-310, 1e-310]
    ok = [True] * 4
    got = {name: _one(getattr(TE, name), engine, ("float64", x, ok))
           for name in ("Exp", "Sqrt", "Log", "Cbrt")}
    if engine == "device":
        assert got["Exp"][0][0] == 0.0
        assert got["Sqrt"][0][1] == 0.0
        assert got["Log"][1][1] is False
    else:
        assert 0.0 < got["Exp"][0][0] < 2.3e-308
        assert got["Sqrt"][0][1] == pytest.approx(1e-155)
        assert got["Log"][1][1] is True
    assert got["Cbrt"][0][1] == pytest.approx(4.641588833612779e-104)


@pytest.mark.parametrize("engine", ENGINES)
def test_reference_edges_pinned(engine):
    """The values the reference's own tests pin, on the port's engines:
    HALF_UP and HALF_EVEN rounding, floor/ceil to LONG, the log domain,
    the integer division truncation, Java's shifts and the NaN order of
    least / greatest."""
    f = ("float64", [2.5, -2.5, 1.25, 1.35, 3.5], [True] * 5)
    assert _one(lambda c: TE.Round(c, 0), engine, f)[0] == \
        [3.0, -3.0, 1.0, 1.0, 4.0]
    assert _one(lambda c: TE.BRound(c, 0), engine, f)[0] == \
        [2.0, -2.0, 1.0, 1.0, 4.0]
    assert _one(lambda c: TE.Round(c, 1), engine, f)[0][:4] == \
        pytest.approx([2.5, -2.5, 1.3, 1.4])
    v = 2 ** 60 + 1
    big = ("int64", [v, -v, 125, 25, 35], [True] * 5)
    assert _one(lambda c: TE.Round(c, -1), engine, big)[0] == \
        [1152921504606846980, -1152921504606846980, 130, 30, 40]
    assert _one(lambda c: TE.BRound(c, -1), engine, big)[0] == \
        [1152921504606846980, -1152921504606846980, 120, 20, 40]
    fl = ("float64", [1.5, -1.5, 2.0, np.nan], [True] * 4)
    assert _one(TE.Floor, engine, fl)[0][:3] == [1, -2, 2]
    assert _one(TE.Ceil, engine, fl)[0][:3] == [2, -1, 2]
    lg = _one(TE.Log, engine, ("float64", [np.e, 0.0, -1.0], [True] * 3))
    assert lg[1] == [True, False, False] and lg[0][0] == pytest.approx(1.0)
    a = ("int64", [10, -7, 2 ** 62, I64_MIN, 7, 123456789],
         [True] * 6)
    b = ("int64", [3, 2, 3, -1, 0, -10], [True] * 6)
    q, ok = _one(TE.IntegralDivide, engine, a, b)
    assert q[:4] == [3, -3, 1537228672809129301, I64_MIN] and \
        ok == [True] * 4 + [False, True] and q[5] == -12345678
    n = ("int32", [1, -8, 256, 1], [True] * 4)
    k = ("int32", [3, 1, 33, 0], [True] * 4)
    assert _one(TE.ShiftLeft, engine, n, k)[0] == [8, -16, 512, 1]
    assert _one(TE.ShiftRight, engine, n, k)[0] == [0, -4, 128, 1]
    assert _one(TE.ShiftRightUnsigned, engine, n, k)[0] == \
        [0, 2147483644, 128, 1]
    x = ("float64", [np.nan, np.nan, 1.0, np.inf], [True] * 4)
    y = ("float64", [1.0, np.nan, 2.0, np.nan], [True] * 4)
    lo = _one(TE.Least, engine, x, y)[0]
    hi = _one(TE.Greatest, engine, x, y)[0]
    assert lo[0] == 1.0 and np.isnan(lo[1]) and lo[2:] == [1.0, np.inf]
    assert np.isnan(hi[0]) and np.isnan(hi[1]) and hi[2] == 2.0 \
        and np.isnan(hi[3])


@pytest.mark.parametrize("engine", ENGINES)
def test_at_least_n_non_nulls_pinned(engine):
    """NaN counts as NULL; the result is never NULL."""
    a = ("float64", [1.0, 0.0, np.nan, 2.0], [True, False, True, True])
    b = ("int64", [1, 0, 3, 0], [True, False, True, False])
    for n, want in ((2, [True, False, False, False]),
                    (1, [True, False, True, True]),
                    (0, [True] * 4), (3, [False] * 4)):
        got, ok = _one(lambda *c: TE.AtLeastNNonNulls(n, *c), engine, a, b)
        assert got == want and ok == [True] * 4
