"""Port parity: the expressions of the q1 path (``<=`` on DATE; ``-``,
``*``, ``+`` on f64 with literals and nulls) and the rest of the ported
predicate family evaluate exactly as the JAX package's ``eval``.

Both engines get the same numpy columns; results compare buffer for
buffer (data under dead rows zeroed, validity).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.exprs import base as jbase

from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.exprs import base as tbase

CAP = 64
LIVE = 53


def _batches(seed=0):
    """[date, f64, f64, i64, i32, string, bool] with nulls and a dead
    tail, for both engines."""
    rng = np.random.default_rng(seed)
    cols = []
    date = rng.integers(10_400, 10_500, CAP).astype(np.int32)
    f1 = rng.choice(np.array([0.0, -0.0, 0.05, 0.1, np.nan, np.inf, 17.25,
                              -3.5]), CAP)
    f2 = np.round(rng.uniform(900.0, 105_000.0, CAP), 2)
    i64 = rng.integers(-2 ** 62, 2 ** 62, CAP)
    i64[:3] = [2 ** 63 - 1, -2 ** 63, 45]
    i32 = rng.integers(-50, 50, CAP).astype(np.int32)
    lens = rng.integers(0, 4, CAP).astype(np.int32)
    s = rng.choice(np.frombuffer(b"ANRab", np.uint8), (CAP, 8)) \
        .astype(np.uint8)
    s[np.arange(8)[None, :] >= lens[:, None]] = 0
    b = rng.random(CAP) < 0.5
    for name, data, lengths in [("date", date, None), ("float64", f1, None),
                                ("float64", f2, None), ("int64", i64, None),
                                ("int32", i32, None), ("string", s, lens),
                                ("bool", b, None)]:
        valid = (rng.random(CAP) < 0.8) & (np.arange(CAP) < LIVE)
        data = np.where(valid if data.ndim == 1 else valid[:, None], data,
                        np.zeros(1, data.dtype))
        if lengths is not None:
            lengths = np.where(valid, lengths, 0).astype(np.int32)
        cols.append((name, data, valid, lengths))
    jb = jbatch.DeviceBatch(tuple(
        jbatch.DeviceColumn(jdt.type_named(n), jnp.asarray(d),
                            jnp.asarray(v),
                            None if l is None else jnp.asarray(l))
        for n, d, v, l in cols), jnp.asarray(LIVE, jnp.int32))
    tb = tbatch.DeviceBatch(tuple(
        tbatch.DeviceColumn(tdt.type_named(n), torch.from_numpy(d.copy()),
                            torch.from_numpy(v.copy()),
                            None if l is None else torch.from_numpy(l.copy()))
        for n, d, v, l in cols), torch.tensor(LIVE, dtype=torch.int32))
    return jb, tb


def _tree(M, which):
    """The same expression tree over module namespace ``M`` (the JAX
    package's exprs or the port's)."""
    D = jdt if M is JE else tdt
    R = M.BoundReference
    date, f1, f2 = R(0, D.DATE), R(1, D.FLOAT64), R(2, D.FLOAT64)
    i64, i32, s, b = (R(3, D.INT64), R(4, D.INT32), R(5, D.STRING),
                      R(6, D.BOOL))
    one = M.lit(1.0)
    trees = {
        # q1's filter and projections
        "shipdate_le": M.LessThanOrEqual(date, M.Literal(D.DATE, 10_450)),
        "one_minus_disc": M.Subtract(one, f1),
        "disc_price": M.Multiply(f2, M.Subtract(one, f1)),
        "charge": M.Multiply(M.Multiply(f2, M.Subtract(one, f1)),
                             M.Add(one, f1)),
        "null_literal": M.Add(f1, M.Literal(D.FLOAT64, None)),
        # entry()'s filter: widening int64 <= int32 literal
        "qty_le_45": M.LessThanOrEqual(i64, M.lit(45)),
        "int_wrap": M.Add(M.Multiply(i64, i64), i32),
        "int_widen": M.Subtract(i32, i64),
        "f_lt_nan": M.LessThan(f1, f2),
        "f_eq": M.EqualTo(f1, M.lit(0.0)),
        "f_gt": M.GreaterThan(f1, M.lit(0.05)),
        "f_ge": M.GreaterThanOrEqual(f1, f1),
        "str_eq": M.EqualTo(s, M.lit("N")),
        "str_lt": M.LessThan(s, M.lit("NA")),
        "null_safe": M.EqualNullSafe(f1, f1),
        "and": M.And(M.LessThan(i32, M.lit(0)), b),
        "or": M.Or(M.LessThan(i32, M.lit(0)), b),
        "not": M.Not(b),
        "is_null": M.IsNull(f1),
        "is_not_null": M.IsNotNull(s),
    }
    return trees[which]


EXPRS = ["shipdate_le", "one_minus_disc", "disc_price", "charge",
         "null_literal", "qty_le_45", "int_wrap", "int_widen", "f_lt_nan",
         "f_eq", "f_gt", "f_ge", "str_eq", "str_lt", "null_safe", "and",
         "or", "not", "is_null", "is_not_null"]


@pytest.mark.parametrize("which", EXPRS)
def test_eval_matches_reference(which):
    jb, tb = _batches()
    jc = jbase.as_device_column(_tree(JE, which).eval(jb), jb)
    tc = tbase.as_device_column(_tree(TE, which).eval(tb), tb)
    assert jc.dtype.name == tc.dtype.name
    want = np.asarray(jc.data)
    got = tc.data.numpy()
    assert want.dtype == got.dtype
    np.testing.assert_array_equal(want.view(np.uint8) if want.dtype != bool
                                  else want,
                                  got.view(np.uint8) if got.dtype != bool
                                  else got)
    np.testing.assert_array_equal(np.asarray(jc.validity),
                                  tc.validity.numpy())


@pytest.mark.parametrize("value", [45, 1.0, "RA", None])
def test_scalar_expansion_matches_reference(value):
    jb, tb = _batches(1)
    jt = jbase.lit(value, jdt.INT32 if value is None else None)
    tt = tbase.lit(value, tdt.INT32 if value is None else None)
    jc = jbase.as_device_column(jt.eval(jb), jb)
    tc = tbase.as_device_column(tt.eval(tb), tb)
    np.testing.assert_array_equal(np.asarray(jc.data), tc.data.numpy())
    np.testing.assert_array_equal(np.asarray(jc.validity),
                                  tc.validity.numpy())
    if jc.lengths is not None:
        np.testing.assert_array_equal(np.asarray(jc.lengths),
                                      tc.lengths.numpy())


# ---------------------------------------------------------------------------
# Subnormal doubles: the reference (XLA:CPU) flushes them to a zero of
# their sign in its comparisons and its f64 sort order.
# ---------------------------------------------------------------------------

SUBNORMALS = [1e-310, -0.0, -1e-310, 0.0, 5e-324]


def _subnormal_batches():
    n = len(SUBNORMALS)
    data = np.array(SUBNORMALS, np.float64)
    rows = np.arange(n, dtype=np.int64)
    ones = np.ones(n, bool)
    jb = jbatch.DeviceBatch(
        (jbatch.DeviceColumn(jdt.FLOAT64, jnp.asarray(data),
                             jnp.asarray(ones)),
         jbatch.DeviceColumn(jdt.INT64, jnp.asarray(rows),
                             jnp.asarray(ones))), jnp.asarray(n, jnp.int32))
    tb = tbatch.DeviceBatch(
        (tbatch.DeviceColumn(tdt.FLOAT64, torch.from_numpy(data.copy()),
                             torch.from_numpy(ones.copy())),
         tbatch.DeviceColumn(tdt.INT64, torch.from_numpy(rows.copy()),
                             torch.from_numpy(ones.copy()))),
        torch.tensor(n, dtype=torch.int32))
    return jb, tb


@pytest.mark.parametrize("ascending", [True, False])
def test_subnormal_double_sort_matches_reference(ascending):
    from spark_rapids_tpu.ops import sort as jsort
    from spark_rapids_tpu_torch.ops import sort as tsort
    jb, tb = _subnormal_batches()
    jo = jsort.sort_batch(jb, [jsort.SortOrder(
        JE.BoundReference(0, jdt.FLOAT64), ascending)])
    to = tsort.sort_batch(tb, [tsort.SortOrder(
        TE.BoundReference(0, tdt.FLOAT64), ascending)])
    want = np.asarray(jo.columns[1].data)
    np.testing.assert_array_equal(want, to.columns[1].data.numpy())
    # Measured on the reference: a subnormal sorts as the zero of its sign
    # and ties keep their order.
    assert want.tolist() == ([1, 2, 0, 3, 4] if ascending
                             else [0, 3, 4, 1, 2])


@pytest.mark.parametrize("cmp", ["LessThan", "EqualTo",
                                 "GreaterThanOrEqual"])
def test_subnormal_double_comparisons_match_reference(cmp):
    jb, tb = _subnormal_batches()
    je = getattr(JE, cmp)(JE.BoundReference(0, jdt.FLOAT64), JE.lit(0.0))
    te = getattr(TE, cmp)(TE.BoundReference(0, tdt.FLOAT64), TE.lit(0.0))
    want = np.asarray(jbase.as_device_column(je.eval(jb), jb).data)
    got = tbase.as_device_column(te.eval(tb), tb).data.numpy()
    np.testing.assert_array_equal(want, got)


# ---------------------------------------------------------------------------
# String needle ops (Contains, StartsWith, EndsWith)
# ---------------------------------------------------------------------------

NEEDLE_WORDS = ["", "a", "ab", "abab", "BRASS", "LARGE BRASS", "é", "日本",
                "xé日", "aé"]


def _string_batches(seed):
    """One string column (width 12, UTF-8 with multibyte characters, empty
    strings, nulls and a dead tail) for both engines."""
    rng = np.random.default_rng(seed)
    words = [w.encode() for w in NEEDLE_WORDS] + [b"abab\xc3\xa9", b"BRASS"]
    picked = [words[i] for i in rng.integers(0, len(words), CAP)]
    lens = np.array([len(w) for w in picked], np.int32)
    data = np.zeros((CAP, 12), np.uint8)
    for i, w in enumerate(picked):
        data[i, :len(w)] = np.frombuffer(w, np.uint8)
    valid = (rng.random(CAP) < 0.85) & (np.arange(CAP) < LIVE)
    data = np.where(valid[:, None], data, 0).astype(np.uint8)
    lens = np.where(valid, lens, 0).astype(np.int32)
    jb = jbatch.DeviceBatch((jbatch.DeviceColumn(
        jdt.STRING, jnp.asarray(data), jnp.asarray(valid),
        jnp.asarray(lens)),), jnp.asarray(LIVE, jnp.int32))
    tb = tbatch.DeviceBatch((tbatch.DeviceColumn(
        tdt.STRING, torch.from_numpy(data.copy()),
        torch.from_numpy(valid.copy()), torch.from_numpy(lens.copy())),),
        torch.tensor(LIVE, dtype=torch.int32))
    return jb, tb


@pytest.mark.parametrize("op", ["Contains", "StartsWith", "EndsWith"])
@pytest.mark.parametrize("needle", [
    "", "a", "ab", "BRASS", "é", "日本", "abé", "wider than the matrix",
    None])
def test_needle_ops_match_reference(op, needle):
    """Empty needle, a needle wider than the byte matrix, a NULL literal
    and multibyte UTF-8, through the JAX package's ``eval`` and the
    port's."""
    jb, tb = _string_batches(len(needle or "") + len(op))
    jnl = jbase.Literal(jdt.STRING, needle)
    tnl = tbase.Literal(tdt.STRING, needle)
    jc = getattr(JE, op)(JE.BoundReference(0, jdt.STRING), jnl).eval(jb)
    tc = getattr(TE, op)(TE.BoundReference(0, tdt.STRING), tnl).eval(tb)
    np.testing.assert_array_equal(np.asarray(jc.data), tc.data.numpy())
    np.testing.assert_array_equal(np.asarray(jc.validity),
                                  tc.validity.numpy())
    if needle == "ab":      # the inputs do hit: the check is not vacuous
        assert tc.data.any() and not tc.data.all()
