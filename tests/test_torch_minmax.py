"""Port parity: Min and Max, from ``kernels.segment_reduce`` up to
``HashAggregateExec``, against the JAX package on the CPU.

Tolerance: exact. Min and Max pick one of their inputs, so results must be
bit-identical (the sign of a zero included); NaN compares equal to NaN.
Float sums through ``segment_reduce`` (a scatter-add in both engines, in
different orders) are held to rtol 1e-12.
The JAX package's reductions run under ``native.forced()`` (its Pallas
kernel) where its default path and the kernel differ: subnormals, see
``test_subnormal_minmax_follows_the_kernel``. The aggregate data holds
none, so the execs run on its default path.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu import ops as JO
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.ops import base as jbase
from spark_rapids_tpu.ops import basic as jbasic
from spark_rapids_tpu.ops import kernels as jkernels
from spark_rapids_tpu.ops import native as jnative

from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch import ops as TO
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost
from spark_rapids_tpu_torch.ops import kernels as tkernels


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b and math.copysign(1, a) == math.copysign(1, b)
    return a == b and type(a) is type(b)


def assert_rows_exact(want, got):
    assert len(want) == len(got), (want, got)
    for w, g in zip(want, got):
        assert len(w) == len(g) and all(_same(a, b) for a, b in zip(w, g)), \
            (w, g)


# ---------------------------------------------------------------------------
# segment_reduce: nulls, all-null groups, all-NaN groups, NaN with reals
# ---------------------------------------------------------------------------

def _groups():
    """Nine groups of sorted rows, each a case of Spark's min/max rules."""
    nan, inf = float("nan"), float("inf")
    groups = [
        [(1.5, True), (-2.5, True), (None, False)],       # nulls
        [(None, False), (None, False)],                    # all null
        [(nan, True), (nan, True)],                        # all NaN
        [(nan, True), (3.0, True), (-1.0, True)],          # NaN with reals
        [(nan, True), (None, False)],                      # NaN and null
        [(0.0, True), (-0.0, True)],                       # signed zeros
        [(-0.0, True), (0.0, True)],
        [(inf, True), (-inf, True), (nan, True)],
        [(7.0, True)],
    ]
    vals, valid, gid = [], [], []
    for g, rows in enumerate(groups):
        for v, ok in rows:
            vals.append(0.0 if v is None else v)
            valid.append(ok)
            gid.append(g)
    return (np.array(vals), np.array(valid), np.array(gid, np.int64),
            len(groups))


# Bool sums are never asked for (Sum takes numbers).
REDUCE_CASES = [(d, k) for d in ("float64", "float32", "int64", "int32",
                                 "int8", "bool")
                for k in ("min", "max", "sum") if (d, k) != ("bool", "sum")]


@pytest.mark.parametrize("dtype,kind", REDUCE_CASES)
def test_segment_reduce_matches_reference(dtype, kind):
    vals, valid, gid, ngroups = _groups()
    if dtype == "bool":
        vals = np.nan_to_num(vals) > 0
    elif not dtype.startswith("float"):
        vals = np.nan_to_num(vals, posinf=100, neginf=-100)
    vals = vals.astype(dtype)
    cap = 48
    pad = cap - len(vals)
    vals = np.concatenate([vals, np.zeros(pad, vals.dtype)])
    valid = np.concatenate([valid, np.zeros(pad, bool)])
    gid = np.concatenate([gid, np.full(pad, cap - 1, np.int64)])
    with jnative.forced():
        jagg, jcnt = jkernels.segment_reduce(
            jnp.asarray(vals), jnp.asarray(valid),
            jnp.asarray(gid.astype(np.int32)), cap, kind)
    tagg, tcnt = tkernels.segment_reduce(
        torch.from_numpy(vals.copy()), torch.from_numpy(valid.copy()),
        torch.from_numpy(gid), cap, kind)
    want, got = np.asarray(jagg)[:ngroups], tagg.numpy()[:ngroups]
    assert want.dtype == got.dtype
    if dtype.startswith("float") and kind == "sum":
        # A scatter-add in both engines, each in its own order of addition.
        np.testing.assert_allclose(got, want, rtol=1e-12, equal_nan=True)
    else:
        if dtype.startswith("float"):
            nan = np.isnan(want)
            np.testing.assert_array_equal(nan, np.isnan(got))
            want, got = want[~nan], got[~nan]
        np.testing.assert_array_equal(want.view(np.uint8),
                                      got.view(np.uint8))
    np.testing.assert_array_equal(np.asarray(jcnt)[:ngroups],
                                  tcnt.numpy()[:ngroups])


def test_subnormal_minmax_follows_the_kernel():
    """The JAX package disagrees with itself on subnormal min/max: its
    default ``jax.ops.segment_min``/``max`` on XLA:CPU flushes them, its
    Pallas kernel (``native.forced()``) orders bit patterns. The port's
    kernel K2 is the Pallas kernel's counterpart and does not flush."""
    vals = np.array([0.0, -0.0, 1e-310, -1e-310, 5e-324, 0.0, 3.0, 1e-310])
    gid = np.repeat(np.arange(4), 2).astype(np.int64)
    valid = np.ones(8, bool)
    out = {}
    for kind in ("min", "max"):
        args = (jnp.asarray(vals), jnp.asarray(valid),
                jnp.asarray(gid.astype(np.int32)), 4, kind)
        default = np.asarray(jkernels.segment_reduce(*args)[0])
        with jnative.forced():
            forced = np.asarray(jkernels.segment_reduce(*args)[0])
        port = tkernels.segment_reduce(
            torch.from_numpy(vals), torch.from_numpy(valid),
            torch.from_numpy(gid), 4, kind)[0].numpy()
        np.testing.assert_array_equal(forced.view(np.uint64),
                                      port.view(np.uint64))
        out[kind] = (default, forced)
    bits = np.array([-0.0, -1e-310, 0.0, 1e-310]).view(np.uint64)
    np.testing.assert_array_equal(out["min"][1].view(np.uint64), bits)
    np.testing.assert_array_equal(
        out["max"][1].view(np.uint64),
        np.array([0.0, 1e-310, 5e-324, 3.0]).view(np.uint64))
    # The JAX default path, recorded: subnormals flushed to signed zeros.
    np.testing.assert_array_equal(
        out["min"][0].view(np.uint64),
        np.array([-0.0, -0.0, 0.0, 0.0]).view(np.uint64))
    np.testing.assert_array_equal(
        out["max"][0].view(np.uint64),
        np.array([0.0, 0.0, 0.0, 3.0]).view(np.uint64))


# ---------------------------------------------------------------------------
# HashAggregateExec with Min/Max
# ---------------------------------------------------------------------------

def _data(seed):
    rng = np.random.default_rng(seed)
    n = 200
    k = rng.integers(0, 6, n)
    f = rng.choice(np.array([1.5, -2.5, 0.0, -0.0, np.nan, np.inf, -np.inf,
                             40.25]), n)
    strs = ["", "a", "ab", "b", "abc", "zz", "é", "日本"]
    return {
        "k": [int(v) for v in k],
        "s": [None if i % 9 == 0 else strs[v]
              for i, v in enumerate(rng.integers(0, len(strs), n))],
        "i": [None if i % 7 == 0 else int(v) for i, v in
              enumerate(rng.integers(-2 ** 63, 2 ** 63 - 1, n,
                                     dtype=np.int64))],
        "f": [None if i % 11 == 0 else float(v) for i, v in enumerate(f)],
        "d": [None if i % 5 == 0 else int(v) for i, v in
              enumerate(rng.integers(-20_000, 20_000, n))],
        # Group 5 of k has no valid "g" at all: an all-null group.
        "g": [None if kk == 5 or i % 3 == 0 else float(v) for i, (kk, v)
              in enumerate(zip(k, rng.normal(0, 10, n)))],
    }


def _schema(D):
    return (("k", D.INT32), ("s", D.STRING), ("i", D.INT64),
            ("f", D.FLOAT64), ("d", D.DATE), ("g", D.FLOAT32))


def _plan(E_, O, D, Src, parts, keys, mode_chain, **src_kw):
    R = E_.BoundReference
    src = Src(_schema(D), [[b] for b in parts], **src_kw)
    key_cols = {"k": [("k", R(0, D.INT32))],
                "s": [("s", R(1, D.STRING))],
                "none": []}[keys]
    aggs = [O.AggSpec("min_f", O.Min(R(3, D.FLOAT64))),
            O.AggSpec("max_f", O.Max(R(3, D.FLOAT64))),
            O.AggSpec("min_i", O.Min(R(2, D.INT64))),
            O.AggSpec("max_i", O.Max(R(2, D.INT64))),
            O.AggSpec("min_d", O.Min(R(4, D.DATE))),
            O.AggSpec("max_g", O.Max(R(5, D.FLOAT32))),
            O.AggSpec("min_s", O.Min(R(1, D.STRING))),
            O.AggSpec("max_s", O.Max(R(1, D.STRING))),
            O.AggSpec("n", O.Count(R(3, D.FLOAT64)))]
    if mode_chain == "complete":
        return O.HashAggregateExec(src, key_cols, aggs, mode="complete")
    partial = O.HashAggregateExec(src, key_cols, aggs, mode="partial")
    coal = (jbasic if O is JO else TO).CoalescePartitionsExec(partial, 1)
    fkeys = [(n, R(i, e.data_type())) for i, (n, e) in enumerate(key_cols)]
    return O.HashAggregateExec(coal, fkeys, aggs, mode="final")


def _run_both(keys, chain, datas, numeric_only=False):
    jparts = [jhost.HostBatch.from_pydict(_schema(jdt), d) for d in datas]
    tparts = [thost.HostBatch.from_pydict(_schema(tdt), d) for d in datas]
    jplan = _plan(JE, JO, jdt, jbase.InMemorySourceExec, jparts, keys, chain)
    tplan = _plan(TE, TO, tdt, TO.InMemorySourceExec, tparts, keys, chain,
                  device="cpu")
    if numeric_only:    # the zero-key global path, strings left out
        for p in (jplan, tplan):
            p.aggs = p.aggs[:6] + p.aggs[8:]
            if chain != "complete":
                p.children[0].children[0].aggs = p.aggs
    return jplan.collect(), tplan.collect()


@pytest.mark.parametrize("keys", ["k", "s", "none"])
@pytest.mark.parametrize("chain", ["complete", "partial_final"])
def test_minmax_aggregate_matches_reference(keys, chain):
    """Keyed (int and string keys) and zero-key, numeric and string
    Min/Max, with a Count riding the cumsum path beside them."""
    want, got = _run_both(keys, chain, [_data(s) for s in (1, 2, 3)])
    assert len(got) > 1 if keys != "none" or chain == "complete" \
        else len(got) == 1
    assert_rows_exact(want, got)


@pytest.mark.parametrize("chain", ["complete", "partial_final"])
def test_zero_key_numeric_minmax_takes_the_global_path(chain):
    want, got = _run_both("none", chain, [_data(s) for s in (4, 5)],
                          numeric_only=True)
    assert_rows_exact(want, got)


def test_global_ok_refuses_string_minmax():
    R = TE.BoundReference
    src = TO.InMemorySourceExec(_schema(tdt), [[]], device="cpu")
    num = TO.HashAggregateExec(src, [], [TO.AggSpec(
        "m", TO.Min(R(3, tdt.FLOAT64)))])
    strs = TO.HashAggregateExec(src, [], [TO.AggSpec(
        "m", TO.Max(R(1, tdt.STRING)))])
    assert num._global_ok and not strs._global_ok


def test_zero_key_minmax_over_no_rows_is_null():
    R = TE.BoundReference
    src = TO.InMemorySourceExec(_schema(tdt), [[]], device="cpu")
    agg = TO.HashAggregateExec(src, [], [
        TO.AggSpec("n", TO.CountStar(None)),
        TO.AggSpec("m", TO.Min(R(3, tdt.FLOAT64))),
        TO.AggSpec("s", TO.Max(R(1, tdt.STRING)))])
    assert agg.collect() == [(0, None, None)]
