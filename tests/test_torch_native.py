"""Port parity: kernel K1 (stable u32 radix rank) and the sort/grouping
kernels built on it.

On this CPU the port's ``native.stable_argsort_u32`` runs its plain
version (the same tile histogram -> scanned offsets -> stable within-tile
rank -> scatter steps as the CUDA kernel). It must be bit-identical to the
JAX package's ``native.stable_argsort_u32`` run through the Pallas
interpreter (``native.forced()``) and to ``jnp.argsort(stable=True)``: a
stable permutation is unique. ``_radix_perm``, ``lex_sort_perm`` and
``group_ids`` must match the JAX package's too.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.ops import kernels as jkernels
from spark_rapids_tpu.ops import native as jnative

from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.ops import kernels as tkernels
from spark_rapids_tpu_torch.ops import native as tnative

# Every branch of the JAX package's _block(): cap <= 512 whole, 512-row
# blocks, 384-row blocks on 3*2^k rungs.
CAPS = [8, 12, 384, 512, 768, 1536, 3072]


def _keys(kind, cap, rng):
    if kind == "random":
        return rng.integers(0, 2 ** 32, cap, dtype=np.uint64)
    if kind == "all_equal":
        return np.full(cap, 0xDEADBEEF, np.uint64)
    if kind == "heavy_dups":
        return rng.choice(np.array([0, 7, 1 << 24, 0xFFFFFFFF], np.uint64),
                          cap)
    if kind == "extremes":
        return rng.choice(np.array([0, 0xFFFFFFFF], np.uint64), cap)
    raise ValueError(kind)


def _mixed_keys(cap, rng):
    """Random keys salted with duplicates, 0 and 0xFFFFFFFF."""
    k = rng.integers(0, 2 ** 32, cap, dtype=np.uint64)
    k[rng.random(cap) < 0.25] = 0xFFFFFFFF
    k[rng.random(cap) < 0.2] = 0
    k[rng.random(cap) < 0.2] = 0x00010203
    return k


def _port_sort(keys_u64, tile=tnative.TILE_ROWS):
    return tnative.stable_argsort_u32_plain(
        torch.from_numpy(keys_u64.astype(np.int64)), tile).numpy()


@pytest.mark.parametrize("cap", CAPS)
def test_plain_matches_pallas_kernel(cap):
    rng = np.random.default_rng(cap)
    keys = _mixed_keys(cap, rng)
    with jnative.forced():
        want = np.asarray(jnative.stable_argsort_u32(
            jnp.asarray(keys.astype(np.uint32))))
    np.testing.assert_array_equal(want, tnative.stable_argsort_u32(
        torch.from_numpy(keys.astype(np.int64))).numpy())
    # Multi-tile decompositions (ragged last tile included) give the same
    # permutation.
    for tile in (96, 256):
        np.testing.assert_array_equal(want, _port_sort(keys, tile))


@pytest.mark.parametrize("kind", ["random", "all_equal", "heavy_dups",
                                  "extremes"])
@pytest.mark.parametrize("cap", CAPS)
def test_plain_matches_stable_argsort(cap, kind):
    rng = np.random.default_rng(cap + 1)
    keys = _keys(kind, cap, rng)
    want = np.asarray(jnp.argsort(jnp.asarray(keys.astype(np.uint32)),
                                  stable=True)).astype(np.int32)
    np.testing.assert_array_equal(want, _port_sort(keys))
    np.testing.assert_array_equal(want, _port_sort(keys, 96))
    oracle = torch.sort(torch.from_numpy(keys.astype(np.int64)),
                        stable=True).indices.numpy()
    np.testing.assert_array_equal(want, oracle)


def test_int32_bit_pattern_keys_sort_unsigned():
    """int32 input is taken as u32 bit patterns: negatives sort last."""
    keys = np.array([5, -1, 0, -2 ** 31, 2 ** 31 - 1, 5], np.int32)
    got = tnative.stable_argsort_u32(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(
        got, np.argsort(keys.view(np.uint32), kind="stable"))


def test_plain_steps_match_numpy():
    rng = np.random.default_rng(0)
    dig = rng.integers(0, 256, 1000)
    tile = 96
    hist = tnative.digit_hist_plain(torch.from_numpy(dig), tile).numpy()
    ntiles = -(-1000 // tile)
    want = np.zeros((256, ntiles), np.int64)
    np.add.at(want, (dig, np.arange(1000) // tile), 1)
    np.testing.assert_array_equal(hist, want.reshape(-1))
    rank = tnative.tile_rank_plain(torch.from_numpy(dig), tile).numpy()
    for i in rng.integers(0, 1000, 50):
        t0 = (i // tile) * tile
        assert rank[i] == np.sum(dig[t0:i] == dig[i])


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        tnative.stable_argsort_u32(torch.zeros((4, 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        tnative.stable_argsort_u32(torch.zeros(8, dtype=torch.float32))
    with pytest.raises(ValueError):
        tnative.stable_argsort_u32(torch.zeros(16, dtype=torch.int64)[::2])


def test_cpu_tensors_never_take_the_cuda_branch(monkeypatch):
    def boom(keys):
        raise AssertionError("CUDA branch taken for a CPU tensor")
    monkeypatch.setattr(tnative, "_stable_argsort_u32_cuda", boom)
    tnative.reset_counters()
    rng = np.random.default_rng(5)
    tnative.stable_argsort_u32(torch.from_numpy(
        rng.integers(0, 2 ** 32, 300, dtype=np.int64)))
    batch = _pair(["int32"], 40, 1)[1]
    tkernels.group_ids(batch, [0])
    assert tnative.counters() == {"digit_hist": 0, "digit_scatter": 0,
                                  "join_probe": 0, "seg_scan": 0,
                                  "rle_decode": 0}


def test_cuda_kernel_entry_points_refuse_cpu_tensors():
    k = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tnative.digit_hist(k, 0, torch.zeros(256, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Sort passes and grouping against the JAX package
# ---------------------------------------------------------------------------

def _arrays(name, n, rng):
    validity = rng.random(n) < 0.85
    lengths = None
    if name == "string":
        lengths = rng.integers(0, 7, n).astype(np.int32)
        data = rng.choice(np.frombuffer(b"abcz\x00\xff", np.uint8),
                          (n, 8)).astype(np.uint8)
        data[np.arange(8)[None, :] >= lengths[:, None]] = 0
    elif name == "float64":
        data = rng.choice(np.array([-0.0, 0.0, 1.5, -2.5, np.inf, -np.inf,
                                    np.nan, 3.0]), n)
    elif name == "float32":
        data = rng.choice(np.array([-0.0, 0.0, 1.5, -2.5, np.inf, np.nan],
                                   np.float32), n)
    elif name == "bool":
        data = rng.random(n) < 0.5
    else:
        t = tdt.type_named(name)
        info = np.iinfo(t.np_dtype)
        data = rng.choice(np.array([info.min, info.max, 0, -1, 1, 7],
                                   np.int64), n).astype(t.np_dtype)
    data = np.where(validity if data.ndim == 1 else validity[:, None],
                    data, np.zeros(1, data.dtype))
    return data, validity, lengths


def _pair(names, n, seed, live=None):
    """The same (cap = n) batch for both engines; ``live`` rows live."""
    rng = np.random.default_rng(seed)
    live = n if live is None else live
    jcols, tcols = [], []
    for name in names:
        data, validity, lengths = _arrays(name, n, rng)
        validity = validity & (np.arange(n) < live)
        jcols.append(jbatch.DeviceColumn(
            jdt.type_named(name), jnp.asarray(data), jnp.asarray(validity),
            None if lengths is None else jnp.asarray(lengths)))
        tcols.append(tbatch.DeviceColumn(
            tdt.type_named(name), torch.from_numpy(data.copy()),
            torch.from_numpy(validity.copy()),
            None if lengths is None else torch.from_numpy(lengths.copy())))
    return (jbatch.DeviceBatch(tuple(jcols), jnp.asarray(live, jnp.int32)),
            tbatch.DeviceBatch(tuple(tcols),
                               torch.tensor(live, dtype=torch.int32)))


SORT_TYPES = ["bool", "int8", "int32", "int64", "float32", "float64",
              "date", "timestamp", "string"]


@pytest.mark.parametrize("name", SORT_TYPES)
@pytest.mark.parametrize("ascending,nulls_first",
                         [(True, True), (False, False), (False, True)])
def test_lex_sort_perm_parity(name, ascending, nulls_first):
    jb, tb = _pair([name, "int32"], 96, SORT_TYPES.index(name), live=80)
    jp, tp = [], []
    for jc, tc in zip(jb.columns, tb.columns):
        jp += jkernels.sort_key_passes(jc, ascending, nulls_first)
        tp += tkernels.sort_key_passes(tc, ascending, nulls_first)
    want = np.asarray(jkernels.lex_sort_perm(jp, jb.row_mask(), 96))
    got = tkernels.lex_sort_perm(tp, tb.row_mask(), 96).numpy()
    np.testing.assert_array_equal(want, got)


def test_radix_perm_words_wrap_around():
    """int64-carried u32 words at the top of the range (sign-bias flips
    of int64 extremes, ~0 words) order as unsigned."""
    vals = np.array([2 ** 63 - 1, -2 ** 63, -1, 0, 1, 2 ** 32, -2 ** 32,
                     2 ** 31, -2 ** 31 - 1, 0xFFFFFFFF], np.int64)
    n = len(vals)
    col_j = jbatch.DeviceColumn(jdt.INT64, jnp.asarray(vals),
                                jnp.ones(n, jnp.bool_))
    col_t = tbatch.DeviceColumn(tdt.INT64, torch.from_numpy(vals),
                                torch.ones(n, dtype=torch.bool))
    for asc in (True, False):
        jw = jkernels.sort_key_passes(col_j, asc, True)
        tw = tkernels.sort_key_passes(col_t, asc, True)
        for a, b in zip(jw, tw):
            np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                          b.numpy())
        want = np.asarray(jkernels._radix_perm(jw, n))
        np.testing.assert_array_equal(want,
                                      tkernels._radix_perm(tw, n).numpy())
    order = vals[tkernels._radix_perm(
        tkernels.sort_key_passes(col_t, True, True), n).numpy()]
    np.testing.assert_array_equal(order, np.sort(vals))


def test_radix_perm_matches_pallas_path():
    rng = np.random.default_rng(11)
    cap = 384
    passes = [rng.integers(0, 4, cap, dtype=np.uint64),
              _mixed_keys(cap, rng), rng.integers(0, 2 ** 32, cap,
                                                  dtype=np.uint64)]
    with jnative.forced():
        want = np.asarray(jkernels._radix_perm(
            [jnp.asarray(p.astype(np.uint32)) for p in passes], cap))
    got = tkernels._radix_perm(
        [torch.from_numpy(p.astype(np.int64)) for p in passes], cap)
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("names,live", [
    (["int32"], 96), (["string"], 70), (["float64"], 96),
    (["string", "string"], 96), (["int64", "float32", "bool"], 50),
    (["date", "timestamp"], 96)])
def test_group_ids_parity(names, live):
    jb, tb = _pair(names, 96, len(names) + live, live=live)
    ordinals = list(range(len(names)))
    jg = jkernels.group_ids(jb, ordinals)
    tg = tkernels.group_ids(tb, ordinals)
    assert int(jg.num_groups) == int(tg.num_groups)
    for field in ("perm", "group_of_sorted", "group_leader"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jg, field)).astype(np.int64),
            getattr(tg, field).numpy(), field)


def test_port_imports_no_jax():
    """A fresh interpreter importing the port, every one of its modules
    and chip_smoke.py loads neither jax nor the JAX package."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import spark_rapids_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'spark_rapids_tpu' or m.startswith('spark_rapids_tpu.')]\n"
        "assert not bad, bad\n"
        "print(' '.join(sorted(m for m in sys.modules"
        " if m.startswith('spark_rapids_tpu_torch'))))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert len(loaded) >= 18
    for m in ("ops.join", "ops.native", "ops.basic", "ops.sort", "entry",
              "profile_query"):
        assert f"spark_rapids_tpu_torch.{m}" in loaded, m
