"""Port parity: kernel K1 (stable u32 radix rank) and the sort/grouping
kernels built on it.

On this CPU the port's ``native.stable_argsort_u32`` runs its plain
version (the same digit histograms -> scanned bases -> per-tile counts
summed over earlier tiles -> stable within-tile rank -> scatter steps as
the CUDA kernel). It must be bit-identical to the JAX package's
``native.stable_argsort_u32`` run through the Pallas interpreter
(``native.forced()``) and to ``jnp.argsort(stable=True)``: a stable
permutation is unique. ``_radix_perm``, ``lex_sort_perm`` and
``group_ids`` must match the JAX package's too. The CUDA kernel cannot
run here; its onesweep design (warp match ranks, per-digit status words
published and looked back over in a random interleaving of tiles) is
checked by an emulation in Python against ``torch.sort(stable=True)``.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
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
        torch.from_numpy(keys_u64.astype(np.int64)), tile=tile).numpy()


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
    def boom(keys, perm):
        raise AssertionError("CUDA branch taken for a CPU tensor")
    monkeypatch.setattr(tnative, "_stable_argsort_u32_cuda", boom)
    tnative.reset_counters()
    rng = np.random.default_rng(5)
    tnative.stable_argsort_u32(torch.from_numpy(
        rng.integers(0, 2 ** 32, 300, dtype=np.int64)))
    batch = _pair(["int32"], 40, 1)[1]
    tkernels.group_ids(batch, [0])
    assert tnative.counters() == {"radix_sort": 0, "join_probe": 0,
                                  "seg_reduce": 0, "rle_decode": 0}


def test_cuda_kernel_entry_points_refuse_cpu_tensors():
    k = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tnative.radix_sort(k, None, torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="perm"):
        tnative.radix_sort(k, torch.zeros(8, dtype=torch.int32),
                           torch.zeros(8, dtype=torch.int64))


@pytest.mark.parametrize("cap", [1, 96, 384, 768])
def test_plain_with_perm_is_gather_sort_gather(cap):
    """``perm`` sorts ``keys[perm]`` and maps the order through ``perm``:
    the JAX package's ``_radix_perm`` step (take, stable argsort, take)."""
    rng = np.random.default_rng(cap + 3)
    keys = _mixed_keys(cap, rng)
    perm = rng.permutation(cap).astype(np.int64)
    order = np.asarray(jnp.argsort(jnp.asarray(keys.astype(np.uint32)[perm]),
                                   stable=True))
    want = perm[order]
    for tile in (tnative.TILE_ROWS, 96):
        got = tnative.stable_argsort_u32_plain(
            torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(perm),
            tile=tile)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(want, got.numpy())


# ---------------------------------------------------------------------------
# The CUDA kernel's onesweep design, emulated
# ---------------------------------------------------------------------------

_AGG, _INCL, _COUNT = 1 << 30, 2 << 30, (1 << 30) - 1


def _emulate_pass(keys, vals, shift, base, warps, lanes, items, lookback,
                  rng):
    """One onesweep_pass launch: tiles of warps x lanes x items rows take
    ids in start order; each (tile, digit) thread publishes its
    aggregate, then looks back, in a seeded random interleaving: a step
    reads ``lookback`` status words at once and sums them up to the first
    one not yet published or through the first inclusive one (the
    kernel's kLookBack window), so a thread whose predecessor has
    published nothing yet waits; then it publishes its inclusive
    prefix."""
    n = len(keys)
    tile = warps * lanes * items
    ntiles = -(-n // tile)
    status = [[0] * 256 for _ in range(ntiles)]
    slots, counts = [], []
    for t in range(ntiles):
        cnt = [[0] * 256 for _ in range(warps)]
        slot = {}
        for w in range(warps):
            for j in range(items):           # round j: lanes in row order
                rows = [t * tile + w * lanes * items + j * lanes + lane
                        for lane in range(lanes)]
                digs = [(keys[r] >> shift) & 0xFF if r < n else None
                        for r in rows]
                seen = {}
                for r, d in zip(rows, digs):
                    if d is None:
                        continue
                    slot[r] = (w, d, cnt[w][d] + seen.get(d, 0))
                    seen[d] = seen.get(d, 0) + 1
                for d, c in seen.items():
                    cnt[w][d] += c
        slots.append(slot)
        counts.append(cnt)
    # Actors: one per (tile, digit); tiles start in id order.
    actors, started, done = [], 0, {}
    while len(done) < ntiles * 256:
        if started < ntiles and (not actors or rng.random() < 0.3):
            actors += [[started, d, "agg", started - 1, 0]
                       for d in range(256)]
            started += 1
            continue
        a = actors[rng.integers(len(actors))]
        t, d, phase, p, excl = a
        count = sum(counts[t][w][d] for w in range(warps))
        if phase == "agg":
            if t == 0:
                status[0][d] = _INCL | (base[d] + count)
                done[(t, d)] = base[d]
                actors.remove(a)
            else:
                status[t][d] = _AGG | count
                a[2] = "look"
            continue
        # Tile 0 is always inclusive, so no window reads past it.
        window = [status[q][d] if q >= 0 else _INCL
                  for q in range(p, p - lookback, -1)]
        for s in window:
            if s == 0:
                break                         # spin from here
            excl += s & _COUNT
            p -= 1
            if s & _INCL:
                status[t][d] = _INCL | (excl + count)
                done[(t, d)] = excl
                actors.remove(a)
                break
        a[3], a[4] = p, excl
    out_k, out_v = [None] * n, [None] * n
    for t in range(ntiles):
        for r, (w, d, rank) in slots[t].items():
            pos = done[(t, d)] + sum(counts[t][x][d] for x in range(w)) + rank
            out_k[pos], out_v[pos] = keys[r], vals[r]
    return out_k, out_v


@pytest.mark.parametrize("kind", ["random", "heavy_dups", "zero_one"])
def test_onesweep_design_matches_stable_sort(kind):
    """Tiles of 24 rows (2 warps x 4 lanes x 3 rows), look-back windows of
    3 status words, row counts around tile edges; a 0/1 word has three
    digits of one bucket."""
    rng = np.random.default_rng(len(kind))
    for n in (1, 23, 24, 25, 97, 250):
        if kind == "zero_one":
            keys = rng.integers(0, 2, n, dtype=np.uint64)
        else:
            keys = _keys(kind, n, rng)
        k = [int(x) for x in keys]
        base_keys = torch.from_numpy(keys.astype(np.int64))
        bases = [b.tolist() for b in tnative.digit_bases_plain(base_keys)]
        v = list(range(n))
        for p in range(4):
            k, v = _emulate_pass(k, v, 8 * p, bases[p], warps=2, lanes=4,
                                 items=3, lookback=3, rng=rng)
        want = torch.sort(base_keys, stable=True).indices.numpy()
        np.testing.assert_array_equal(want, np.array(v), err_msg=f"n={n}")


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


@pytest.mark.parametrize("pallas", [True, False])
def test_radix_perm_matches_pallas_path(pallas):
    """``_radix_perm`` (one ``stable_argsort_u32`` call a word, the later
    ones through ``perm``) against the JAX package's (take, argsort,
    take), with its passes on the Pallas kernel or on ``jnp.argsort``."""
    rng = np.random.default_rng(11)
    cap = 384
    passes = [rng.integers(0, 4, cap, dtype=np.uint64),
              _mixed_keys(cap, rng), rng.integers(0, 2 ** 32, cap,
                                                  dtype=np.uint64)]
    with jnative.forced(master=pallas):
        want = np.asarray(jkernels._radix_perm(
            [jnp.asarray(p.astype(np.uint32)) for p in passes], cap))
    got = tkernels._radix_perm(
        [torch.from_numpy(p.astype(np.int64)) for p in passes], cap)
    assert got.dtype == torch.int64
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
    and chip_smoke.py loads neither jax nor the JAX package, nor pyarrow
    or pandas: the port imports those two only inside the functions that
    read, write or call pandas (the card's machine has both)."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import spark_rapids_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax',"
        " 'spark_rapids_tpu', 'pyarrow', 'pandas')]\n"
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
              "profile_query", "plan.logical", "plan.pruning",
              "plan.planner", "api.dataframe", "benchmarks.tpch",
              "ops.base", "ops.aggregate", "columnar.host",
              "columnar.wire", "exprs.base", "exprs.arithmetic",
              "exprs.predicates", "exprs.strings", "exprs.conditional",
              "exprs.datetime", "benchmarks.suites", "wall_compare"):
        assert f"spark_rapids_tpu_torch.{m}" in loaded, m
