"""Port parity: kernel K2 (the sorted-segment reduce) and the segmented
reductions built on it.

On this CPU the plain version's running scan, ``native.segscan_plain`` (a
Hillis-Steele scan over the (flag, value) monoid), must be bit-identical
to the JAX package's Pallas ``_segscan`` run through the Pallas interpreter
(``native.forced()``), for every kind (sum32, sum64 wrap-around, min and
max over u32 and u64 keys), and ``segment_sum_sorted`` /
``segment_minmax_sorted`` must equal the JAX package's over the whole dtype
ladder. The CUDA kernel cannot run here; its single-pass design (fill
blocks publishing chunk flags, tile scans with warp-shuffle scans inside,
segment ends writing their slots over the fill, tile aggregates and
inclusive values published and looked back over, all blocks in a random
interleaving) is checked by an emulation in Python against the plain
version, at tiny tile sizes that exercise every branch.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.ops import native as jnative

from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.ops import native as tnative

# The JAX package's _block(): whole (<= 512), 512-row blocks, and 384-row
# blocks on 3*2^k rungs.
CAPS = [8, 512, 1536, 3072]


def _segments(cap, rng):
    """Nondecreasing group ids: random runs of 1..64 rows, then one-row
    segments, then one long run to the end."""
    lens = []
    while sum(lens) < cap // 2:
        lens.append(int(rng.integers(1, 65)))
    lens += [1] * (cap // 8)
    gid = np.repeat(np.arange(len(lens)), lens)[:cap]
    tail = cap - len(gid)
    return np.concatenate([gid, np.full(tail, len(lens), np.int64)]) \
        .astype(np.int64)


def _keys(cap, bits, rng):
    """Full-range unsigned keys with the extremes salted in."""
    hi = (1 << bits) - 1
    k = rng.integers(0, hi, cap, dtype=np.uint64, endpoint=True)
    k[rng.random(cap) < 0.1] = hi
    k[rng.random(cap) < 0.1] = 0
    k[rng.random(cap) < 0.05] = 1 << (bits - 1)
    return k


def _port_keys(k, bits):
    return torch.from_numpy(k.astype(np.uint32).view(np.int32).copy()
                            if bits == 32 else k.view(np.int64).copy())


def _jax_planes(k, bits):
    if bits == 32:
        return jnp.asarray(k.astype(np.uint32)[:, None])
    return jnp.asarray(np.stack([(k >> np.uint64(32)).astype(np.uint32),
                                 (k & np.uint64(0xFFFFFFFF))
                                 .astype(np.uint32)], axis=1))


def _from_jax(out, bits):
    out = np.asarray(out)
    if bits == 32:
        return out[:, 0].astype(np.uint64)
    return (out[:, 0].astype(np.uint64) << np.uint64(32)) | \
        out[:, 1].astype(np.uint64)


def _neutral(kind, bits):
    """The Pallas kernel's identity planes: its fill before a block's
    first row and its first carry, so it must be the kind's neutral
    element (all ones for unsigned min, 0 otherwise)."""
    return (0xFFFFFFFF if kind == "min" else 0,) * (bits // 32)


def _to_unsigned(t, bits):
    return t.numpy().view(np.uint32).astype(np.uint64) if bits == 32 \
        else t.numpy().view(np.uint64)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_segscan_plain_matches_pallas_kernel(kind, bits, cap):
    rng = np.random.default_rng(cap + bits)
    gid = _segments(cap, rng)
    k = _keys(cap, bits, rng)
    flags = np.concatenate([[1], gid[1:] != gid[:-1]]).astype(np.int32)
    jkind = f"sum{bits}" if kind == "sum" else kind
    with jnative.forced():
        want = _from_jax(jnative._segscan(jnp.asarray(flags),
                                          _jax_planes(k, bits), jkind,
                                          _neutral(kind, bits)), bits)
    got = tnative.segscan_plain(torch.from_numpy(gid), _port_keys(k, bits),
                                kind)
    np.testing.assert_array_equal(want, _to_unsigned(got, bits))
    if kind == "sum":       # the keys are full-range: sums do wrap
        assert (want < k).any()


@pytest.mark.parametrize("shape", ["one_row_segments", "one_segment"])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_segscan_plain_extreme_segmentations(kind, shape):
    cap, bits = 1536, 64
    rng = np.random.default_rng(7)
    gid = np.arange(cap, dtype=np.int64) if shape == "one_row_segments" \
        else np.zeros(cap, np.int64)
    k = _keys(cap, bits, rng)
    flags = np.concatenate([[1], gid[1:] != gid[:-1]]).astype(np.int32)
    jkind = "sum64" if kind == "sum" else kind
    with jnative.forced():
        want = _from_jax(jnative._segscan(jnp.asarray(flags),
                                          _jax_planes(k, bits), jkind,
                                          _neutral(kind, bits)), bits)
    got = tnative.segscan_plain(torch.from_numpy(gid), _port_keys(k, bits),
                                kind)
    np.testing.assert_array_equal(want, _to_unsigned(got, bits))
    if shape == "one_row_segments":
        np.testing.assert_array_equal(want, k)


# ---------------------------------------------------------------------------
# segment_sum_sorted / segment_minmax_sorted over the dtype ladder
# ---------------------------------------------------------------------------

LADDER = ["bool", "int8", "int16", "int32", "int64", "date", "timestamp",
          "float32", "float64"]


def _values(name, cap, rng):
    np_dtype = tdt.type_named(name).np_dtype
    if name == "bool":
        return rng.random(cap) < 0.5
    if np.issubdtype(np_dtype, np.floating):
        fi = np.finfo(np_dtype)
        pool = np.array([-0.0, 0.0, 1.5, -2.5, np.inf, -np.inf, fi.max,
                         -fi.max, fi.tiny, -fi.tiny, fi.smallest_subnormal,
                         -fi.smallest_subnormal, 3.0], np_dtype)
        return rng.choice(pool, cap)
    info = np.iinfo(np_dtype)
    v = rng.integers(info.min, info.max, cap, dtype=np_dtype, endpoint=True)
    v[rng.random(cap) < 0.2] = info.max
    v[rng.random(cap) < 0.2] = info.min
    return v


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("name", LADDER)
def test_segment_sorted_match_pallas_path(name, kind):
    cap = 1536
    rng = np.random.default_rng(LADDER.index(name))
    gid = _segments(cap, rng)
    v = _values(name, cap, rng)
    # Capacity past the last group: empty slots get the identity fill.
    capacity = cap
    jv, jg = jnp.asarray(v), jnp.asarray(gid.astype(np.int32))
    tv, tg = torch.from_numpy(v.copy()), torch.from_numpy(gid)
    with jnative.forced():
        if kind == "sum":
            want = jnative.segment_sum_sorted(jv, jg, capacity)
        else:
            want = jnative.segment_minmax_sorted(jv, jg, capacity, kind)
    if kind == "sum":
        got = tnative.segment_sum_sorted(tv, tg, capacity)
    else:
        got = tnative.segment_minmax_sorted(tv, tg, capacity, kind)
    if want is None:        # float and bool sums stay off the exact path
        assert got is None
        return
    want = np.asarray(want)
    got = got.numpy()
    assert want.dtype == got.dtype
    np.testing.assert_array_equal(want.view(np.uint8), got.view(np.uint8))
    assert gid[-1] + 1 < capacity      # some slots are empty


def test_encoded_identity_decodes_to_segment_fill():
    """An empty group decodes to ``jax.ops.segment_min``/``max``'s fill:
    the dtype's max/min, +/-inf for floats."""
    for name in LADDER:
        np_dtype = tdt.type_named(name).np_dtype
        for kind in ("min", "max"):
            t = torch.from_numpy(np.zeros(1, np_dtype))
            _, dec = tnative._minmax_encode(t)
            ident = tnative._encoded_identity(t.dtype, kind)
            key = torch.tensor([ident], dtype=torch.int32
                               if t.element_size() <= 4 or name == "bool"
                               else torch.int64)
            got = dec(key).numpy()[0]
            if np.issubdtype(np_dtype, np.floating):
                want = np.inf if kind == "min" else -np.inf
            elif name == "bool":
                want = kind == "min"
            else:
                info = np.iinfo(np_dtype)
                want = info.max if kind == "min" else info.min
            assert got == want, (name, kind, got)


# ---------------------------------------------------------------------------
# The CUDA kernel's single-pass design, emulated
# ---------------------------------------------------------------------------

def _op(kind, a, b, mask):
    if kind == "sum":
        return (a + b) & mask
    return min(a, b) if kind == "min" else max(a, b)


def _combine(kind, mask, p, x):
    """(pg, pv) + (g, v): p precedes x."""
    (pg, pv), (g, v) = p, x
    return (pg | g, v if g else _op(kind, pv, v, mask))


def _block_exclusive(aggs, lanes, kind, mask, neutral):
    """The kernel's block_exclusive: a shuffle-up inclusive scan inside
    each warp of ``lanes`` threads (every lane reads the values from
    before the step), the warp totals combined in order, each thread's
    exclusive prefix."""
    n = len(aggs)
    inc = list(aggs)
    d = 1
    while d < lanes:
        inc = [_combine(kind, mask, inc[t - d], inc[t]) if t % lanes >= d
               else inc[t] for t in range(n)]
        d *= 2
    out = []
    for t in range(n):
        exc = (0, neutral) if t % lanes == 0 else inc[t - 1]
        pre = (0, neutral)
        for w in range(t // lanes):
            pre = _combine(kind, mask, pre, inc[w * lanes + lanes - 1])
        out.append(_combine(kind, mask, pre, exc))
    return out


_AGG, _INCL = 1, 2


def _fill_steps(c, chunk, capacity, identity, flags, out):
    """A fill block: identity over its chunk of slots, then its flag."""
    for g in range(c * chunk, min((c + 1) * chunk, capacity)):
        out[g] = identity
    yield
    flags[c] = 1


def _tile_steps(t, gid, keys, kind, mask, neutral, capacity, chunk,
                threads, items, lanes, flags, status, agg_v, incl_v, out,
                results):
    """One seg_reduce tile block as a generator: it yields while it waits
    on a fill flag or spins on a predecessor's status. Only segment ends
    write ``out``, each slot once, over the fill."""
    n = len(keys)
    tile = threads * items
    base = t * tile
    last_row = min(base + tile, n) - 1
    lo, hi = max(gid[base], 0), min(gid[last_row], capacity - 1)
    for c in range(lo // chunk, hi // chunk + 1) if lo <= hi else ():
        while not flags[c]:
            yield

    def write(g, v):
        if 0 <= g < capacity:
            assert out[g] is not None, "a result before its chunk's fill"
            assert g not in results, "a slot written twice"
            results.add(g)
            out[g] = v

    aggs, opens = [], []
    for th in range(threads):
        seen, run, open_end = 0, neutral, None
        for j in range(items):
            r = base + th * items + j
            if r >= n:
                continue
            if r == 0 or gid[r - 1] != gid[r]:
                run, seen = keys[r], 1
            else:
                run = _op(kind, run, keys[r], mask)
            if r == n - 1 or gid[r + 1] != gid[r]:
                if seen:
                    write(gid[r], run)
                else:
                    open_end = (gid[r], run)
        aggs.append((seen, run))
        opens.append(open_end)
    pre = _block_exclusive(aggs, lanes, kind, mask, neutral)
    for (g, pv), open_end in zip(pre, opens):
        if open_end is not None and g:
            write(open_end[0], _op(kind, pv, open_end[1], mask))
    tile_g, tile_v = _combine(kind, mask, pre[-1], aggs[-1])
    if tile_g:
        incl_v[t], status[t] = tile_v, _INCL
    else:
        agg_v[t], status[t] = tile_v, _AGG
    yield
    if base == 0 or gid[base - 1] != gid[base]:
        return
    acc, p = neutral, t - 1
    while True:                     # one window of ``lanes`` statuses
        window = [status[q] if q >= 0 else _INCL
                  for q in range(p, p - lanes, -1)]
        take = 0
        for s in window:
            if s == 0:
                break
            take += 1
            if s == _INCL:
                break
        for q, s in zip(range(p, p - take, -1), window):
            acc = _op(kind, incl_v[q] if s == _INCL else agg_v[q], acc,
                      mask)
        if take and window[take - 1] == _INCL:
            break
        p -= take
        yield                                       # spin or move on
    if not tile_g:
        incl_v[t], status[t] = _op(kind, acc, tile_v, mask), _INCL
    for (g, pv), open_end in zip(pre, opens):
        if open_end is not None and not g:
            write(open_end[0], _op(kind, _op(kind, acc, pv, mask),
                                   open_end[1], mask))


def _emulate_seg_reduce(gid, keys, kind, bits, capacity, identity, threads,
                        items, lanes, chunk, rng):
    """seg_reduce's blocks taking ids in start order (fill chunks first,
    then tiles) and stepping in a seeded random interleaving; every slot
    must be written."""
    mask = (1 << bits) - 1
    neutral = mask if kind == "min" else 0
    ntiles = -(-len(keys) // (threads * items))
    nchunks = -(-capacity // chunk)
    flags = [0] * nchunks
    status, agg_v, incl_v = [0] * ntiles, [None] * ntiles, [None] * ntiles
    out, results = [None] * capacity, set()
    running, started = [], 0
    while started < nchunks + ntiles or running:
        if started < nchunks + ntiles and (not running
                                           or rng.random() < 0.4):
            if started < nchunks:
                running.append(_fill_steps(started, chunk, capacity,
                                           identity & mask, flags, out))
            else:
                running.append(_tile_steps(
                    started - nchunks, gid, keys, kind, mask, neutral,
                    capacity, chunk, threads, items, lanes, flags, status,
                    agg_v, incl_v, out, results))
            started += 1
            continue
        block = running[rng.integers(len(running))]
        if next(block, StopIteration) is StopIteration:
            running.remove(block)
    assert None not in out, "a slot left unwritten"
    return out


def _design_cases(n, rng):
    """(shape, gid, capacity): random runs, one-row segments, one segment
    over every tile, a long middle run, a dead-row tail at cap - 1, and
    capacities below, at and past the largest id."""
    g_rand = np.sort(rng.integers(0, max(n // 4, 1), n))
    live = n - n // 3
    g_dead = np.concatenate([np.sort(rng.integers(0, max(live // 3, 1),
                                                  live)),
                             np.full(n - live, n - 1)])
    shapes = {"random": g_rand, "ones": np.arange(n),
              "single": np.zeros(n, np.int64),
              "long": np.repeat(np.arange(3), [n // 2, 40, n])[:n],
              "dead_tail": g_dead}
    for shape, gid in shapes.items():
        gid = gid.astype(np.int64)
        top = int(gid[-1])
        for capacity in {max(top // 2, 0), top + 1, n + 3}:
            yield shape, gid, capacity


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("bits", [32, 64])
def test_kernel_design_matches_plain(kind, bits):
    """Tiles of 24 rows (8 threads x 3 rows, warps of 4 lanes) and fill
    chunks of 7 slots over row counts around tile edges, each case equal
    to the plain version (``segscan_plain`` + ``_segment_finish``)."""
    rng = np.random.default_rng(bits + len(kind))
    identity = {"sum": 0, "min": -1, "max": 0}[kind]
    for n in (1, 23, 24, 25, 97, 300):
        for shape, gid, capacity in _design_cases(n, rng):
            k = _keys(n, bits, rng)
            want = _to_unsigned(tnative.seg_reduce_plain(
                torch.from_numpy(gid), _port_keys(k, bits), kind, capacity,
                identity), bits)
            got = _emulate_seg_reduce(gid.tolist(), [int(x) for x in k],
                                      kind, bits, capacity, identity,
                                      threads=8, items=3, lanes=4, chunk=7,
                                      rng=rng)
            np.testing.assert_array_equal(
                want, np.array(got, np.uint64),
                err_msg=f"n={n} {shape} capacity={capacity}")


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def test_cpu_tensors_never_launch():
    tnative.reset_counters()
    gid = torch.zeros(64, dtype=torch.int64)
    tnative.segment_minmax_sorted(torch.arange(64, dtype=torch.float64),
                                  gid, 64, "min")
    tnative.segment_sum_sorted(torch.arange(64), gid, 64)
    assert tnative.counters()["seg_reduce"] == 0


def test_cuda_entry_refuses_bad_input():
    gid = torch.zeros(8, dtype=torch.int64)
    keys = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        tnative.seg_reduce(gid, keys, "min", 8, -1)
    with pytest.raises(ValueError, match="kind"):
        tnative.seg_reduce(gid, keys, "avg", 8, 0)
