"""Port parity: the design of the join probe kernel K3 (``csrc/join_probe.cu``
with the cooperative k-ary search of ``csrc/search.cuh``), step by step.

CUDA does not run here, so the kernel's steps run in Python: warps of 32
lanes, G lanes a probe, one ballot per bound and step, the lo and hi walks
sharing pivots until they split, one grid thread a lane. The emulation
must give ``searchsorted_u64_pair_plain``'s, ``np.searchsorted``'s and the
JAX package's Pallas probe's insertion points bit for bit, at G in
{1, 4, 8, 16, 32} (at G = 1 the kernel's binary walk), on 3 * 2^k build
rungs, builds at the edges of (G + 1)^k, an empty build, an all-sentinel
build, runs longer than a pivot spacing and the probes 0, 2^63 and
2^64 - 1. ``tests/test_torch_wire.py`` reuses the k-ary search for K4's
block windows.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.ops import native as jnative

from spark_rapids_tpu_torch.ops import cuda_build
from spark_rapids_tpu_torch.ops import native as tnative

U64_MAX = 2 ** 64 - 1
SENTINEL = np.uint64(U64_MAX)


# ---------------------------------------------------------------------------
# search.cuh in Python
# ---------------------------------------------------------------------------

def kary_live(r, j, g):
    return r[1] >= g or j < r[1]


def kary_pivot(r, k, g):
    """Position of pivot k in [-1, g] of range r = (base, m)."""
    base, m = r
    if m >= g:
        q, rem = divmod(m + 1, g + 1)
        return base + (k + 1) * q + ((k + 1) * rem) // (g + 1) - 1
    return base - 1 if k < 0 else base + min(k, m)


def kary_narrow(r, k, g):
    before = kary_pivot(r, k - 1, g)
    return before + 1, kary_pivot(r, k, g) - before - 1


def kary_steps(n, g):
    s, t = 0, n + 1
    while t > 1:
        t = (t + g) // (g + 1)
        s += 1
    return s


def kary_count(a, n, below, g=32):
    """``kary_count``: the leading elements of a[0, n) for which ``below``
    holds, found by one g-lane group."""
    r = (0, n)
    for _ in range(kary_steps(n, g)):
        k = sum(1 for j in range(g)
                if kary_live(r, j, g) and below(a[kary_pivot(r, j, g)]))
        r = kary_narrow(r, k, g)
    return r[0]


def group_votes(preds, g):
    """``kary_votes`` for a warp: each lane's k from one 32-bit ballot
    masked to its g-lane group."""
    ballot = sum(1 << lane for lane, p in enumerate(preds) if p)
    out = []
    for lane in range(32):
        if g == 1:
            out.append(1 if preds[lane] else 0)
            continue
        mask = 0xFFFFFFFF if g == 32 \
            else ((1 << g) - 1) << (lane & ~(g - 1))
        out.append(bin(ballot & mask).count("1"))
    return out


# ---------------------------------------------------------------------------
# join_probe.cu in Python
# ---------------------------------------------------------------------------

def binary_walk(build, q):
    """``probe_binary`` for one probe: both bounds in one halving walk,
    sharing each load until the bases part. Returns (lo, hi, loads)."""
    if not build:
        return 0, 0, 0
    n, bl, bu, loads = len(build), 0, 0, 0
    while n > 1:
        half = n >> 1
        vl = build[bl + half]
        vu = vl if bu == bl else build[bu + half]
        loads += 1 if bu == bl else 2
        bl = bl + half if vl < q else bl
        bu = bu + half if vu <= q else bu
        n -= half
    return bl + (build[bl] < q), bu + (build[bu] <= q), loads


def emulate_k3(build, probe, g, threads=64):
    """(lo, hi, stats) as the kernel computes them: a grid of
    ceil(cap_p * g / threads) blocks, lanes t * g .. t * g + g - 1 of it
    on probe t, warps of 32 lanes voting together (the last one's lanes
    past the probes too); at g = 1 a thread a probe, each in one binary
    walk. ``stats`` holds the steps and the lane steps taken after the two
    walks split."""
    build = [int(x) for x in build]
    probe = [int(x) for x in probe]
    cap_b, cap_p = len(build), len(probe)
    if g == 1:
        walks = [binary_walk(build, q) for q in probe]
        steps = max(cap_b - 1, 0).bit_length()
        return (np.array([w[0] for w in walks], np.int64),
                np.array([w[1] for w in walks], np.int64),
                dict(steps=steps, split_steps=0))
    steps = kary_steps(cap_b, g)
    blocks = -(-cap_p * g // threads)
    lo, hi = [None] * cap_p, [None] * cap_p
    stats = dict(steps=steps, split_steps=0)
    for warp in range(blocks * threads // 32):
        idx = [(warp * 32 + lane) // g for lane in range(32)]
        live = [i < cap_p for i in idx]
        q = [probe[i] if ok else 0 for i, ok in zip(idx, live)]
        rl = [(0, cap_b)] * 32
        ru = [(0, cap_b)] * 32
        for _ in range(steps):
            pl, pu = [], []
            for lane in range(32):
                j = lane & (g - 1)
                okl = kary_live(rl[lane], j, g)
                vl = build[kary_pivot(rl[lane], j, g)] if okl else 0
                oku, vu = okl, vl
                if ru[lane] != rl[lane]:
                    stats["split_steps"] += 1
                    oku = kary_live(ru[lane], j, g)
                    vu = build[kary_pivot(ru[lane], j, g)] if oku else 0
                pl.append(okl and vl < q[lane])
                pu.append(oku and vu <= q[lane])
            kl, ku = group_votes(pl, g), group_votes(pu, g)
            for lane in range(32):
                rl[lane] = kary_narrow(rl[lane], kl[lane], g)
                ru[lane] = kary_narrow(ru[lane], ku[lane], g)
        for lane in range(32):
            if live[lane] and lane % g == 0:
                assert lo[idx[lane]] is None, "probe written twice"
                lo[idx[lane]] = rl[lane][0]
                hi[idx[lane]] = ru[lane][0]
    assert None not in lo and None not in hi, "probe never written"
    return np.array(lo, np.int64), np.array(hi, np.int64), stats


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------

def _case(cap_b, cap_p, seed, long_run=0):
    """Sorted full-range u64 build fingerprints with runs of 1-7 (and one
    run of ``long_run`` equal keys), about a third of it the sentinel
    tail; probes hit runs, miss, and sit on the edges 0, 2^63, 2^64 - 1."""
    rng = np.random.default_rng(seed)
    n_live = cap_b - cap_b // 3
    distinct = rng.integers(0, U64_MAX, max(n_live, 2), dtype=np.uint64,
                            endpoint=True)
    distinct[:2] = [np.uint64(2 ** 63), np.uint64(2 ** 63 - 1)]
    live = np.repeat(distinct, rng.integers(1, 8, len(distinct)))
    if long_run:
        live = np.concatenate([np.full(long_run, distinct[0]), live])
    live = np.sort(live[:n_live])
    build = np.concatenate([live, np.full(cap_b - len(live), SENTINEL)])
    pool = build if cap_b else np.zeros(1, np.uint64)
    probe = np.where(rng.random(cap_p) < 0.5, rng.choice(pool, cap_p),
                     rng.integers(0, U64_MAX, cap_p, dtype=np.uint64,
                                  endpoint=True))
    probe[:3] = [np.uint64(0), SENTINEL, np.uint64(2 ** 63)]
    return build.astype(np.uint64), probe.astype(np.uint64)


def _plain(build, probe):
    lo, hi = tnative.searchsorted_u64_pair_plain(
        torch.from_numpy(build.view(np.int64)),
        torch.from_numpy(probe.view(np.int64)))
    return lo.numpy(), hi.numpy()


# (cap_b, cap_p, long run): 3 * 2^k rungs, powers of two, odd lengths,
# lengths either side of (G + 1)^k (one more step), a run of equal keys
# longer than a pivot spacing.
SHAPES = [(1, 5, 0), (3, 7, 0), (12, 40, 0), (24, 33, 0), (96, 70, 0),
          (128, 64, 0), (383, 50, 0), (768, 45, 0), (1536, 40, 0),
          (3072, 36, 0), (600, 40, 300), (96, 40, 60), (32, 9, 0),
          (33, 11, 0), (288, 20, 0), (289, 13, 0), (1088, 21, 0),
          (1089, 15, 0)]
LANES = [1, 4, 8, 16, 32]


@pytest.mark.parametrize("g", LANES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k3_design_matches_plain(shape, g):
    """The kernel's walk gives the plain version's and numpy's insertion
    points at every lane count."""
    cap_b, cap_p, long_run = shape
    build, probe = _case(cap_b, cap_p, cap_b * 31 + cap_p, long_run)
    lo, hi, stats = emulate_k3(build, probe, g)
    plo, phi = _plain(build, probe)
    np.testing.assert_array_equal(lo, plo)
    np.testing.assert_array_equal(hi, phi)
    np.testing.assert_array_equal(lo, np.searchsorted(build, probe, "left"))
    np.testing.assert_array_equal(hi, np.searchsorted(build, probe,
                                                      "right"))
    if g > 1:
        assert stats["steps"] == kary_steps(cap_b, g)
        if long_run:
            assert stats["split_steps"] > 0, "the walks never split"


@pytest.mark.parametrize("g", LANES)
def test_k3_design_over_empty_and_all_sentinel_builds(g):
    probe = np.array([0, 2 ** 63, U64_MAX, 5, 2 ** 63 - 1], np.uint64)
    lo, hi, stats = emulate_k3(np.zeros(0, np.uint64), probe, g)
    assert stats["steps"] == 0
    assert lo.tolist() == [0] * 5 and hi.tolist() == [0] * 5
    for cap_b in (1, 12, 97):
        build = np.full(cap_b, SENTINEL)
        lo, hi, _ = emulate_k3(build, probe, g)
        assert lo.tolist() == [0] * 5
        assert hi.tolist() == [0, 0, cap_b, 0, 0]


@pytest.mark.parametrize("g", LANES)
@pytest.mark.parametrize("cap_b,cap_p", [(24, 40), (96, 12), (48, 96)])
def test_k3_design_matches_pallas_kernel(cap_b, cap_p, g):
    build, probe = _case(cap_b, cap_p, cap_b * 7 + cap_p)
    with jnative.forced():
        jlo, jhi = jnative.searchsorted_u64_pair(jnp.asarray(build),
                                                 jnp.asarray(probe))
    lo, hi, _ = emulate_k3(build, probe, g)
    np.testing.assert_array_equal(np.asarray(jlo), lo)
    np.testing.assert_array_equal(np.asarray(jhi), hi)


def test_kary_count_is_searchsorted():
    """search.cuh's count over int32 ends (K4's window search) at every
    lane count, over every row of tables with repeated ends."""
    rng = np.random.default_rng(5)
    for n in (1, 2, 33, 34, 100, 1089, 1090):
        ends = np.sort(rng.integers(0, 3 * n, n)).tolist()
        for g in (1, 2, 8, 32):
            for r in range(-1, 3 * n + 1, max(1, n // 7)):
                want = int(np.searchsorted(ends, r, "right"))
                assert kary_count(ends, n, lambda e: e <= r, g) == want


# ---------------------------------------------------------------------------
# Sizing: lanes and steps
# ---------------------------------------------------------------------------

def test_probe_lanes_fill_half_a_wave():
    """The largest power of two G <= 32 with cap_p * G at most half of
    132 SMs' 2,048 resident threads, or one lane (the binary walk) where
    that G is below 8: the lane count measured fastest on an H100 from
    4,096 to 4M probes."""
    half = 132 * tnative.RESIDENT_THREADS_PER_SM // 2
    assert tnative.probe_lanes(4_096, 132) == 32
    assert tnative.probe_lanes(8_192, 132) == 16        # q4's probe
    assert tnative.probe_lanes(12_000, 132) == 8
    assert tnative.probe_lanes(half // 8, 132) == 8
    assert tnative.probe_lanes(half // 8 + 1, 132) == 1
    assert tnative.probe_lanes(20_000, 132) == 1
    assert tnative.probe_lanes(65_536, 132) == 1        # q2's probe
    assert tnative.probe_lanes(4_194_304, 132) == 1
    assert tnative.probe_lanes(1, 132) == 32
    for cap_p in (1, 100, 4_224, 4_225, 8_191, 8_448, 16_896, 16_897,
                  70_000, 135_168, 270_336, 1 << 22):
        g = tnative.probe_lanes(cap_p, 132)
        assert g in (1, 8, 16, 32)
        assert g == 1 or g * cap_p <= half
        assert g == 32 or 2 * g * cap_p > half or g == 1
        if g == 1:
            assert tnative.MIN_KARY_LANES * cap_p > half


def test_q4_shape_steps_and_device_loads():
    """At q4's build (6,291,456 fingerprints) and 8,192 probes: 16 lanes,
    6 dependent k-ary steps instead of 23 binary ones (5 at 32 lanes). At
    one lane the binary walk shares its loads until the bounds part."""
    n = 6_291_456
    assert tnative.probe_lanes(8_192, 132) == 16
    assert kary_steps(n, 16) == 6 and 17 ** 5 < n + 1 <= 17 ** 6
    assert kary_steps(n, 32) == 5
    assert kary_steps(n, 1) == 23
    assert kary_steps(917_504, 32) == 4          # K4's window search
    build = list(range(0, 2 * n, 2))[:1 << 16]
    lo, hi, loads = binary_walk(build, 2 * 1000)
    assert (lo, hi) == (1000, 1001) and 16 < loads < 2 * 16
    lo, hi, loads = binary_walk(build, 2 * 1000 + 1)
    assert (lo, hi) == (1001, 1001) and loads == 16


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32])
def test_kary_ranges_shrink_by_g_plus_one(g):
    """Every narrowing keeps the count inside and leaves at most
    ceil((m + 1) / (g + 1)) candidates, so kary_steps steps always end
    the walk."""
    for m in list(range(0, 80)) + [1000, 4097, 6_291_456]:
        r = (7, m)
        for k in range(g + 1):
            base, m2 = kary_narrow(r, k, g)
            assert r[0] <= base and base + m2 <= r[0] + r[1]
            assert m2 + 1 <= -(-(m + 1) // (g + 1))
        if m >= g:
            pivots = [kary_pivot(r, j, g) for j in range(g)]
            assert pivots == sorted(set(pivots))
            assert r[0] <= pivots[0] and pivots[-1] < r[0] + m


# ---------------------------------------------------------------------------
# The wrapper and the build
# ---------------------------------------------------------------------------

def test_cuda_probe_outputs(monkeypatch):
    """``lo`` and ``hi`` are fresh contiguous (cap_p,) int32 tensors on
    the probe's device, handed to K3's entry and returned as it left
    them."""
    seen = []

    def fake_probe(built_fp, probe_fp, lo, hi):
        seen.append((lo, hi))
        lo.fill_(1)
        hi.fill_(2)
    monkeypatch.setattr(tnative, "join_probe", fake_probe)
    fp = torch.arange(5, dtype=torch.int64)
    lo, hi = tnative._searchsorted_u64_pair_cuda(fp, fp)
    assert seen and seen[0][0] is lo and seen[0][1] is hi
    for t in (lo, hi):
        assert t.is_contiguous() and t.dtype == torch.int32
        assert t.shape == (5,) and t.device == fp.device
    assert lo.data_ptr() != hi.data_ptr()
    assert lo.tolist() == [1] * 5 and hi.tolist() == [2] * 5


def test_build_digest_follows_included_headers(tmp_path, monkeypatch):
    """A source's library name changes when a header it includes (or one
    that header includes) changes, and only then."""
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    assert [p.name for p in cuda_build.sources("k")] == ["k.cu", "a.cuh",
                                                         "b.cuh"]
    before = cuda_build.library_path("k")
    (tmp_path / "other.cuh").write_text("// edited\n")
    assert cuda_build.library_path("k") == before
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert cuda_build.library_path("k") != before


def test_port_kernels_include_the_shared_search():
    for name in ("join_probe", "rle_decode"):
        assert [p.name for p in cuda_build.sources(name)] == [
            f"{name}.cu", "search.cuh"]
