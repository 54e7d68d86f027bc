"""Hand-written GPU kernels of the port and their plain-PyTorch versions.

Port of the JAX package's ``ops/native.py`` (its Pallas kernel layer), as
CUDA sources built for Hopper by ``ops/cuda_build.py``:

- K1, the stable u32 radix rank behind every stable sort pass
  (``ops/kernels.py`` ``_radix_perm``): ``csrc/radix_rank.cu``.
- K2, the sorted-segment scan behind ``segment_sum_sorted`` and
  ``segment_minmax_sorted`` (``ops/kernels.py`` ``_seg_sum`` /
  ``_seg_minmax``, so every keyed Min/Max): ``csrc/seg_scan.cu``.
- K3, the hash-join probe (``ops/join.py`` ``probe_ranges``): left and
  right insertion points of u64 fingerprints, ``csrc/join_probe.cu``.
- K4, the wire codec's RLE decode (``columnar/wire.py``): a run table
  expanded to the batch's rows, ``csrc/rle_decode.cu``.

Routing is by the tensor's device and nothing else: a CUDA tensor launches
the kernel (or the call raises), a CPU tensor takes the plain version. No
env variable or conf key sends a CUDA tensor to the plain version; the
JAX package's ``spark.rapids.sql.native.*`` gates come in a later slice.

Every launch adds one to its kernel's counter (:func:`counters`), so a run
can show that the main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

RADIX = 256
TILE_ROWS = 4096        # rows per histogram/scatter tile (kTile in the .cu)
_M32 = 0xFFFFFFFF
_INT32_MIN = -(1 << 31)
_INT64_MIN = -(1 << 63)

_LOCK = threading.Lock()
_COUNTERS: Dict[str, int] = {"digit_hist": 0, "digit_scatter": 0,
                             "join_probe": 0, "seg_scan": 0,
                             "rle_decode": 0}


def _count(name: str) -> None:
    with _LOCK:
        _COUNTERS[name] += 1


def counters() -> Dict[str, int]:
    """Launches per CUDA kernel since the last reset."""
    with _LOCK:
        return dict(_COUNTERS)


def reset_counters() -> None:
    with _LOCK:
        for k in _COUNTERS:
            _COUNTERS[k] = 0


def _ntiles(n: int) -> int:
    return max(-(-n // TILE_ROWS), 1)


# ---------------------------------------------------------------------------
# Plain-PyTorch version: the same steps as the kernel, in torch ops
# ---------------------------------------------------------------------------

def digit_hist_plain(dig: torch.Tensor, tile: int = TILE_ROWS
                     ) -> torch.Tensor:
    """Per-tile 256-bin histogram of ``dig`` (int64 digits), digit-major:
    ``out[d * ntiles + t]`` counts rows of tile ``t`` with digit ``d``."""
    n = dig.numel()
    ntiles = max(-(-n // tile), 1)
    tile_idx = torch.arange(n, dtype=torch.int64, device=dig.device) // tile
    return torch.bincount(dig * ntiles + tile_idx, minlength=RADIX * ntiles)


def tile_rank_plain(dig: torch.Tensor, tile: int = TILE_ROWS
                    ) -> torch.Tensor:
    """Stable rank of each row within its tile: the number of earlier
    rows of the same tile with the same digit (exclusive one-hot
    prefix, in chunks of tiles to bound memory)."""
    n = dig.numel()
    ntiles = max(-(-n // tile), 1)
    padded = torch.zeros(ntiles * tile, dtype=torch.int64, device=dig.device)
    padded[:n] = dig
    d2 = padded.view(ntiles, tile)
    out = torch.empty((ntiles, tile), dtype=torch.int64, device=dig.device)
    buckets = torch.arange(RADIX, dtype=torch.int64, device=dig.device)
    step = max(1, (1 << 24) // (tile * RADIX))
    for t0 in range(0, ntiles, step):
        d = d2[t0:t0 + step]
        onehot = (d[:, :, None] == buckets).to(torch.int32)
        prefix = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
        out[t0:t0 + step] = prefix.gather(2, d[:, :, None])[:, :, 0]
    return out.view(-1)[:n]


def digit_scatter_plain(keys: torch.Tensor, vals: torch.Tensor, shift: int,
                        offsets: torch.Tensor, tile: int = TILE_ROWS
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``out[offsets[digit, tile] + rank] = (key, val)`` for every row."""
    n = keys.numel()
    ntiles = max(-(-n // tile), 1)
    dig = (keys >> shift) & 0xFF
    tile_idx = torch.arange(n, dtype=torch.int64, device=keys.device) // tile
    pos = offsets[dig * ntiles + tile_idx] + tile_rank_plain(dig, tile)
    keys_out = torch.empty_like(keys)
    vals_out = torch.empty_like(vals)
    keys_out[pos] = keys
    vals_out[pos] = vals
    return keys_out, vals_out


def stable_argsort_u32_plain(keys: torch.Tensor, tile: int = TILE_ROWS
                             ) -> torch.Tensor:
    """The stable permutation sorting u32 ``keys`` (int64 values in
    [0, 2^32), or int32 bit patterns), as 4 LSD passes of 8 bits: per-tile
    histogram, scanned bases, stable within-tile rank, scatter. Returns
    int32 row indices."""
    k = keys.to(torch.int64) & _M32
    v = torch.arange(k.numel(), dtype=torch.int64, device=k.device)
    for shift in (0, 8, 16, 24):
        hist = digit_hist_plain((k >> shift) & 0xFF, tile)
        offsets = torch.cumsum(hist, 0) - hist
        k, v = digit_scatter_plain(k, v, shift, offsets, tile)
    return v.to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernel K1 (csrc/radix_rank.cu)
# ---------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from spark_rapids_tpu_torch.ops import cuda_build
        lib = cuda_build.load("radix_rank")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.srt_digit_hist.argtypes = [vp, ci, ci, ci, vp, vp]
        lib.srt_digit_hist.restype = ci
        lib.srt_digit_scatter.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, vp]
        lib.srt_digit_scatter.restype = ci
        lib.srt_cuda_error_string.argtypes = [ci]
        lib.srt_cuda_error_string.restype = ctypes.c_char_p
        lib.srt_radix_tile_rows.restype = ci
        if lib.srt_radix_tile_rows() != TILE_ROWS:
            raise RuntimeError("radix_rank.cu tile size differs from "
                               "native.TILE_ROWS")
        _LIB = lib
    return _LIB


def _raise_on(code: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by any kernel's C
    entry; the message comes from the one error-string entry, in
    ``radix_rank.cu``."""
    if code != 0:
        msg = _lib().srt_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _check_u32(t: torch.Tensor, name: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D int32 tensor "
                         f"(u32 bit patterns), got {t.dtype} {tuple(t.shape)}")


def digit_hist(keys32: torch.Tensor, shift: int,
               hist: torch.Tensor) -> torch.Tensor:
    """Launch ``digit_hist`` on the current stream: per-tile histogram of
    digit ``shift`` of int32-bit-pattern keys into ``hist``
    (``(256 * ntiles,)`` int32, digit-major)."""
    _check_u32(keys32, "keys")
    n = keys32.numel()
    ntiles = _ntiles(n)
    if hist.dtype != torch.int32 or hist.numel() != RADIX * ntiles \
            or not hist.is_contiguous() or hist.device != keys32.device:
        raise ValueError("hist must be a contiguous (256 * ntiles,) int32 "
                         "tensor on the keys' device")
    stream = torch.cuda.current_stream(keys32.device).cuda_stream
    _raise_on(_lib().srt_digit_hist(keys32.data_ptr(), n, shift, ntiles,
                                    hist.data_ptr(), stream), "digit_hist")
    _count("digit_hist")
    return hist


def digit_scatter(keys32: torch.Tensor, vals: torch.Tensor, shift: int,
                  offsets: torch.Tensor, keys_out: torch.Tensor,
                  vals_out: torch.Tensor) -> None:
    """Launch ``digit_scatter`` on the current stream: stable within-tile
    rank of digit ``shift``, each (key, val) written to
    ``offsets[digit * ntiles + tile] + rank``."""
    _check_u32(keys32, "keys")
    _check_u32(vals, "vals")
    _check_u32(offsets, "offsets")
    _check_u32(keys_out, "keys_out")
    _check_u32(vals_out, "vals_out")
    n = keys32.numel()
    ntiles = _ntiles(n)
    if vals.numel() != n or keys_out.numel() != n or vals_out.numel() != n \
            or offsets.numel() != RADIX * ntiles:
        raise ValueError("digit_scatter: mismatched lengths")
    stream = torch.cuda.current_stream(keys32.device).cuda_stream
    _raise_on(_lib().srt_digit_scatter(
        keys32.data_ptr(), vals.data_ptr(), n, shift, ntiles,
        offsets.data_ptr(), keys_out.data_ptr(), vals_out.data_ptr(),
        stream), "digit_scatter")
    _count("digit_scatter")


def to_u32_bits(keys: torch.Tensor) -> torch.Tensor:
    """int64-carried u32 words -> contiguous int32 bit patterns (the low
    32 bits of each value)."""
    if keys.dtype == torch.int32:
        return keys.contiguous()
    k = keys.to(torch.int64) & _M32
    return torch.where(k >= (1 << 31), k - (1 << 32), k) \
        .to(torch.int32).contiguous()


def _stable_argsort_u32_cuda(keys: torch.Tensor) -> torch.Tensor:
    n = keys.numel()
    if n >= (1 << 31):
        raise ValueError(f"stable_argsort_u32: {n} rows exceed int32 indices")
    with torch.cuda.device(keys.device):
        k_src = to_u32_bits(keys)
        if k_src.data_ptr() == keys.data_ptr():
            k_src = k_src.clone()        # the passes overwrite their input
        k_dst = torch.empty_like(k_src)
        v_src = torch.arange(n, dtype=torch.int32, device=keys.device)
        v_dst = torch.empty_like(v_src)
        hist = torch.empty(RADIX * _ntiles(n), dtype=torch.int32,
                           device=keys.device)
        for shift in (0, 8, 16, 24):
            digit_hist(k_src, shift, hist)
            offsets = torch.cumsum(hist, 0, dtype=torch.int32) - hist
            digit_scatter(k_src, v_src, shift, offsets, k_dst, v_dst)
            k_src, k_dst = k_dst, k_src
            v_src, v_dst = v_dst, v_src
        return v_src


def stable_argsort_u32(keys: torch.Tensor) -> torch.Tensor:
    """Stable argsort of (cap,) u32 keys, as int32 row indices: the
    unique stable permutation, so bit-identical to
    ``torch.sort(stable=True).indices`` and to the JAX package's
    ``native.stable_argsort_u32``.

    ``keys`` are int64 tensors holding values in [0, 2^32) (the port's u32
    carrier) or int32 bit patterns. A CUDA tensor runs kernel K1; a CPU
    tensor runs :func:`stable_argsort_u32_plain`."""
    if keys.dim() != 1:
        raise ValueError(f"stable_argsort_u32 takes 1-D keys, got "
                         f"{tuple(keys.shape)}")
    if keys.dtype not in (torch.int64, torch.int32):
        raise ValueError(f"stable_argsort_u32 takes int64-carried u32 or "
                         f"int32 keys, got {keys.dtype}")
    if not keys.is_contiguous():
        raise ValueError("stable_argsort_u32 takes contiguous keys")
    if keys.device.type == "cpu":
        return stable_argsort_u32_plain(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"stable_argsort_u32: unsupported device "
                         f"{keys.device}")
    return _stable_argsort_u32_cuda(keys)


# ---------------------------------------------------------------------------
# Kernel K3: the hash-join probe (csrc/join_probe.cu)
# ---------------------------------------------------------------------------
#
# A u64 fingerprint travels as the int64 tensor of its bit pattern. The
# build side is sorted in UNSIGNED order (``ops/join.py`` ``build_side``),
# its unmatchable rows carry the sentinel 0xFFFF_FFFF_FFFF_FFFF (int64 -1)
# and sort last.

def searchsorted_u64_pair_plain(built_fp: torch.Tensor,
                                probe_fp: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lo, hi)``: the left and right insertion points of each probe
    fingerprint in the sorted build fingerprints, as int32. Flipping the
    top bit maps unsigned order onto int64's signed order, where
    ``torch.searchsorted`` works."""
    b = built_fp ^ _INT64_MIN
    q = probe_fp ^ _INT64_MIN
    lo = torch.searchsorted(b, q, side="left").to(torch.int32)
    hi = torch.searchsorted(b, q, side="right").to(torch.int32)
    return lo, hi


_PROBE_LIB = None


def _probe_lib():
    global _PROBE_LIB
    if _PROBE_LIB is None:
        from spark_rapids_tpu_torch.ops import cuda_build
        lib = cuda_build.load("join_probe")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.srt_join_probe.argtypes = [vp, ci, vp, ci, vp, vp, vp]
        lib.srt_join_probe.restype = ci
        _PROBE_LIB = lib
    return _PROBE_LIB


def join_probe(built_fp: torch.Tensor, probe_fp: torch.Tensor,
               lo: torch.Tensor, hi: torch.Tensor) -> None:
    """Launch ``join_probe`` on the current stream: ``lo``/``hi`` (int32,
    one per probe row) get the insertion points of ``probe_fp`` in the
    sorted ``built_fp``. The one place K3's inputs are checked."""
    fps = ((built_fp, "built_fp"), (probe_fp, "probe_fp"))
    for t, name in fps:
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int64 tensor "
                             f"(u64 bit patterns), got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.numel() >= (1 << 31):
            raise ValueError(f"{name}: {t.numel()} rows exceed int32 "
                             f"positions")
    for t, name in fps:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
    cap_p = probe_fp.numel()
    for t, name in ((lo, "lo"), (hi, "hi")):
        if t.dtype != torch.int32 or t.numel() != cap_p \
                or not t.is_contiguous() or t.device != probe_fp.device:
            raise ValueError(f"{name} must be a contiguous (cap_p,) int32 "
                             f"tensor on the probe's device")
    if built_fp.device != probe_fp.device:
        raise ValueError("built_fp and probe_fp lie on different devices")
    if cap_p == 0:
        return
    stream = torch.cuda.current_stream(probe_fp.device).cuda_stream
    _raise_on(_probe_lib().srt_join_probe(
        built_fp.data_ptr(), built_fp.numel(), probe_fp.data_ptr(), cap_p,
        lo.data_ptr(), hi.data_ptr(), stream), "join_probe")
    _count("join_probe")


def searchsorted_u64_pair(built_fp: torch.Tensor, probe_fp: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The join probe's two searches: ``(lo, hi)`` int32 insertion points
    (left, right) of every probe fingerprint in the build fingerprints,
    which are sorted in unsigned order. Bit-identical to the JAX package's
    ``native.searchsorted_u64_pair``: insertion points are unique.

    Both arguments are 1-D int64 tensors of u64 bit patterns. Routes by
    device only: CPU tensors run :func:`searchsorted_u64_pair_plain`,
    any other tensor goes to kernel K3, whose entry :func:`join_probe`
    checks the inputs and raises on what it cannot launch."""
    if probe_fp.device.type == "cpu":
        return searchsorted_u64_pair_plain(built_fp, probe_fp)
    return _searchsorted_u64_pair_cuda(built_fp, probe_fp)


def _searchsorted_u64_pair_cuda(built_fp: torch.Tensor,
                                probe_fp: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    with torch.cuda.device(probe_fp.device):
        lo = torch.empty(probe_fp.numel(), dtype=torch.int32,
                         device=probe_fp.device)
        hi = torch.empty_like(lo)
        join_probe(built_fp, probe_fp, lo, hi)
        return lo, hi


# ---------------------------------------------------------------------------
# Kernel K2: the sorted-segment scan (csrc/seg_scan.cu)
# ---------------------------------------------------------------------------
#
# ``segment_reduce``'s group ids are nondecreasing, so one segmented scan
# gives every row the running reduction of its group so far, and each
# group's last row holds the group's result (``_segment_finish`` scatters
# it to the group's slot). Keys are exact: integer sums wrap around as
# two's complement, min/max compare in the total-order bit domain
# (``_minmax_encode``). A u32 key travels as an int32 bit pattern, a u64
# key as an int64 one; there are no (hi, lo) planes. Float SUMS never come
# here: their reduction order changes rounding.

SEG_TILE_ROWS = 2048    # rows per tile_scan block (kTile in the .cu)
_SEG_KIND_CODES = {"sum": 0, "min": 1, "max": 2}
# Neutral element per kind, as a bit pattern: 0 for sums and unsigned max,
# all ones for unsigned min.
_SEG_NEUTRAL = {"sum": 0, "min": -1, "max": 0}

_NP_DTYPES = {torch.bool: np.bool_, torch.int8: np.int8,
              torch.int16: np.int16, torch.int32: np.int32,
              torch.int64: np.int64, torch.float32: np.float32,
              torch.float64: np.float64}


def _flags_of(gid: torch.Tensor) -> torch.Tensor:
    """(cap,) bool: True where a segment starts (row 0 and every change of
    group id)."""
    flags = torch.ones(gid.numel(), dtype=torch.bool, device=gid.device)
    flags[1:] = gid[1:] != gid[:-1]
    return flags


def _seg_combine(kind: str, a: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """combine(a, b), ``a`` preceding ``b``, on int32 (u32) or int64 (u64)
    bit patterns. Unsigned order is the signed order of the values with
    their top bit flipped (torch has no unsigned 64-bit compare)."""
    if kind == "sum":
        if a.dtype == torch.int32:
            return to_u32_bits(a.to(torch.int64) + b.to(torch.int64))
        return a + b
    sign = _INT32_MIN if a.dtype == torch.int32 else _INT64_MIN
    au, bu = a ^ sign, b ^ sign
    pick_b = bu < au if kind == "min" else bu > au
    return torch.where(pick_b, b, a)


def segscan_plain(gid: torch.Tensor, keys: torch.Tensor,
                  kind: str) -> torch.Tensor:
    """Per-row running segmented reduction of ``keys`` (int32 u32 or int64
    u64 bit patterns) over the segments of ``gid``: a Hillis-Steele scan
    over the (flag, value) monoid, O(n log n), as the JAX package's
    ``_segscan`` block body runs it. Exact for every kind: wrap-around
    sums and unsigned min/max are associative."""
    n = keys.numel()
    g = _flags_of(gid)
    v = keys.clone()
    d = 1
    while d < n:
        g_sh = torch.cat([torch.zeros(d, dtype=torch.bool, device=g.device),
                          g[:-d]])
        v_sh = torch.cat([torch.full((d,), _SEG_NEUTRAL[kind],
                                     dtype=v.dtype, device=v.device), v[:-d]])
        v = torch.where(g, v, _seg_combine(kind, v_sh, v))
        g = g | g_sh
        d *= 2
    return v


_SEG_LIB = None


def _seg_lib():
    global _SEG_LIB
    if _SEG_LIB is None:
        from spark_rapids_tpu_torch.ops import cuda_build
        lib = cuda_build.load("seg_scan")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.srt_seg_scan.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, vp]
        lib.srt_seg_scan.restype = ci
        lib.srt_seg_scan_tile_rows.restype = ci
        if lib.srt_seg_scan_tile_rows() != SEG_TILE_ROWS:
            raise RuntimeError("seg_scan.cu tile size differs from "
                               "native.SEG_TILE_ROWS")
        _SEG_LIB = lib
    return _SEG_LIB


def seg_scan(gid: torch.Tensor, keys: torch.Tensor, kind: str,
             out: torch.Tensor) -> None:
    """Launch ``seg_scan`` (K2) on the current stream: ``out`` gets the
    running segmented ``kind`` reduction of ``keys`` over the segments of
    the nondecreasing int64 ``gid``. The one place K2's inputs are
    checked; the tile scratch is allocated here."""
    if kind not in _SEG_KIND_CODES:
        raise ValueError(f"seg_scan: unknown kind {kind!r}")
    for t, name in ((gid, "gid"), (keys, "keys"), (out, "out")):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor, got "
                             f"{tuple(t.shape)}")
    if gid.dtype != torch.int64:
        raise ValueError(f"gid must be int64, got {gid.dtype}")
    if keys.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"keys must be int32 (u32) or int64 (u64) bit "
                         f"patterns, got {keys.dtype}")
    n = keys.numel()
    if gid.numel() != n or out.numel() != n or out.dtype != keys.dtype:
        raise ValueError("seg_scan: gid, keys and out differ in length or "
                         "out in type")
    if gid.device != keys.device or out.device != keys.device:
        raise ValueError("seg_scan: tensors lie on different devices")
    if n >= (1 << 31):
        raise ValueError(f"seg_scan: {n} rows exceed int32 positions")
    if n == 0:
        return
    ntiles = -(-n // SEG_TILE_ROWS)
    agg_v = torch.empty(ntiles, dtype=torch.int64, device=keys.device)
    agg_meta = torch.empty(2 * ntiles, dtype=torch.int32, device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    _raise_on(_seg_lib().srt_seg_scan(
        gid.data_ptr(), keys.data_ptr(), n, keys.element_size(),
        _SEG_KIND_CODES[kind], out.data_ptr(), agg_v.data_ptr(),
        agg_meta.data_ptr(), stream), "seg_scan")
    _count("seg_scan")


def segscan(gid: torch.Tensor, keys: torch.Tensor, kind: str
            ) -> torch.Tensor:
    """The running segmented reduction (``segscan_plain``'s function).
    Routes by device only: CPU tensors run :func:`segscan_plain`, any
    other tensor goes to kernel K2, whose entry :func:`seg_scan` checks
    the inputs and raises on what it cannot launch."""
    if keys.device.type == "cpu":
        return segscan_plain(gid, keys, kind)
    with torch.cuda.device(keys.device):
        out = torch.empty_like(keys)
        seg_scan(gid, keys, kind, out)
        return out


def _signed(u: int, bits: int) -> int:
    return u - (1 << bits) if u >> (bits - 1) else u


def _encoded_identity(dtype: torch.dtype, kind: str) -> int:
    """The encoded key of the fill an empty group gets, as the key
    tensor's signed bit pattern. It decodes to the JAX package's
    ``jax.ops.segment_min``/``segment_max`` fill (the dtype's max/min,
    +/-inf for floats), and no encoded value beats it: it encodes the
    dtype's extreme (NaN is masked out before the reduction)."""
    np_dtype = np.dtype(_NP_DTYPES[dtype])
    if np.issubdtype(np_dtype, np.floating):
        ext = np.asarray(np.inf if kind == "min" else -np.inf, np_dtype)
        nbits = 8 * np_dtype.itemsize
        bits = int(ext.view(np.uint32 if nbits == 32 else np.uint64))
        top = 1 << (nbits - 1)
        enc = (~bits & ((1 << nbits) - 1)) if bits & top else bits | top
        return _signed(enc, nbits)
    if np_dtype == np.dtype(np.bool_):
        return _signed((1 if kind == "min" else 0) ^ 0x80000000, 32)
    info = np.iinfo(np_dtype)
    v = int(info.max if kind == "min" else info.min)
    if np_dtype.itemsize <= 4:
        return _signed((v & _M32) ^ 0x80000000, 32)
    return _signed((v & ((1 << 64) - 1)) ^ (1 << 63), 64)


def _minmax_encode(values: torch.Tensor
                   ) -> Tuple[torch.Tensor, Callable[[torch.Tensor],
                                                     torch.Tensor]]:
    """Exact total-order encode: (keys, decode). Unsigned order of the keys
    is the values' order, with -0.0 below 0.0 and subnormals kept: bool
    and ints of 4 bytes or fewer take the 32-bit sign-bias flip, int64 the
    64-bit one, f32 and f64 the IEEE total-order transform (flip every bit
    of a negative, the sign bit of the rest)."""
    dt_ = values.dtype
    if dt_ in (torch.float32, torch.float64):
        it = torch.int32 if dt_ == torch.float32 else torch.int64
        sign = _INT32_MIN if dt_ == torch.float32 else _INT64_MIN
        bits = values.contiguous().view(it)
        keys = torch.where(bits < 0, ~bits, bits | sign)

        def dec(k):
            return torch.where(k < 0, k ^ sign, ~k).view(dt_)
        return keys, dec
    if dt_ == torch.int64:
        return values ^ _INT64_MIN, lambda k: k ^ _INT64_MIN
    keys = values.to(torch.int32) ^ _INT32_MIN

    def dec_small(k):
        v = k ^ _INT32_MIN
        return v != 0 if dt_ == torch.bool else v.to(dt_)
    return keys, dec_small


def _segment_finish(running: torch.Tensor, gid: torch.Tensor,
                    capacity: int, identity: int) -> torch.Tensor:
    """Each segment's last running value scattered to its group's slot;
    empty slots keep the (encoded) identity. Slots are unique (gid is
    nondecreasing); the rest go to one extra slot that is sliced off."""
    is_last = torch.ones(gid.numel(), dtype=torch.bool, device=gid.device)
    is_last[:-1] = gid[1:] != gid[:-1]
    slots = torch.where(is_last, gid, capacity).clamp(max=capacity)
    out = torch.full((capacity + 1,), identity, dtype=running.dtype,
                     device=running.device)
    out[slots] = running
    return out[:capacity]


def segment_sum_sorted(values: torch.Tensor, gid: torch.Tensor,
                       capacity: int) -> Optional[torch.Tensor]:
    """Per-group wrap-around sums of integer ``values`` for nondecreasing
    ``gid`` (``jax.ops.segment_sum``'s function), through the segmented
    scan. None for floats and bools: their sums stay off the exact path."""
    if values.is_floating_point() or values.dtype == torch.bool:
        return None
    if values.element_size() <= 4:
        keys = values.to(torch.int32).contiguous()
        running = segscan(gid, keys, "sum")
        return _segment_finish(running, gid, capacity, 0).to(values.dtype)
    running = segscan(gid, values.contiguous(), "sum")
    return _segment_finish(running, gid, capacity, 0)


def segment_minmax_sorted(values: torch.Tensor, gid: torch.Tensor,
                          capacity: int, kind: str) -> torch.Tensor:
    """Per-group min or max of ``values`` for nondecreasing ``gid``
    (``jax.ops.segment_min``/``segment_max``'s function, empty groups
    filled with the dtype's extreme), in the total-order bit domain. Every
    numeric dtype encodes, f64 included."""
    if kind not in ("min", "max"):
        raise ValueError(f"segment_minmax_sorted: unknown kind {kind!r}")
    keys, dec = _minmax_encode(values)
    identity = _encoded_identity(values.dtype, kind)
    running = segscan(gid, keys.contiguous(), kind)
    return dec(_segment_finish(running, gid, capacity, identity))


# ---------------------------------------------------------------------------
# Kernel K4: the wire codec's RLE decode (csrc/rle_decode.cu)
# ---------------------------------------------------------------------------
#
# A run table is ``run_vals`` (run_cap,) in the wire dtype and ``run_ends``
# (run_cap,) int32, the nondecreasing exclusive end row of each run; the
# encoder (``columnar/wire.py`` ``_try_rle``) pads it with value 0 and end
# ``cap``. Row r takes the value of the first run whose end is above r
# (the last run where none is), and rows at or past ``num_rows`` are 0.
# Values move as raw bytes, so -0.0 and NaN payloads survive.

def rle_decode_plain(run_vals: torch.Tensor, run_ends: torch.Tensor,
                     cap: int, num_rows: int) -> torch.Tensor:
    """(cap,) expanded values in the wire dtype: ``searchsorted`` of each
    row over the run ends, a clipped gather, and padding rows zeroed (the
    JAX package's non-native branch, ``columnar/wire.py:638-648``)."""
    rows = torch.arange(cap, dtype=run_ends.dtype, device=run_ends.device)
    ridx = torch.searchsorted(run_ends, rows, right=True)
    data = run_vals[ridx.clamp(max=run_vals.numel() - 1)]
    return torch.where(rows < num_rows, data, torch.zeros_like(data))


_RLE_LIB = None


def _rle_lib():
    global _RLE_LIB
    if _RLE_LIB is None:
        from spark_rapids_tpu_torch.ops import cuda_build
        lib = cuda_build.load("rle_decode")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.srt_rle_decode.argtypes = [vp, vp, ci, ci, ci, ci, vp, vp]
        lib.srt_rle_decode.restype = ci
        _RLE_LIB = lib
    return _RLE_LIB


def rle_expand(run_vals: torch.Tensor, run_ends: torch.Tensor,
               num_rows: int, out: torch.Tensor) -> None:
    """Launch ``rle_decode`` (K4) on the current stream: ``out`` (cap,)
    gets the run table expanded, rows at or past ``num_rows`` zeroed. The
    one place K4's inputs are checked."""
    for t, name in ((run_vals, "run_vals"), (run_ends, "run_ends"),
                    (out, "out")):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor, got "
                             f"{tuple(t.shape)}")
    if run_ends.dtype != torch.int32:
        raise ValueError(f"run_ends must be int32, got {run_ends.dtype}")
    if run_vals.element_size() not in (1, 2, 4, 8) \
            or out.dtype != run_vals.dtype:
        raise ValueError(f"rle_decode: run_vals {run_vals.dtype} and out "
                         f"{out.dtype} must be one 1, 2, 4 or 8-byte type")
    run_cap, cap = run_vals.numel(), out.numel()
    if run_ends.numel() != run_cap or run_cap == 0:
        raise ValueError("rle_decode: run_vals and run_ends differ in "
                         "length or are empty")
    if run_ends.device != run_vals.device or out.device != run_vals.device:
        raise ValueError("rle_decode: tensors lie on different devices")
    if cap >= (1 << 30) or not 0 <= num_rows <= cap:
        raise ValueError(f"rle_decode: {cap} rows or num_rows={num_rows} "
                         f"out of range")
    if cap == 0:
        return
    stream = torch.cuda.current_stream(out.device).cuda_stream
    _raise_on(_rle_lib().srt_rle_decode(
        run_vals.data_ptr(), run_ends.data_ptr(), run_cap,
        run_vals.element_size(), cap, int(num_rows), out.data_ptr(),
        stream), "rle_decode")
    _count("rle_decode")


def rle_decode(run_vals: torch.Tensor, run_ends: torch.Tensor, cap: int,
               num_rows: int) -> torch.Tensor:
    """Expand a run table to (cap,) values in the wire dtype, padding rows
    zeroed: bit-identical to the JAX package's ``native.rle_decode`` and
    to its searchsorted + gather branch, at any run count. ``num_rows`` is
    a host int. Routes by device only: CPU tensors run
    :func:`rle_decode_plain`, any other tensor goes to kernel K4, whose
    entry :func:`rle_expand` checks the inputs and raises on what it
    cannot launch."""
    if run_vals.device.type == "cpu":
        return rle_decode_plain(run_vals, run_ends, cap, num_rows)
    with torch.cuda.device(run_vals.device):
        # Bytes are bytes: bool moves as uint8.
        vals = run_vals.view(torch.uint8) if run_vals.dtype == torch.bool \
            else run_vals
        out = torch.empty(cap, dtype=vals.dtype, device=vals.device)
        rle_expand(vals, run_ends, num_rows, out)
        return out.view(torch.bool) if run_vals.dtype == torch.bool else out
