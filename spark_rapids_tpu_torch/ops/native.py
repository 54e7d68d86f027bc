"""Hand-written GPU kernels of the port and their plain-PyTorch versions.

Port of the JAX package's ``ops/native.py`` (its Pallas kernel layer), as
CUDA sources built for Hopper by ``ops/cuda_build.py``:

- K1, the stable u32 radix sort behind every sort word
  (``ops/kernels.py`` ``_radix_perm``): ``csrc/radix_rank.cu``, one C call
  a sort (a histogram kernel and four onesweep passes).
- K2, the sorted-segment reduce behind ``segment_sum_sorted`` and
  ``segment_minmax_sorted`` (``ops/kernels.py`` ``_seg_sum`` /
  ``_seg_minmax``, so every keyed Min/Max): ``csrc/seg_scan.cu``, one C
  call a reduction (a fill and one single-pass kernel).
- K3, the hash-join probe (``ops/join.py`` ``probe_ranges``): left and
  right insertion points of u64 fingerprints, ``csrc/join_probe.cu``, one
  cooperative k-ary walk for both (``csrc/search.cuh``).
- K4, the wire codec's RLE decode (``columnar/wire.py``): a run table
  expanded to the batch's rows, ``csrc/rle_decode.cu``.

Each wrapper routes by the tensor's device: a CUDA tensor launches the
kernel (or the call raises), a CPU tensor takes the plain version.

The gates (the JAX package's ``spark.rapids.sql.native.*`` keys, conf
``config.py`` ``NATIVE_*``, env ``SRT_NATIVE`` / ``SRT_NATIVE_<KERNEL>``)
are read at the call sites (``ops/kernels.py`` ``_radix_perm`` /
``_seg_sum`` / ``_seg_minmax``, ``ops/join.py`` ``probe_ranges``,
``parallel/exchange.py`` ``_split``, ``columnar/wire.py``'s RLE arm), as
in the JAX package. A live gate calls the wrapper above; a gate that is
off calls the kernel's PyTorch library route, on either device:

- K1: a stable ``torch.sort`` of the keys widened to int64
  (:func:`stable_argsort_u32_library`);
- K2: an identity-filled ``scatter_reduce_`` over the encoded keys
  (:func:`segment_reduce_library`);
- K3: two ``torch.searchsorted`` over sign-flipped int64 fingerprints,
  which is K3's plain version (:func:`searchsorted_u64_pair_plain`);
- K4: ``searchsorted`` of the row index in the run ends, then a gather,
  which is K4's plain version (:func:`rle_decode_plain`).

So for K3 and K4 the gate-off route on the card is the plain version;
for K1 and K2 it is a library call the plain versions do not make. A
live gate sends a CUDA tensor to the kernel only, at any size (the JAX
package's ``rleDecode.maxRuns`` bound was a TPU VMEM limit; K4 cuts a
larger run table into block windows). The gates are adopted
process-globally per collect (:func:`maybe_configure`, next to the wire
codec's); :func:`fingerprint` is the set of live kernels.

Every call into a kernel's C entry adds one to its counter
(:func:`counters`), and every library route call to its own
(:func:`library_counters`; K1 and K2 count in their routes, K3 and K4 at
their gated call sites through :func:`count_library`), so a run shows
kernel launches and library calls apart.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

RADIX = 256
RADIX_PASSES = 4
TILE_ROWS = 4096        # rows per onesweep tile (kTile in radix_rank.cu)
_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
_INT32_MIN = -(1 << 31)
_INT64_MIN = -(1 << 63)

_LOCK = threading.Lock()
_COUNTERS: Dict[str, int] = {"radix_sort": 0, "join_probe": 0,
                             "seg_reduce": 0, "rle_decode": 0}
_LIBRARY: Dict[str, int] = dict.fromkeys(_COUNTERS, 0)


def _count(name: str) -> None:
    with _LOCK:
        _COUNTERS[name] += 1


def count_library(name: str) -> None:
    """One call of a kernel's library route, under its counter name."""
    with _LOCK:
        _LIBRARY[name] += 1


def counters() -> Dict[str, int]:
    """Launches per CUDA kernel since the last reset."""
    with _LOCK:
        return dict(_COUNTERS)


def library_counters() -> Dict[str, int]:
    """Calls of each kernel's library route since the last reset, under the
    kernel's counter name."""
    with _LOCK:
        return dict(_LIBRARY)


def reset_counters() -> None:
    with _LOCK:
        for k in _COUNTERS:
            _COUNTERS[k] = 0
            _LIBRARY[k] = 0


# ---------------------------------------------------------------------------
# Gates (the JAX package's ``spark.rapids.sql.native.*``)
# ---------------------------------------------------------------------------

KERNELS = ("radixSort", "joinProbe", "rleDecode", "segmentReduce")
# The counter each gate's kernel and library route count under.
COUNTER_OF = {"radixSort": "radix_sort", "joinProbe": "join_probe",
              "rleDecode": "rle_decode", "segmentReduce": "seg_reduce"}

# Conf-adopted overrides: None falls through to the env, then the default.
_OVERRIDE: Dict[str, Optional[bool]] = dict.fromkeys(("master",) + KERNELS)
_FORCED: Optional[Dict[str, bool]] = None     # tests: the forced() scope


def _env_true(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip() not in ("0", "false", "no", "")


def available() -> bool:
    """A live gate always has a route: the kernel for a CUDA tensor (built
    from the checkout at its first call), the plain version for a CPU one.
    So True; no routing decision reads it."""
    return True


def maybe_configure(conf) -> None:
    """Adopt the explicitly set ``spark.rapids.sql.native.*`` keys for the
    process (unset keys fall back to env / default), as the wire codec
    adopts its key."""
    from spark_rapids_tpu_torch import config as C
    entries = {"master": C.NATIVE_ENABLED, "radixSort": C.NATIVE_RADIX_SORT,
               "joinProbe": C.NATIVE_JOIN_PROBE,
               "rleDecode": C.NATIVE_RLE_DECODE,
               "segmentReduce": C.NATIVE_SEGMENT_REDUCE}
    with _LOCK:
        for name, entry in entries.items():
            raw = conf.raw.get(entry.key)
            _OVERRIDE[name] = None if raw is None else bool(entry.get(conf))


def master_enabled() -> bool:
    if _FORCED is not None:
        return bool(_FORCED.get("master", True))
    with _LOCK:
        ov = _OVERRIDE["master"]
    if ov is not None:
        return ov
    return _env_true("SRT_NATIVE", True)


def kernel_enabled(name: str) -> bool:
    """Is one kernel's gate live (the master gate and its own)? Conf
    beats env (``SRT_NATIVE_<KERNEL>``), env beats the default (on)."""
    assert name in KERNELS, name
    if _FORCED is not None:
        return bool(_FORCED.get("master", True)) and \
            bool(_FORCED.get(name, True)) and available()
    if not master_enabled() or not available():
        return False
    with _LOCK:
        ov = _OVERRIDE[name]
    if ov is not None:
        return ov
    return _env_true(f"SRT_NATIVE_{name.upper()}", True)


def fingerprint() -> Tuple:
    """The live kernels: what a cache of composed steps must fold into its
    keys, so that toggling a gate never serves a step composed under the
    other setting (the JAX package's kernel-cache contract)."""
    live = tuple(k for k in KERNELS if kernel_enabled(k))
    return ("native", live) if live else ()


def gate_counters() -> Dict[str, object]:
    """The JAX package's ``counters()`` gate keys: ``nativeEnabled`` and
    ``nativeKernels`` (the port's :func:`counters` holds launch counts)."""
    return {"nativeEnabled": bool(master_enabled() and available()),
            "nativeKernels": [k for k in KERNELS if kernel_enabled(k)]}


class forced:
    """Test hook: force the gate state for a ``with`` scope.
    ``forced(radixSort=False)`` keeps the master gate on with one kernel
    off; ``forced(master=False)`` turns every kernel off."""

    def __init__(self, **kw: bool):
        self._kw = dict(kw)
        self._prev = None

    def __enter__(self):
        global _FORCED
        self._prev = _FORCED
        _FORCED = self._kw
        return self

    def __exit__(self, *exc):
        global _FORCED
        _FORCED = self._prev
        return False


def _ntiles(n: int, tile: int = TILE_ROWS) -> int:
    return max(-(-n // tile), 1)


def _on_device(t: torch.Tensor):
    """``torch.cuda.device(t.device)`` unless it is the current device
    already (the C entries launch on the current device). Reads the
    current device with ``torch._C._cuda_getDevice``, as
    ``torch.cuda.current_device`` does after its lazy-init check (a CUDA
    tensor implies CUDA is initialized), for a fraction of its host
    cost."""
    if not t.is_cuda or t.get_device() == torch._C._cuda_getDevice():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def _current_stream(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of ``device``'s current stream, without
    building a ``torch.cuda.Stream`` object (which costs several
    microseconds a call)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


# ---------------------------------------------------------------------------
# Plain-PyTorch version of K1: the same steps as the kernel, in torch ops
# ---------------------------------------------------------------------------

def digit_hist_plain(dig: torch.Tensor, tile: int = TILE_ROWS
                     ) -> torch.Tensor:
    """Per-tile 256-bin histogram of ``dig`` (int64 digits), digit-major:
    ``out[d * ntiles + t]`` counts rows of tile ``t`` with digit ``d``
    (each tile's published aggregate)."""
    n = dig.numel()
    ntiles = _ntiles(n, tile)
    tile_idx = torch.arange(n, dtype=torch.int64, device=dig.device) // tile
    return torch.bincount(dig * ntiles + tile_idx, minlength=RADIX * ntiles)


def tile_rank_plain(dig: torch.Tensor, tile: int = TILE_ROWS
                    ) -> torch.Tensor:
    """Stable rank of each row within its tile: the number of earlier
    rows of the same tile with the same digit. The kernel counts it with
    a per-tile one-hot prefix over the 256 digits; here the digit is
    split into two 4-bit halves, so each step's one-hot is 16 wide (no
    sort, a sixteenth of the one-hot's memory): (1) each row's rank among
    the earlier rows of its tile with the same high half places the
    tile's rows stably by that half; (2) in that order the rows of one
    (tile, high half) are contiguous and in row order, and a row's rank
    is the count of the earlier rows of its run with the same low
    half."""
    n = dig.numel()
    dev = dig.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    tile_idx = rows // tile
    hi, lo = (dig >> 4).long(), (dig & 15).long()
    seg = torch.bincount(tile_idx * 16 + hi,
                         minlength=_ntiles(n, tile) * 16).view(-1, 16)
    seg_start = tile_idx * tile + \
        (torch.cumsum(seg, 1) - seg)[tile_idx, hi]
    pos = seg_start + _run_rank16(hi, tile_idx * tile)
    lo_sorted = torch.empty_like(lo)
    lo_sorted[pos] = lo
    start_sorted = torch.empty_like(seg_start)
    start_sorted[pos] = seg_start
    return _run_rank16(lo_sorted, start_sorted)[pos]


def _run_rank16(h: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """For values ``h`` in [0, 16): each row's count of the rows in
    ``[start[i], i)`` with its value (an exclusive one-hot prefix). The
    one-hot is (16, n), so the prefix runs along the inner dimension,
    which a device scans in parallel (along the outer one, torch's scan
    runs each of the 16 columns serially)."""
    n = h.numel()
    vals = torch.arange(16, dtype=h.dtype, device=h.device)
    onehot = (h[None, :] == vals[:, None]).to(torch.int32)
    before = torch.cumsum(onehot, 1, dtype=torch.int32) - onehot
    rows = torch.arange(n, dtype=torch.int64, device=h.device)
    return (before[h, rows] - before[h, start]).to(torch.int64)


def digit_bases_plain(keys: torch.Tensor) -> List[torch.Tensor]:
    """The histogram kernel's result, scanned: for each of the 4 digits,
    the exclusive prefix of its 256-bin histogram over all rows (the
    digit's first output position). A pass only reorders rows, so the
    bases hold for every pass."""
    out = []
    for p in range(RADIX_PASSES):
        hist = torch.bincount((keys >> (8 * p)) & 0xFF, minlength=RADIX)
        out.append(torch.cumsum(hist, 0) - hist)
    return out


def onesweep_pass_plain(keys: torch.Tensor, vals: torch.Tensor, shift: int,
                        base: torch.Tensor, tile: int = TILE_ROWS
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One digit pass: every row goes to its digit's base, plus the
    counts of its digit in earlier tiles (what the look-back sums), plus
    its stable rank within its tile."""
    n = keys.numel()
    ntiles = _ntiles(n, tile)
    dig = (keys >> shift) & 0xFF
    counts = digit_hist_plain(dig, tile).view(RADIX, ntiles)
    prefix = torch.cumsum(counts, 1) - counts + base[:, None]
    tile_idx = torch.arange(n, dtype=torch.int64, device=keys.device) // tile
    pos = prefix[dig, tile_idx] + tile_rank_plain(dig, tile)
    keys_out = torch.empty_like(keys)
    vals_out = torch.empty_like(vals)
    keys_out[pos] = keys
    vals_out[pos] = vals
    return keys_out, vals_out


def stable_argsort_u32_plain(keys: torch.Tensor,
                             perm: Optional[torch.Tensor] = None,
                             tile: int = TILE_ROWS) -> torch.Tensor:
    """The stable permutation sorting u32 ``keys`` (int64 values whose low
    32 bits are the key, or int32 bit patterns) as the kernel computes
    it: the four digit histograms, scanned into bases, then 4 LSD passes
    of 8 bits. Returns int32 row indices; with an int64 row permutation
    ``perm`` it sorts ``keys[perm]`` and returns ``perm[order]`` (int64)."""
    src = keys if perm is None else keys.index_select(0, perm)
    k = src.to(torch.int64) & _M32
    v = torch.arange(k.numel(), dtype=torch.int64, device=k.device)
    bases = digit_bases_plain(k)
    for p in range(RADIX_PASSES):
        k, v = onesweep_pass_plain(k, v, 8 * p, bases[p], tile)
    return v.to(torch.int32) if perm is None else perm.index_select(0, v)


# ---------------------------------------------------------------------------
# CUDA kernel K1 (csrc/radix_rank.cu)
# ---------------------------------------------------------------------------

_LIB = None


def _radix_work_words(n: int) -> int:
    """u32 words of K1's workspace for ``n`` rows: 4 digit histograms, 4
    tile counters, 4 passes of per-tile status words, and two ping-pong
    (key, index) arrays (``srt_radix_sort_work_words``)."""
    return (RADIX_PASSES * RADIX + RADIX_PASSES
            + RADIX_PASSES * _ntiles(n) * RADIX + 4 * n)


def _lib():
    global _LIB
    if _LIB is None:
        from spark_rapids_tpu_torch.ops import cuda_build
        lib = cuda_build.load("radix_rank")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.srt_radix_sort.argtypes = [vp, ci, vp, ci, vp, vp, vp]
        lib.srt_radix_sort.restype = ci
        lib.srt_radix_sort_work_words.argtypes = [ci]
        lib.srt_radix_sort_work_words.restype = ctypes.c_longlong
        lib.srt_cuda_error_string.argtypes = [ci]
        lib.srt_cuda_error_string.restype = ctypes.c_char_p
        lib.srt_radix_tile_rows.restype = ci
        if lib.srt_radix_tile_rows() != TILE_ROWS:
            raise RuntimeError("radix_rank.cu tile size differs from "
                               "native.TILE_ROWS")
        for n in (1, TILE_ROWS, TILE_ROWS + 1, 786_432):
            if lib.srt_radix_sort_work_words(n) != _radix_work_words(n):
                raise RuntimeError("radix_rank.cu workspace size differs "
                                   "from native._radix_work_words")
        _LIB = lib
    return _LIB


def _raise_on(code: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by any kernel's C
    entry; the message comes from the one error-string entry, in
    ``radix_rank.cu``."""
    if code != 0:
        msg = _lib().srt_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _check_sort_args(keys: torch.Tensor,
                     perm: Optional[torch.Tensor]) -> None:
    if keys.dim() != 1:
        raise ValueError(f"stable_argsort_u32 takes 1-D keys, got "
                         f"{tuple(keys.shape)}")
    if keys.dtype not in (torch.int64, torch.int32):
        raise ValueError(f"stable_argsort_u32 takes int64-carried u32 or "
                         f"int32 keys, got {keys.dtype}")
    if not keys.is_contiguous():
        raise ValueError("stable_argsort_u32 takes contiguous keys")
    if perm is not None and (perm.dtype != torch.int64 or perm.dim() != 1
                             or perm.numel() != keys.numel()
                             or not perm.is_contiguous()):
        raise ValueError("perm must be a contiguous 1-D int64 row "
                         "permutation as long as the keys")


def radix_sort(keys: torch.Tensor, perm: Optional[torch.Tensor],
               out: torch.Tensor) -> None:
    """Launch K1 on the current stream, one C call for the whole sort:
    ``out`` gets the stable order of the u32 ``keys`` (int32), or with
    ``perm`` the stable order of ``keys[perm]`` mapped through ``perm``
    (int64). The one place K1's inputs are checked; the workspace is
    allocated here."""
    _check_sort_args(keys, perm)
    n = keys.numel()
    want = torch.int32 if perm is None else torch.int64
    if not keys.is_cuda:
        raise ValueError("keys must be a CUDA tensor")
    if out.dtype != want or out.dim() != 1 or out.numel() != n \
            or not out.is_contiguous() or out.device != keys.device:
        raise ValueError(f"out must be a contiguous ({n},) {want} tensor on "
                         f"the keys' device")
    if perm is not None and perm.device != keys.device:
        raise ValueError("perm and keys lie on different devices")
    if n >= (1 << 30):
        raise ValueError(f"stable_argsort_u32: {n} rows exceed the 30-bit "
                         f"counts of the look-back")
    if n == 0:
        return
    work = torch.empty(_radix_work_words(n), dtype=torch.int32,
                       device=keys.device)
    stream = _current_stream(keys.device)
    _raise_on(_lib().srt_radix_sort(
        keys.data_ptr(), keys.element_size(),
        None if perm is None else perm.data_ptr(), n, out.data_ptr(),
        work.data_ptr(), stream), "radix_sort")
    _count("radix_sort")


def _stable_argsort_u32_cuda(keys: torch.Tensor,
                             perm: Optional[torch.Tensor]) -> torch.Tensor:
    with _on_device(keys):
        out = torch.empty(keys.numel(), device=keys.device,
                          dtype=torch.int32 if perm is None else torch.int64)
        radix_sort(keys, perm, out)
        return out


def stable_argsort_u32(keys: torch.Tensor,
                       perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stable argsort of (cap,) u32 keys, as int32 row indices: the
    unique stable permutation, so bit-identical to
    ``torch.sort(stable=True).indices`` and to the JAX package's
    ``native.stable_argsort_u32``. With an int64 row permutation
    ``perm``, the stable order of ``keys[perm]`` mapped through ``perm``
    (int64): ``_radix_perm``'s gather, sort and gather in one call.

    ``keys`` are int64 tensors whose low 32 bits are the key (the port's
    u32 carrier) or int32 bit patterns. Routes by device only: a CPU
    tensor runs :func:`stable_argsort_u32_plain`, any other goes to kernel
    K1, whose entry :func:`radix_sort` checks the inputs and raises on
    what it cannot launch."""
    if keys.device.type == "cpu":
        _check_sort_args(keys, perm)
        return stable_argsort_u32_plain(keys, perm)
    return _stable_argsort_u32_cuda(keys, perm)


def stable_argsort_u32_library(keys: torch.Tensor,
                               perm: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """K1's library route (its gate off): :func:`stable_argsort_u32`'s
    function as one stable ``torch.sort`` of the keys widened to int64
    (torch sorts no uint32 on the card), on either device."""
    _check_sort_args(keys, perm)
    src = keys if perm is None else keys.index_select(0, perm)
    order = torch.sort(src.to(torch.int64) & _M32, stable=True).indices
    count_library("radix_sort")
    return order.to(torch.int32) if perm is None \
        else perm.index_select(0, order)


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
    fingerprint in the sorted build fingerprints, as int32, by two
    ``torch.searchsorted``: flipping the top bit maps unsigned order onto
    int64's signed order, where ``torch.searchsorted`` works (it takes no
    uint64). K3's plain version, and its library route (its gate off),
    on either device."""
    b = built_fp ^ _INT64_MIN
    q = probe_fp ^ _INT64_MIN
    lo = torch.searchsorted(b, q, side="left").to(torch.int32)
    hi = torch.searchsorted(b, q, side="right").to(torch.int32)
    return lo, hi


# Resident threads an SM holds on Hopper (compute capability 9.0: 2,048,
# CUDA's occupancy tables); K3 sizes its lane count to them.
RESIDENT_THREADS_PER_SM = 2048
# Fewest lanes a probe for which K3's k-ary walk beat its one-lane binary
# walk on an H100 (search_sweep.py, PERF.md section 6).
MIN_KARY_LANES = 8

_PROBE_LIB = None
_SM_COUNT: Dict[int, int] = {}


def probe_lanes(cap_p: int, sm_count: int) -> int:
    """Lanes K3 gives each probe: the largest power of two G in [1, 32]
    with ``cap_p * G`` at most half a wave of resident threads
    (``sm_count * RESIDENT_THREADS_PER_SM / 2``), or 1 (the binary walk)
    where that G is below ``MIN_KARY_LANES``. On 132 SMs: 32 lanes up to
    4,224 probes, 16 at q4's 8,192, 8 up to 16,896, then 1; the fastest
    at every probe count measured (PERF.md, section 6)."""
    fit = sm_count * RESIDENT_THREADS_PER_SM // 2 // max(cap_p, 1)
    lanes = 1 << min(fit.bit_length() - 1, 5) if fit else 1
    return lanes if lanes >= MIN_KARY_LANES else 1


def sm_count(device: torch.device) -> int:
    """SMs of a CUDA device, read once per device."""
    n = _SM_COUNT.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SM_COUNT[device.index] = n
    return n


def _probe_lib():
    global _PROBE_LIB
    if _PROBE_LIB is None:
        from spark_rapids_tpu_torch.ops import cuda_build
        lib = cuda_build.load("join_probe")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.srt_join_probe.argtypes = [vp, ci, vp, ci, vp, vp, ci, vp]
        lib.srt_join_probe.restype = ci
        _PROBE_LIB = lib
    return _PROBE_LIB


def join_probe(built_fp: torch.Tensor, probe_fp: torch.Tensor,
               lo: torch.Tensor, hi: torch.Tensor) -> None:
    """Launch ``join_probe`` on the current stream: ``lo``/``hi`` (int32,
    one per probe row) get the insertion points of ``probe_fp`` in the
    sorted ``built_fp``, with :func:`probe_lanes` lanes a probe. The one
    place K3's inputs are checked."""
    for t, name in ((built_fp, "built_fp"), (probe_fp, "probe_fp")):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int64 tensor "
                             f"(u64 bit patterns), got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.numel() >= (1 << 31):
            raise ValueError(f"{name}: {t.numel()} rows exceed int32 "
                             f"positions")
    if not (built_fp.is_cuda and probe_fp.is_cuda):
        name = "probe_fp" if built_fp.is_cuda else "built_fp"
        raise ValueError(f"{name} must be a CUDA tensor")
    cap_p = probe_fp.numel()
    dev = probe_fp.get_device()
    for t, name in ((lo, "lo"), (hi, "hi")):
        if t.dtype != torch.int32 or t.numel() != cap_p \
                or not t.is_contiguous() or t.get_device() != dev:
            raise ValueError(f"{name} must be a contiguous (cap_p,) int32 "
                             f"tensor on the probe's device")
    if built_fp.get_device() != dev:
        raise ValueError("built_fp and probe_fp lie on different devices")
    if cap_p == 0:
        return
    device = probe_fp.device
    _raise_on(_probe_lib().srt_join_probe(
        built_fp.data_ptr(), built_fp.numel(), probe_fp.data_ptr(), cap_p,
        lo.data_ptr(), hi.data_ptr(), probe_lanes(cap_p, sm_count(device)),
        _current_stream(device)), "join_probe")
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
    if probe_fp.is_cpu:
        return searchsorted_u64_pair_plain(built_fp, probe_fp)
    return _searchsorted_u64_pair_cuda(built_fp, probe_fp)


def _searchsorted_u64_pair_cuda(built_fp: torch.Tensor,
                                probe_fp: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lo`` and ``hi`` are two ``torch.empty`` calls: on an H100's host
    that cost less than one (2, cap_p) allocation cut into its rows, or
    two ``new_empty`` (PERF.md, section 6)."""
    with _on_device(probe_fp):
        n, device = probe_fp.numel(), probe_fp.device
        lo = torch.empty(n, dtype=torch.int32, device=device)
        hi = torch.empty(n, dtype=torch.int32, device=device)
        join_probe(built_fp, probe_fp, lo, hi)
        return lo, hi


# ---------------------------------------------------------------------------
# Kernel K2: the sorted-segment reduce (csrc/seg_scan.cu)
# ---------------------------------------------------------------------------
#
# ``segment_reduce``'s group ids are nondecreasing, so each group is one
# run of rows. The plain version scans every row's running reduction of
# its group so far (``segscan_plain``) and scatters each group's last row
# to the group's slot (``_segment_finish``); the kernel does both in one
# single pass and writes only the slots. Keys are exact: integer sums wrap
# around as two's complement, min/max compare in the total-order bit
# domain (``_minmax_encode``). A u32 key travels as an int32 bit pattern,
# a u64 key as an int64 one; there are no (hi, lo) planes. Float SUMS
# never come here: their reduction order changes rounding.

SEG_TILE_ROWS = 2048    # rows per seg_reduce tile (kTile in seg_scan.cu)
SEG_CHUNK_SLOTS = 8192  # output slots per fill block (kChunk)
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
            s = (a.to(torch.int64) + b.to(torch.int64)) & _M32
            return torch.where(s >= (1 << 31), s - (1 << 32), s) \
                .to(torch.int32)
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


def _segment_finish(running: torch.Tensor, gid: torch.Tensor,
                    capacity: int, identity: int) -> torch.Tensor:
    """Each segment's last running value scattered to its group's slot;
    empty slots keep the (encoded) identity. Slots are unique (gid is
    nondecreasing); ids at or past ``capacity`` go to one extra slot that
    is sliced off (the JAX package's ``mode="drop"``)."""
    is_last = torch.ones(gid.numel(), dtype=torch.bool, device=gid.device)
    is_last[:-1] = gid[1:] != gid[:-1]
    slots = torch.where(is_last, gid, capacity).clamp(max=capacity)
    out = torch.full((capacity + 1,), identity, dtype=running.dtype,
                     device=running.device)
    out[slots] = running
    return out[:capacity]


def seg_reduce_plain(gid: torch.Tensor, keys: torch.Tensor, kind: str,
                     capacity: int, identity: int) -> torch.Tensor:
    """(capacity,) per-group ``kind`` reductions of ``keys`` for the
    nondecreasing int64 ``gid``, empty slots ``identity``: the running
    scan, then the finish, as the JAX package's ``_segscan`` and
    ``_segment_finish``."""
    return _segment_finish(segscan_plain(gid, keys, kind), gid, capacity,
                           identity)


_SEG_LIB = None
# Look-back scratch per (device, stream): zeroed when allocated, and every
# call leaves it zero again (seg_scan.cu), so no call resets it. Calls on
# one stream run one after another, so no two kernels share a scratch;
# PyTorch's pooled streams are never destroyed, so a handle is not taken
# over by another stream. K1's policy, a workspace a call cleared by
# cudaMemsetAsync, cost K2 about 0.01 ms a call at q2's largest launch
# on an H100 (PERF.md, section 6).
_SEG_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, int]] = {}


def _seg_lib():
    global _SEG_LIB
    if _SEG_LIB is None:
        from spark_rapids_tpu_torch.ops import cuda_build
        lib = cuda_build.load("seg_scan")
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.srt_seg_reduce.argtypes = [vp, vp, ci, ci, ci, ll, vp,
                                       ctypes.c_ulonglong, vp, ll, vp]
        lib.srt_seg_reduce.restype = ci
        lib.srt_seg_reduce_scratch_words.argtypes = [ll]
        lib.srt_seg_reduce_scratch_words.restype = ll
        lib.srt_seg_reduce_tile_rows.restype = ci
        lib.srt_seg_reduce_chunk_slots.restype = ci
        if lib.srt_seg_reduce_tile_rows() != SEG_TILE_ROWS \
                or lib.srt_seg_reduce_chunk_slots() != SEG_CHUNK_SLOTS:
            raise RuntimeError("seg_scan.cu tile or chunk size differs "
                               "from native.SEG_TILE_ROWS / SEG_CHUNK_SLOTS")
        _SEG_LIB = lib
    return _SEG_LIB


def _seg_scratch(device: torch.device, stream: int,
                 blocks: int) -> Tuple[torch.Tensor, int]:
    """(scratch, max_blocks) for K2 calls on ``stream``: grown to the next
    power of two of blocks (fill chunks + tiles), zeroed once on that
    stream."""
    key = (device.index, stream)
    hit = _SEG_SCRATCH.get(key)
    if hit is None or hit[1] < blocks:
        most = 1 << max(blocks - 1, 63).bit_length()
        words = _seg_lib().srt_seg_reduce_scratch_words(most)
        hit = (torch.zeros(words, dtype=torch.int32, device=device), most)
        _SEG_SCRATCH[key] = hit
    return hit


def seg_reduce(gid: torch.Tensor, keys: torch.Tensor, kind: str,
               capacity: int, identity: int) -> torch.Tensor:
    """Launch K2 on the current stream, one C call: the (capacity,)
    per-group ``kind`` reductions of ``keys`` over the nondecreasing int64
    ``gid``, empty slots ``identity`` (a bit pattern of the keys' type),
    ids outside [0, capacity) dropped. The one place K2's inputs are
    checked; the output is allocated here, the look-back scratch is the
    stream's."""
    if kind not in _SEG_KIND_CODES:
        raise ValueError(f"seg_reduce: unknown kind {kind!r}")
    for t, name in ((gid, "gid"), (keys, "keys")):
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
    if gid.numel() != n:
        raise ValueError("seg_reduce: gid and keys differ in length")
    if gid.device != keys.device:
        raise ValueError("seg_reduce: tensors lie on different devices")
    if n >= (1 << 31) or not 0 <= capacity < (1 << 31):
        raise ValueError(f"seg_reduce: {n} rows or capacity {capacity} out "
                         f"of range")
    out = torch.empty(capacity, dtype=keys.dtype, device=keys.device)
    if n == 0:
        return out.fill_(identity)
    stream = _current_stream(keys.device)
    scratch, max_blocks = _seg_scratch(
        keys.device, stream,
        -(-n // SEG_TILE_ROWS) + -(-capacity // SEG_CHUNK_SLOTS))
    _raise_on(_seg_lib().srt_seg_reduce(
        gid.data_ptr(), keys.data_ptr(), n, keys.element_size(),
        _SEG_KIND_CODES[kind], capacity, out.data_ptr(), identity & _M64,
        scratch.data_ptr(), max_blocks, stream), "seg_reduce")
    _count("seg_reduce")
    return out


def _segment_reduce(gid: torch.Tensor, keys: torch.Tensor, kind: str,
                    capacity: int, identity: int) -> torch.Tensor:
    """The per-group function. Routes by device only: CPU tensors run
    :func:`seg_reduce_plain`, any other goes to kernel K2, whose entry
    :func:`seg_reduce` checks the inputs and raises on what it cannot
    launch."""
    if keys.device.type == "cpu":
        return seg_reduce_plain(gid, keys, kind, capacity, identity)
    with _on_device(keys):
        return seg_reduce(gid, keys, kind, capacity, identity)


def segment_reduce_library(gid: torch.Tensor, keys: torch.Tensor, kind: str,
                           capacity: int, identity: int) -> torch.Tensor:
    """K2's library route (its gate off): :func:`_segment_reduce`'s
    function as one ``scatter_reduce_`` into an identity-filled output, on
    either device. Min/max keys compare unsigned, so their top bit is
    flipped into signed order and back; ids at or past ``capacity`` land in
    one extra slot that is sliced off. Integer scatters are exact in any
    order (float sums never come here)."""
    if kind not in _SEG_KIND_CODES:
        raise ValueError(f"seg_reduce: unknown kind {kind!r}")
    sign = 0 if kind == "sum" else (
        _INT32_MIN if keys.dtype == torch.int32 else _INT64_MIN)
    # Both are signed bit patterns of the keys' width, so is their xor.
    out = torch.full((capacity + 1,), identity ^ sign, dtype=keys.dtype,
                     device=keys.device)
    out.scatter_reduce_(0, gid.clamp(max=capacity), keys ^ sign,
                        {"sum": "sum", "min": "amin", "max": "amax"}[kind])
    count_library("seg_reduce")
    out = out[:capacity]
    return out ^ sign if sign else out


def _signed(u: int, bits: int) -> int:
    return u - (1 << bits) if u >> (bits - 1) else u


@functools.lru_cache(maxsize=None)
def _encoded_identity(dtype: torch.dtype, kind: str) -> int:
    """The encoded key of the fill an empty group gets, as the key
    tensor's signed bit pattern. It decodes to the JAX package's
    ``jax.ops.segment_min``/``segment_max`` fill (the dtype's max/min,
    +/-inf for floats), and no encoded value beats it: it encodes the
    dtype's extreme (NaN is masked out before the reduction). A pure
    function of its arguments, so cached."""
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
    return _signed((v & _M64) ^ (1 << 63), 64)


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


def segment_sum_sorted(values: torch.Tensor, gid: torch.Tensor,
                       capacity: int, library: bool = False
                       ) -> Optional[torch.Tensor]:
    """Per-group wrap-around sums of integer ``values`` for nondecreasing
    ``gid`` (``jax.ops.segment_sum``'s function), through the segment
    reduce, or with ``library`` (the gate off) its library route. None for
    floats and bools: their sums stay off the exact path."""
    if values.is_floating_point() or values.dtype == torch.bool:
        return None
    reduce = segment_reduce_library if library else _segment_reduce
    if values.element_size() <= 4:
        keys = values.to(torch.int32).contiguous()
        return reduce(gid, keys, "sum", capacity, 0).to(values.dtype)
    return reduce(gid, values.contiguous(), "sum", capacity, 0)


def segment_minmax_sorted(values: torch.Tensor, gid: torch.Tensor,
                          capacity: int, kind: str,
                          library: bool = False) -> torch.Tensor:
    """Per-group min or max of ``values`` for nondecreasing ``gid``
    (``jax.ops.segment_min``/``segment_max``'s function, empty groups
    filled with the dtype's extreme), in the total-order bit domain, by
    the segment reduce or with ``library`` its library route. Every
    numeric dtype encodes, f64 included."""
    if kind not in ("min", "max"):
        raise ValueError(f"segment_minmax_sorted: unknown kind {kind!r}")
    keys, dec = _minmax_encode(values)
    identity = _encoded_identity(values.dtype, kind)
    reduce = segment_reduce_library if library else _segment_reduce
    return dec(reduce(gid, keys.contiguous(), kind, capacity, identity))


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
    JAX package's non-native branch, ``columnar/wire.py:638-648``). K4's
    plain version, and its library route (its gate off), on either
    device."""
    rows = torch.arange(cap, dtype=run_ends.dtype, device=run_ends.device)
    ridx = torch.searchsorted(run_ends, rows, right=True)
    data = run_vals[ridx.clamp(max=run_vals.numel() - 1)]
    return torch.where(rows < num_rows, data, torch.zeros_like(data))


# Runs a table may hold for every K4 block to stage it whole (kSmemRuns in
# rle_decode.cu); a larger table is cut into block windows by searches.
RLE_SMEM_RUNS = 2048

_RLE_LIB = None


def _rle_lib():
    global _RLE_LIB
    if _RLE_LIB is None:
        from spark_rapids_tpu_torch.ops import cuda_build
        lib = cuda_build.load("rle_decode")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.srt_rle_decode.argtypes = [vp, vp, ci, ci, ci, ci, vp, vp]
        lib.srt_rle_decode.restype = ci
        lib.srt_rle_smem_runs.restype = ci
        if lib.srt_rle_smem_runs() != RLE_SMEM_RUNS:
            raise RuntimeError("rle_decode.cu staging size differs from "
                               "native.RLE_SMEM_RUNS")
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
    dev = run_vals.get_device()
    if run_ends.get_device() != dev or out.get_device() != dev:
        raise ValueError("rle_decode: tensors lie on different devices")
    if cap >= (1 << 30) or not 0 <= num_rows <= cap:
        raise ValueError(f"rle_decode: {cap} rows or num_rows={num_rows} "
                         f"out of range")
    if cap == 0:
        return
    _raise_on(_rle_lib().srt_rle_decode(
        run_vals.data_ptr(), run_ends.data_ptr(), run_cap,
        run_vals.element_size(), cap, int(num_rows), out.data_ptr(),
        _current_stream(out.device)), "rle_decode")
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
    if run_vals.is_cpu:
        return rle_decode_plain(run_vals, run_ends, cap, num_rows)
    with _on_device(run_vals):
        # Bytes are bytes: bool moves as uint8.
        vals = run_vals.view(torch.uint8) if run_vals.dtype == torch.bool \
            else run_vals
        out = torch.empty(cap, dtype=vals.dtype, device=vals.device)
        rle_expand(vals, run_ends, num_rows, out)
        return out.view(torch.bool) if run_vals.dtype == torch.bool else out
