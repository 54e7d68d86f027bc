"""Wire codec for host->device uploads: narrow dtypes + packed validity.

Port of the JAX package's ``columnar/wire.py`` (its upload half; the
spill-frame CRC framing stays behind until the memory tier is ported).
Before upload each column is analyzed on the host and, when lossless,
re-encoded to a narrower wire form:

- integers whose [min, max] fits int8/int16/int32 ship narrow;
- float64 columns of whole numbers in int32 range ship as ints, and
  float64 exactly representable as float32 ships as float32;
- low-cardinality columns ship as 1-2 byte codes + a value table
  (``dnum``, ``dstr``);
- codec v2 adds run-length (``rle``), delta and frame-of-reference
  (``for``) encodings, chosen per column by smallest wire size;
- all-valid validity vanishes (rebuilt from the row count); otherwise it
  ships as packed bits.

``spark.rapids.sql.wire.codec`` (``SRT_WIRE_CODEC``) picks ``v2`` (the
default), ``v1`` (dictionary + narrow ints) or ``plain`` (logical dtypes,
untransformed). Every mode is lossless: the decoded device buffers are the
same bytes in all three, and the encoder's specs and staging bytes are the
JAX package's byte for byte.

The encoder takes the reference's decisions by faster host means: the
dictionary factorization is numpy only (first-appearance codes, as
``pandas.factorize(sort=False)`` gives them), a string key of at most 8
bytes is probed as one big-endian ``uint64`` (whose order is the byte
order of the reference's void keys), a dictionary found in the first
``_DICT_SAMPLE`` rows is checked against the whole column by one
``searchsorted``, and the columns of a large batch encode on a small
thread pool (numpy's sorts release the GIL). None of that changes a byte.

All of a batch's wire arrays pack into ONE contiguous 8-byte-aligned
staging buffer with a static offset table, so an upload is one
host->device copy. The device half slices that buffer at the layout's
offsets, reinterprets each slice in place (``view(dtype)``) and widens
with eager torch ops; PyTorch runs eagerly, so the reference's decode-jit
cache has no counterpart. The RLE expansion goes through
``ops/native.py`` ``rle_decode`` (kernel K4 on the card).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import DeviceLike, resolve_device
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, DeviceColumn, bucket_capacity, torch_dtype)
from spark_rapids_tpu_torch.columnar.host import strings_to_matrix

# ---------------------------------------------------------------------------
# Codec mode (spark.rapids.sql.wire.codec / SRT_WIRE_CODEC): process-global,
# adopted per collect; concurrent sessions with conflicting explicit
# settings race to last-write, as in the reference.
# ---------------------------------------------------------------------------

CODEC_MODES = ("plain", "v1", "v2")
_CODEC_OVERRIDE: Optional[str] = None


def codec_mode() -> str:
    if _CODEC_OVERRIDE is not None:
        return _CODEC_OVERRIDE
    env = os.environ.get("SRT_WIRE_CODEC", "").strip().lower()
    return env if env in CODEC_MODES else "v2"


def maybe_configure(conf) -> None:
    """Adopt an explicitly-set ``spark.rapids.sql.wire.codec`` for the
    process (unset clears any prior override back to env/default)."""
    global _CODEC_OVERRIDE
    from spark_rapids_tpu_torch import config as C
    raw = conf.raw.get(C.WIRE_CODEC.key)
    if raw is None:
        _CODEC_OVERRIDE = None
        return
    mode = str(raw).strip().lower()
    if mode not in CODEC_MODES:
        raise ValueError(f"unknown wire codec {raw!r}; "
                         f"expected one of {CODEC_MODES}")
    _CODEC_OVERRIDE = mode


# Process-global transport counters: rawBytes = decoded device footprint
# the plain codec would have shipped, encodedBytes = wire arrays actually
# produced, stagingBytes = packed staging buffers built, uploadTransfers vs
# uploadedBatches = how many copies served how many batches,
# codecCols.<kind> = per-codec column counts.
_WIRE_LOCK = threading.Lock()
_WIRE_COUNTERS: Dict[str, float] = {}


def _wrecord(name: str, amount: float = 1) -> None:
    with _WIRE_LOCK:
        _WIRE_COUNTERS[name] = _WIRE_COUNTERS.get(name, 0) + amount


def counters() -> Dict[str, float]:
    with _WIRE_LOCK:
        out = dict(_WIRE_COUNTERS)
    raw = out.get("rawBytes", 0)
    if raw > 0:
        out["wireCompressionRatio"] = round(
            raw / max(out.get("encodedBytes", raw), 1), 4)
    batches = out.get("uploadedBatches", 0)
    if batches > 0:
        # Fraction of batches that shared a staging transfer with a
        # neighbor (0 = every batch paid its own copy).
        out["stagingHitRate"] = round(
            1.0 - out.get("uploadTransfers", batches) / batches, 4)
    return out


def reset_counters() -> None:
    with _WIRE_LOCK:
        _WIRE_COUNTERS.clear()


# Column wire spec (static, hashable):
#   numeric: ("num", logical_name, wire_np_name, vmode)
#   string:  ("str", width, lengths_np_name, vmode)
#   dict num: ("dnum", logical_name, code_np_name, dict_cap, vmode)
#   dict str: ("dstr", width, code_np_name, dict_cap, vmode)
#   RLE:      ("rle", logical_name, value_np_name, run_cap, vmode)
#   delta:    ("delta", logical_name, delta_np_name, vmode)
#   frame-of-reference: ("for", logical_name, offset_np_name, vmode)
# vmode: "all" (validity == row mask) | "packed" (bit-packed uint8).
# Every decode is a gather, a bitcast or exact integer arithmetic: the
# gathered values ARE the host bit patterns.

_DICT_MAX = 4096            # value-table entries worth a table gather
_DICT_SAMPLE = 1 << 16


def _positions(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``min(searchsorted(u, v), len(u) - 1)`` for ascending distinct
    ``u``: for a small ``u`` a count of the values below each row, one
    compare pass per value (numpy's searchsorted takes tens of ns a row
    on unsorted needles), else a binary search."""
    if len(u) <= 32:
        pos = np.zeros(len(v), np.int8)
        for x in u[:-1]:
            pos += v > x
        return pos
    pos = np.searchsorted(u, v)
    np.minimum(pos, len(u) - 1, out=pos)
    return pos


def _first_rows(pos: np.ndarray) -> np.ndarray:
    """The first row of each position, by position, when every position
    occurs in the first ``_DICT_SAMPLE`` rows (a stable int16 sort of
    that prefix)."""
    head = pos[:_DICT_SAMPLE].astype(np.int16)
    order = np.argsort(head, kind="stable")
    grp = head[order]
    starts = np.flatnonzero(np.concatenate(
        [np.ones(1, np.bool_), grp[1:] != grp[:-1]]))
    return order[starts]


def _sorted_codes(v: np.ndarray):
    """(uniq, pos, first): the distinct values of ``v`` in ascending
    order (``np.unique``'s), each row's position among them, and each
    distinct value's first row; None when the first ``_DICT_SAMPLE`` rows
    already hold more than ``_DICT_MAX // 4`` distinct values, or the
    column more than ``_DICT_MAX``. Values compare by value: callers
    exclude NaN and -0.0.

    When the prefix holds every distinct value (checked on the whole
    column), the first rows all lie in the prefix; otherwise the whole
    column is sorted."""
    u = np.unique(v[:_DICT_SAMPLE])
    if len(u) > _DICT_MAX // 4:
        return None
    pos = _positions(u, v)
    if np.array_equal(u[pos], v):
        return u, pos, _first_rows(pos)
    u, first, pos = np.unique(v, return_index=True, return_inverse=True)
    if len(u) > _DICT_MAX:
        return None
    return u, pos, first


def _try_dict(values: np.ndarray, n: int):
    """(codes, uniques) as ``pandas.factorize(sort=False)`` gives them (the
    distinct values numbered in order of first appearance) when
    cardinality is low enough to pay off, else None (values prefiltered
    for NaN and -0.0; nulls were zeroed upstream)."""
    if n == 0:
        return None
    v = values[:n]
    if values.dtype.kind == "f":
        # a by-value dictionary would drop the sign bit of -0.0.
        if not np.isfinite(v).all() or np.any((v == 0) & np.signbit(v)):
            return None
    r = _sorted_codes(v)
    if r is None:
        return None
    u, pos, first = r
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(u), np.intp)
    rank[order] = np.arange(len(u))
    return rank[pos], u[order]


_INT_CANDIDATES = (
    (np.int8, -128, 127),
    (np.int16, -32768, 32767),
    (np.int32, -(2 ** 31), 2 ** 31 - 1),
)


def _narrow_int(values: np.ndarray, itemsize: int):
    """Smallest int dtype whose range covers values (None = keep)."""
    if values.size == 0:
        return np.int8
    mn = values.min()
    mx = values.max()
    for cand, lo, hi in _INT_CANDIDATES:
        if np.dtype(cand).itemsize >= itemsize:
            return None
        if lo <= mn and mx <= hi:
            return cand
    return None


_PROBE_ROWS = 4096


def _encode_float64(values: np.ndarray):
    """Returns (wire_array, wire_np_name) or None. Lossless only, and the
    device decode must be a pure CAST: whole numbers in int32 range ship
    as narrow ints; exactly-f32-representable ships as f32. NaN/inf/-0.0
    disqualify the int path (-0.0 would become +0.0)."""
    # Each test must hold on every row, so a failure in the first
    # _PROBE_ROWS rows decides it without the full pass.
    head = values[:_PROBE_ROWS]
    with np.errstate(invalid="ignore"):
        finite = np.isfinite(values).all() if values.size else True
    if finite and np.array_equal(np.rint(head), head) \
            and not (values.size
                     and np.any((values == 0) & np.signbit(values))):
        r = np.rint(values)
        if not np.any(np.abs(r) > 2 ** 31 - 1) \
                and np.array_equal(r, values):
            narrow = _narrow_int(r, 8) or np.int32
            return r.astype(narrow), np.dtype(narrow).name
    with np.errstate(over="ignore"):
        if not np.array_equal(head.astype(np.float32).astype(np.float64),
                              head):
            return None
        f32 = values.astype(np.float32)
    if np.array_equal(f32.astype(np.float64), values):
        return f32, "float32"
    return None


# -- codec v2 candidates ------------------------------------------------------
# Each _try_* returns (wire_arrays, spec_tail, wire_bytes) or None. They
# compete on wire_bytes against the typed/dict encodings.

def _bit_view(v: np.ndarray) -> np.ndarray:
    """Float values as their bit patterns (run/equality detection must
    distinguish -0.0 from 0.0 and NaN payloads; int passthrough)."""
    if v.dtype.kind == "f":
        return v.view(np.int32 if v.dtype.itemsize == 4 else np.int64)
    return v


def _try_rle(wire: np.ndarray, n: int, cap: int):
    """Run-length encoding over the (already narrowed) wire values: run
    values + ascending exclusive run-end offsets. Decode expands the run
    table (kernel K4). Worth it only when runs are rare."""
    if n < 8:
        return None
    v = wire[:n]
    bits = _bit_view(v)
    starts = np.empty(n, np.bool_)
    starts[0] = True
    np.not_equal(bits[1:], bits[:-1], out=starts[1:])
    runs = int(starts.sum())
    if runs > n // 4:
        return None
    run_cap = bucket_capacity(max(runs, 1))
    sidx = np.flatnonzero(starts)
    run_vals = np.zeros(run_cap, v.dtype)
    run_vals[:runs] = v[sidx]
    # Exclusive end of run i; padding entries sit at cap so padding rows
    # index past the real runs into zeroed table slots.
    ends = np.full(run_cap, cap, np.int32)
    if runs > 1:
        ends[:runs - 1] = sidx[1:]
    ends[runs - 1] = n
    nbytes = run_cap * (v.dtype.itemsize + 4)
    return [run_vals, ends], (v.dtype.name, run_cap), nbytes


def _smallest_int(lo: int, hi: int, max_itemsize: int):
    """Smallest signed int dtype strictly narrower than ``max_itemsize``
    covering [lo, hi], or None."""
    for cand, clo, chi in _INT_CANDIDATES:
        if np.dtype(cand).itemsize >= max_itemsize:
            return None
        if clo <= lo and hi <= chi:
            return cand
    return None


def _try_delta(wire: np.ndarray, n: int, cap: int):
    """Delta encoding for monotone/smooth integer columns: int64 base +
    narrow int deltas, decoded by an int64 cumsum. Two's-complement wrap
    is identical between numpy and torch, and the encoder verifies the
    reconstruction before committing."""
    if n < 8 or wire.dtype.kind != "i" or wire.dtype.itemsize < 4:
        return None
    v64 = wire[:n].astype(np.int64)
    d = np.diff(v64)
    if d.size == 0:
        return None
    narrow = _smallest_int(int(d.min()), int(d.max()), wire.dtype.itemsize)
    if narrow is None:
        return None
    # Round-trip proof (covers any int64 diff wraparound): base +
    # cumsum(deltas) must reproduce the values bit-for-bit.
    if not np.array_equal(
            v64[0] + np.concatenate([np.zeros(1, np.int64),
                                     d]).cumsum(dtype=np.int64), v64):
        return None
    deltas = np.zeros(cap, narrow)
    deltas[1:n] = d.astype(narrow)
    base = np.asarray([v64[0]], np.int64)
    nbytes = 8 + cap * np.dtype(narrow).itemsize
    return [base, deltas], (np.dtype(narrow).name,), nbytes


_FOR_CANDIDATES = ((np.uint8, 0xFF), (np.uint16, 0xFFFF),
                   (np.uint32, 0xFFFFFFFF))


def _try_for(wire: np.ndarray, n: int, cap: int):
    """Frame-of-reference narrowing for clustered integers far from zero
    (dense id bands): int64 base = min + narrow unsigned offsets, decoded
    by one exact integer add."""
    if n == 0 or wire.dtype.kind != "i" or wire.dtype.itemsize < 4:
        return None
    v = wire[:n]
    vmin, vmax = int(v.min()), int(v.max())
    span = vmax - vmin
    narrow = None
    for cand, hi in _FOR_CANDIDATES:
        if np.dtype(cand).itemsize >= wire.dtype.itemsize:
            break
        if span <= hi:
            narrow = cand
            break
    if narrow is None:
        return None
    offsets = np.zeros(cap, narrow)
    offsets[:n] = (v - vmin).astype(narrow)
    base = np.asarray([vmin], np.int64)
    nbytes = 8 + cap * np.dtype(narrow).itemsize
    return [base, offsets], (np.dtype(narrow).name,), nbytes


def encode_column(hc, name: str, n: int, cap: int,
                  string_widths: Optional[dict],
                  mode: Optional[str] = None) -> Tuple[List[np.ndarray],
                                                       tuple]:
    """Host-side encode of one column -> (wire arrays, static spec),
    under ``mode`` (None: the active codec mode). Counters record the
    decoded (raw) footprint vs the wire bytes and the chosen codec
    kind."""
    arrs, spec = _encode_column_impl(hc, name, n, cap, string_widths,
                                     mode or codec_mode())
    raw = cap * (hc.dtype.itemsize + 1)
    if hc.dtype.is_string:
        raw = cap * (spec[1] + 4 + 1)      # matrix + lengths + validity
    _wrecord("rawBytes", raw)
    _wrecord("encodedBytes", sum(a.nbytes for a in arrs))
    _wrecord(f"codecCols.{spec[0]}")
    return arrs, spec


# Odd 64-bit multiplier folding a wide string key's words into one probe.
_FOLD = np.uint64(0x9E3779B97F4A7C15)


def _string_dict(hc, m0: np.ndarray, lens0: np.ndarray, n: int):
    """(codes, first_idx) of the rows' (big-endian length | content)
    keys: codes number the distinct keys in bytewise order and first_idx
    is each one's first row, as ``np.unique`` over the reference's void
    keys gives them; None when the column has too many distinct keys.

    The key, zero-padded to 8-byte words, is read as big-endian uint64
    words, whose lexicographic order is the bytewise order. A one-word
    key is its own probe. A wider key is probed by a fold of its words;
    every row is then checked against the first row of its probe value,
    so a fold collision or a key beyond the sampled prefix falls back to
    the reference's void-key ``np.unique``."""
    mw = m0.shape[1]
    nk = mw + 4
    nwords = -(-nk // 8)
    keyed = np.zeros((n, 8 * nwords), np.uint8)
    keyed.view(">u4")[:, 0] = lens0
    if mw:
        keyed[:, 4:nk] = np.where(hc.validity[:, None], m0[:n], 0)
    words = keyed.view(">u8").astype(np.uint64)
    if nwords == 1:
        r = _sorted_codes(words[:, 0])
        return None if r is None else r[1:]
    probe = words[:, 0].copy()
    for j in range(1, nwords):
        probe *= _FOLD
        probe += words[:, j]
    u = np.unique(probe[:_DICT_SAMPLE])
    if len(u) > _DICT_MAX // 4:
        return None                 # more distinct keys than probes
    pos = _positions(u, probe)
    if np.array_equal(u[pos], probe):
        first = _first_rows(pos)
        if np.array_equal(keyed, keyed[first][pos]):
            order = np.lexsort(words[first].T[::-1])
            rank = np.empty(len(u), np.intp)
            rank[order] = np.arange(len(u))
            return rank[pos], first[order]
    key = np.ascontiguousarray(keyed[:, :nk]).view([("k", f"V{nk}")]) \
        .ravel()
    if len(np.unique(key[:_DICT_SAMPLE])) > _DICT_MAX // 4:
        return None
    uniq, first_idx, codes = np.unique(key, return_index=True,
                                       return_inverse=True)
    return (codes, first_idx) if len(uniq) <= _DICT_MAX else None


def _encode_column_impl(hc, name: str, n: int, cap: int,
                        string_widths: Optional[dict], mode: str
                        ) -> Tuple[List[np.ndarray], tuple]:
    validity = np.zeros(cap, dtype=np.bool_)
    validity[:n] = hc.validity
    all_valid = bool(validity[:n].all())
    if all_valid:
        vmode, varrs = "all", []
    else:
        vmode = "packed"
        varrs = [np.packbits(validity, bitorder="little")]

    if hc.dtype.is_string:
        # Dictionary path first: a low-cardinality string column (flags,
        # modes, segments) ships 1-2 byte codes + a tiny value table
        # instead of a (rows x width) byte matrix.
        m0, lens0 = strings_to_matrix(hc)
        lens0 = np.where(hc.validity, lens0, 0).astype(np.int32)
        mw = m0.shape[1]
        d = None
        if n and mode != "plain":
            d = _string_dict(hc, m0, lens0, n)
        if d is not None:
            codes, first_idx = d
            k = len(first_idx)
            ulens = lens0[first_idx]
            want = dt.string_width_bucket(int(ulens.max()) if k else 0)
            if string_widths and name in string_widths:
                want = max(want, string_widths[name])
            # The all-zero key (empty/invalid rows) is the code padding
            # rows take; add one if the column had no empty strings.
            zeros = np.flatnonzero(ulens == 0)
            dict_rows = list(first_idx)
            if zeros.size:
                zero_code = int(zeros[0])
            else:
                dict_rows.append(None)
                zero_code = k
                k += 1
            dict_cap = 8
            while dict_cap < k:
                dict_cap *= 2
            table = np.zeros((dict_cap, want), dtype=np.uint8)
            len_t = np.int16 if want <= 32767 else np.int32
            len_table = np.zeros(dict_cap, dtype=len_t)
            w = min(want, mw)
            for i, ri in enumerate(dict_rows):
                if ri is None:
                    continue
                if w:
                    table[i, :w] = np.where(hc.validity[ri],
                                            m0[ri, :w], 0)
                len_table[i] = min(int(ulens[i]) if i < len(ulens)
                                   else 0, want)
            code_t = np.int8 if dict_cap <= 128 else np.int16
            codes_arr = np.full(cap, zero_code, dtype=code_t)
            codes_arr[:n] = codes
            return [codes_arr, table, len_table] + varrs, \
                ("dstr", want, np.dtype(code_t).name, dict_cap, vmode)
        m, lens = m0, lens0
        lens = np.where(hc.validity, lens, 0)
        want = dt.string_width_bucket(int(lens.max()) if n else 0)
        if string_widths and name in string_widths:
            want = max(want, string_widths[name])
        data = np.zeros((cap, want), dtype=np.uint8)
        w = min(want, m.shape[1])
        data[:n, :w] = np.where(hc.validity[:, None], m, 0)[:, :w]
        # Lengths are bounded by the column width: int16 only when the
        # width itself fits (a >32767-byte string would otherwise wrap).
        len_t = np.int16 if want <= 32767 else np.int32
        lengths = np.zeros(cap, dtype=len_t)
        lengths[:n] = lens
        return [data, lengths] + varrs, ("str", want,
                                         np.dtype(len_t).name, vmode)

    values = np.where(hc.validity, hc.data,
                      np.zeros(1, hc.dtype.np_dtype)) \
        .astype(hc.dtype.np_dtype, copy=False)
    wire = values
    wire_name = hc.dtype.np_dtype.name
    if mode != "plain":
        if hc.dtype.np_dtype == np.float64:
            enc = _encode_float64(values)
            if enc is not None:
                wire, wire_name = enc
        elif hc.dtype.np_dtype.kind == "i":
            narrow = _narrow_int(values, hc.dtype.itemsize)
            if narrow is not None:
                wire = values.astype(narrow)
                wire_name = np.dtype(narrow).name
    # v2: RLE / frame-of-reference / delta compete with the typed wire
    # (and the dictionary below) on wire bytes.
    best = None                     # (arrays, spec) of the leader
    best_bytes = cap * wire.dtype.itemsize
    if mode == "v2":
        r = _try_rle(wire, n, cap)
        if r is not None and r[2] < best_bytes:
            arrs, (val_name, run_cap), best_bytes = r
            best = (arrs, ("rle", hc.dtype.name, val_name, run_cap, vmode))
        f = _try_for(wire, n, cap)
        if f is not None and f[2] < best_bytes:
            arrs, (off_name,), best_bytes = f
            best = (arrs, ("for", hc.dtype.name, off_name, vmode))
        dl = _try_delta(wire, n, cap)
        if dl is not None and dl[2] < best_bytes:
            arrs, (d_name,), best_bytes = dl
            best = (arrs, ("delta", hc.dtype.name, d_name, vmode))
    if mode != "plain" and wire.dtype.itemsize > 2:
        # Dictionary beats the typed wire only when codes are narrower
        # than the narrowed values (a 0.00..0.10 f64 discount ships int8).
        d = _try_dict(values, n)
        if d is not None:
            codes, uniques = d
            uniques = list(uniques)
            zero = hc.dtype.np_dtype.type(0)
            zero_code = next((i for i, u in enumerate(uniques)
                              if u == zero and not (
                                  isinstance(u, float)
                                  and np.signbit(u))), None)
            if zero_code is None:
                uniques.append(zero)
                zero_code = len(uniques) - 1
            dict_cap = 8
            while dict_cap < len(uniques):
                dict_cap *= 2
            code_t = np.int8 if dict_cap <= 128 else np.int16
            dict_bytes = cap * np.dtype(code_t).itemsize \
                + dict_cap * hc.dtype.itemsize
            ok = np.dtype(code_t).itemsize < wire.dtype.itemsize \
                if mode == "v1" else dict_bytes < best_bytes
            if ok:
                table = np.zeros(dict_cap, dtype=hc.dtype.np_dtype)
                table[:len(uniques)] = uniques
                codes_arr = np.full(cap, zero_code, dtype=code_t)
                codes_arr[:n] = codes
                return [codes_arr, table] + varrs, \
                    ("dnum", hc.dtype.name, np.dtype(code_t).name,
                     dict_cap, vmode)
    if best is not None:
        return best[0] + varrs, best[1]
    data = np.zeros(cap, dtype=wire.dtype)
    data[:n] = wire
    return [data] + varrs, ("num", hc.dtype.name, wire_name, vmode)


# Batches of at least this many rows encode their columns on the pool.
_POOL_MIN_ROWS = 1 << 16
_POOL: Optional[concurrent.futures.ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def _pool() -> concurrent.futures.ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        with _POOL_LOCK:
            if _POOL is None:
                _POOL = concurrent.futures.ThreadPoolExecutor(
                    max(1, min(8, os.cpu_count() or 1)),
                    thread_name_prefix="wire-encode")
    return _POOL


def encode_batch(batch, capacity: Optional[int] = None,
                 string_widths: Optional[dict] = None,
                 mode: Optional[str] = None):
    """Host-side half of the upload: analyze + narrow + pad. Returns
    (arrays, specs, n, cap). The columns of a large batch encode
    concurrently; their arrays keep column order."""
    n = batch.num_rows
    cap = capacity if capacity is not None else bucket_capacity(n)
    assert cap >= n, f"capacity {cap} < rows {n}"
    cols = list(zip(batch.names, batch.columns))
    if n >= _POOL_MIN_ROWS and len(cols) > 1:
        futs = [_pool().submit(encode_column, hc, name, n, cap,
                               string_widths, mode) for name, hc in cols]
        encoded = [f.result() for f in futs]
    else:
        encoded = [encode_column(hc, name, n, cap, string_widths, mode)
                   for name, hc in cols]
    arrays: List[np.ndarray] = []
    specs = []
    for arrs, spec in encoded:
        arrays.extend(arrs)
        specs.append(spec)
    arrays.append(np.asarray(n, np.int32))
    return arrays, tuple(specs), n, cap


# ---------------------------------------------------------------------------
# Staging buffer: all of a batch's wire arrays packed into ONE contiguous
# uint8 buffer with a static, 8-byte-aligned offset table derived purely
# from (capacity, specs).
# ---------------------------------------------------------------------------

def _align8(off: int) -> int:
    return (off + 7) & ~7


def _column_layout(spec, cap: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """(np dtype name, shape) of every wire array ``spec`` produces, in
    encode order. MUST mirror encode_column exactly; pack_encoded asserts
    each array against this derivation."""
    kind = spec[0]
    if kind == "num":
        _, _logical, wire_name, vmode = spec
        arrs = [(wire_name, (cap,))]
    elif kind == "dnum":
        _, logical, code_name, dict_cap, vmode = spec
        arrs = [(code_name, (cap,)),
                (dt.type_named(logical).np_dtype.name, (dict_cap,))]
    elif kind == "rle":
        _, _logical, val_name, run_cap, vmode = spec
        arrs = [(val_name, (run_cap,)), ("int32", (run_cap,))]
    elif kind in ("delta", "for"):
        _, _logical, nname, vmode = spec
        arrs = [("int64", (1,)), (nname, (cap,))]
    elif kind == "str":
        _, width, len_name, vmode = spec
        arrs = [("uint8", (cap, width)), (len_name, (cap,))]
    elif kind == "dstr":
        _, width, code_name, dict_cap, vmode = spec
        len_name = "int16" if width <= 32767 else "int32"
        arrs = [(code_name, (cap,)), ("uint8", (dict_cap, width)),
                (len_name, (dict_cap,))]
    else:                               # pragma: no cover - spec typo
        raise AssertionError(f"unknown wire spec kind {kind!r}")
    if vmode == "packed":
        arrs.append(("uint8", ((cap + 7) // 8,)))
    return arrs


def _batch_layout(cap: int, specs: tuple):
    """[(offset, np name, shape, nbytes)] for every wire array plus the
    trailing num_rows scalar, with every offset 8-byte aligned, and the
    aligned total staging size."""
    entries = []
    for spec in specs:
        entries.extend(_column_layout(spec, cap))
    entries.append(("int32", ()))          # num_rows scalar
    out = []
    off = 0
    for name, shape in entries:
        count = 1
        for s in shape:
            count *= s
        nbytes = int(np.dtype(name).itemsize * count)
        out.append((off, name, shape, nbytes))
        off = _align8(off + nbytes)
    return out, off


@dataclasses.dataclass
class EncodedBatch:
    """A batch's wire image, packed and ready for one host->device copy."""

    staging: np.ndarray         # (total,) uint8, offsets 8-byte aligned
    specs: tuple
    n: int
    cap: int

    @property
    def nbytes(self) -> int:
        return self.staging.nbytes


def pack_encoded(arrays, specs, n: int, cap: int) -> EncodedBatch:
    """Pack a batch's wire arrays into one aligned staging buffer; the
    capacity/spec validation happens here, once per batch."""
    entries, total = _batch_layout(cap, specs)
    assert len(arrays) == len(entries), \
        f"wire layout mismatch: {len(arrays)} arrays vs " \
        f"{len(entries)} layout entries for specs {specs!r}"
    buf = np.zeros(total, np.uint8)
    for a, (off, name, shape, nbytes) in zip(arrays, entries):
        a = np.asarray(a)
        assert a.dtype == np.dtype(name) and a.shape == tuple(shape), \
            f"wire array {a.dtype}{a.shape} != layout {name}{shape}"
        # 8-byte alignment is load-bearing: the device side reinterprets
        # each slice in place, which needs an aligned offset.
        assert off % 8 == 0, f"staging offset {off} not 8-byte aligned"
        if nbytes:
            buf[off:off + nbytes] = \
                np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    _wrecord("stagingBytes", total)
    _wrecord("stagingBuffers")
    return EncodedBatch(buf, tuple(specs), n, cap)


def pack_batch(batch, capacity: Optional[int] = None,
               string_widths: Optional[dict] = None,
               mode: Optional[str] = None) -> EncodedBatch:
    """encode + pack: the complete host half of an upload."""
    return pack_encoded(*encode_batch(batch, capacity, string_widths,
                                      mode))


# ---------------------------------------------------------------------------
# Device half: slice the staged buffer, reinterpret, widen (eager torch).
# ---------------------------------------------------------------------------

# Torch element type each wire array is reinterpreted as. torch's uint16 /
# uint32 support is partial, so the frame-of-reference offsets are viewed
# as their signed twins and masked after widening to int64.
_WIRE_TORCH = {"int8": torch.int8, "int16": torch.int16,
               "int32": torch.int32, "int64": torch.int64,
               "float32": torch.float32, "float64": torch.float64,
               "uint8": torch.uint8, "uint16": torch.int16,
               "uint32": torch.int32}
_UNSIGNED_MASK = {"uint16": 0xFFFF, "uint32": 0xFFFFFFFF}


def _unpack_array(staged: torch.Tensor, off: int, name: str, shape,
                  nbytes: int) -> torch.Tensor:
    seg = staged[off:off + nbytes]
    if name == "bool":
        return (seg != 0).reshape(shape)
    return seg.view(_WIRE_TORCH[name]).reshape(shape)


def _unpack_validity(bits: torch.Tensor, cap: int) -> torch.Tensor:
    """Inverse of np.packbits(bitorder='little'): (cap/8,) uint8 -> bool."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    opened = (bits[:, None] >> shifts[None, :]) & 1
    return opened.reshape(-1)[:cap].to(torch.bool)


def _widen(x: torch.Tensor, logical: dt.DataType) -> torch.Tensor:
    """Pure cast to the logical element type (exact for every wire
    type the encoder picks)."""
    t = torch_dtype(logical)
    return x if x.dtype == t else x.to(t)


def _decode(arrays: List[torch.Tensor], num_rows: torch.Tensor, n: int,
            cap: int, specs: tuple) -> DeviceBatch:
    """Widen a batch's unpacked wire arrays to the device layout.
    ``num_rows`` is the staged 0-d count; ``n`` is the same count on the
    host, so no decode step syncs."""
    from spark_rapids_tpu_torch.ops import native
    it = iter(arrays)
    dev = num_rows.device
    rows = torch.arange(cap, dtype=torch.int32, device=dev)
    live = rows < n
    cols = []

    def valid_of(vmode):
        if vmode == "packed":
            return _unpack_validity(next(it), cap)
        return live

    for spec in specs:
        kind = spec[0]
        if kind == "dnum":
            _, logical_name, _code_name, dict_cap, vmode = spec
            codes = next(it).to(torch.int64).clamp(0, dict_cap - 1)
            table = next(it)
            data = _widen(table[codes], dt.type_named(logical_name))
            cols.append(DeviceColumn(dt.type_named(logical_name), data,
                                     valid_of(vmode)))
        elif kind == "dstr":
            _, _width, _code_name, dict_cap, vmode = spec
            codes = next(it).to(torch.int64).clamp(0, dict_cap - 1)
            table = next(it)
            len_table = next(it).to(torch.int32)
            cols.append(DeviceColumn(dt.STRING, table[codes],
                                     valid_of(vmode), len_table[codes]))
        elif kind == "rle":
            _, logical_name, _val_name, _run_cap, vmode = spec
            logical = dt.type_named(logical_name)
            run_vals = next(it)
            run_ends = next(it)
            # Expanded in the wire dtype (padding rows zeroed), then the
            # same pure cast as a typed column.
            data = _widen(native.rle_decode(run_vals, run_ends, cap, n),
                          logical)
            cols.append(DeviceColumn(logical, data, valid_of(vmode)))
        elif kind in ("delta", "for"):
            _, logical_name, nname, vmode = spec
            logical = dt.type_named(logical_name)
            base = next(it)                 # (1,) int64
            off = next(it).to(torch.int64)
            if nname in _UNSIGNED_MASK:
                off = off & _UNSIGNED_MASK[nname]
            if kind == "delta":
                off = torch.cumsum(off, 0)  # exact int64, wraps like numpy
            vals = torch.where(live, base + off, torch.zeros_like(off))
            cols.append(DeviceColumn(logical, _widen(vals, logical),
                                     valid_of(vmode)))
        elif kind == "str":
            _, _width, _len_name, vmode = spec
            data = next(it)
            lengths = next(it).to(torch.int32)
            cols.append(DeviceColumn(dt.STRING, data, valid_of(vmode),
                                     lengths))
        else:
            _, logical_name, _wire_name, vmode = spec
            logical = dt.type_named(logical_name)
            data = _widen(next(it), logical)
            cols.append(DeviceColumn(logical, data, valid_of(vmode)))
    return DeviceBatch(tuple(cols), num_rows)


def _decode_staged(staged: torch.Tensor, enc: EncodedBatch) -> DeviceBatch:
    """Unpack one batch's staged buffer (slices + in-place bitcasts) and
    widen it to the logical layout."""
    entries, _total = _batch_layout(enc.cap, enc.specs)
    arrays = [_unpack_array(staged, off, name, shape, nbytes)
              for off, name, shape, nbytes in entries]
    out = _decode(arrays[:-1], arrays[-1], enc.n, enc.cap, enc.specs)
    out.rows_hint = enc.n
    return out


def upload_packed(enc: EncodedBatch, device: DeviceLike = None
                  ) -> DeviceBatch:
    """Device half: ONE host->device copy of the staging buffer, then the
    eager unpack-and-decode on ``device`` (``None`` = the CUDA card,
    raising when there is none)."""
    dev = resolve_device(device)
    # A copy on the CPU too: the decoded columns view the staged bytes,
    # and a source keeps its EncodedBatches across collects.
    staged = torch.from_numpy(enc.staging).to(dev, copy=True)
    out = _decode_staged(staged, enc)
    _wrecord("uploadTransfers")
    _wrecord("uploadedBatches")
    return out


def upload_packed_group(encs: Sequence[EncodedBatch],
                        device: DeviceLike = None) -> List[DeviceBatch]:
    """Upload SEVERAL packed batches in one copy (the tiny-batch
    coalescing path, wire.minUploadBytes): staging buffers concatenate
    (each already 8-aligned), cross the link once, and each member
    decodes off its on-device slice -- same bytes, same decode,
    bit-identical to per-batch uploads."""
    encs = list(encs)
    if not encs:
        return []
    if len(encs) == 1:
        return [upload_packed(encs[0], device)]
    dev = resolve_device(device)
    combined = np.concatenate([e.staging for e in encs])
    staged_all = torch.from_numpy(combined).to(dev)
    _wrecord("uploadTransfers")
    _wrecord("uploadedBatches", len(encs))
    _wrecord("groupedUploads")
    outs: List[DeviceBatch] = []
    off = 0
    for enc in encs:
        outs.append(_decode_staged(staged_all[off:off + enc.nbytes], enc))
        off += enc.nbytes
    return outs


def plan_upload_groups(sizes: Sequence[int],
                       min_bytes: int) -> List[List[int]]:
    """Group consecutive upload indices so members below ``min_bytes``
    share a transfer: tiny batches accumulate until the group reaches the
    threshold; a batch at/above it always ships alone. Deterministic --
    depends only on the sizes."""
    groups: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, s in enumerate(sizes):
        if s >= min_bytes:
            if cur:
                groups.append(cur)
                cur, cur_bytes = [], 0
            groups.append([i])
            continue
        cur.append(i)
        cur_bytes += s
        if cur_bytes >= min_bytes:
            groups.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        groups.append(cur)
    return groups


def upload(batch, capacity: Optional[int] = None,
           string_widths: Optional[dict] = None,
           device: DeviceLike = None,
           mode: Optional[str] = None) -> DeviceBatch:
    """Encode + pack + one host->device copy + the on-device widen, under
    ``mode`` (None: the active codec mode)."""
    return upload_packed(pack_batch(batch, capacity, string_widths, mode),
                         device)
