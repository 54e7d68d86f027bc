"""String expressions (port of the JAX package's ``exprs/strings.py``).

A string column is a dense ``(N, W)`` uint8 matrix plus int32 lengths
(``columnar/batch.py``). Every device op is dense work over that matrix,
with no per-row loop: torch on the device, numpy over the host byte
matrix (``eval_host``, either host string layout). Most kernels are
written once against the array module ``xp`` (``torch`` or ``np``), as
the reference writes them against ``jnp`` or ``np``.

- ``upper`` / ``lower`` / ``initcap``: a branchless ASCII case flip (the
  reference's incompat: locale-sensitive casing is ASCII-only).
- ``length`` / ``substring`` / ``reverse``: UTF-8 aware through the lead
  byte mask ``(b & 0xC0) != 0x80`` and its running sums; ``reverse``
  sorts each row on (reversed character ordinal, byte within character).
- ``contains`` / ``startswith`` / ``endswith`` / ``locate`` / ``like`` /
  ``substring_index`` / ``split``: a sliding-window equality over the
  width axis (``O(W * |needle|)``); ``substring_index`` and ``split``
  pick Java's greedy non-overlapping occurrences with a scan over the
  width (``_greedy_matches``: a loop of W steps on the device).
- ``trim`` / ``substring`` / ``substring_index`` / ``split`` pack the kept
  bytes of each row to its left with a stable sort on the keep mask.
- ``concat`` / ``concat_ws`` / ``repeat`` grow the width to the sum of
  their inputs' widths (``w * k`` for repeat), as the reference does.

``replace``, ``regexp_replace``, ``regexp_extract``, ``translate``,
``lpad`` and ``rpad`` run on the host inside a device plan (``re`` and a
per-row loop), the boundary the reference draws: their device half is a
counted roundtrip (``exprs.base.host_roundtrip``), as is a LIKE pattern
with ``_``.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.columnar.host import (
    HostColumn, all_valid, matrix_to_strings, strings_to_matrix)
from spark_rapids_tpu_torch.exprs.base import (
    Expression, Literal, Scalar, as_device_column, as_host_column,
    host_roundtrip, make_column, make_host_column)


def byte_mask(width: int, lengths: torch.Tensor) -> torch.Tensor:
    """(N, W) bool: True for bytes inside the string."""
    return torch.arange(width, dtype=torch.int32,
                        device=lengths.device)[None, :] < lengths[:, None]


def char_starts(data, lengths, xp=torch):
    """(N, W) bool: True at the first byte of each UTF-8 codepoint."""
    if xp is torch:
        inside = byte_mask(data.shape[1], lengths)
    else:
        inside = np.arange(data.shape[1], dtype=np.int32)[None, :] \
            < lengths[:, None]
    return ((data & 0xC0) != 0x80) & inside


def pack_left(data, keep, xp=torch):
    """Compact each row's kept bytes to its left: (data, lengths)."""
    w = data.shape[1]
    if xp is torch:
        order = torch.sort((~keep).to(torch.int8), dim=1,
                           stable=True).indices
        packed = torch.gather(data, 1, order)
        counts = keep.sum(dim=1, dtype=torch.int32)
        live = torch.arange(w, dtype=torch.int32,
                            device=data.device)[None, :] < counts[:, None]
        return torch.where(live, packed, torch.zeros_like(packed)), counts
    order = np.argsort((~keep).astype(np.int8), axis=1, kind="stable")
    packed = np.take_along_axis(data, order, axis=1)
    counts = keep.sum(axis=1).astype(np.int32)
    live = np.arange(w, dtype=np.int32)[None, :] < counts[:, None]
    return np.where(live, packed, 0).astype(np.uint8), counts


class Substring(Expression):
    """substring(str, pos, len): 1-based and character-addressed; a
    negative ``pos`` counts from the end and ``pos == 0`` means 1 (Spark
    semantics; ref GpuSubstring). Positions and lengths are int64
    throughout, so ``start + len`` cannot wrap (``substr(s, pos)`` is
    ``len = Int.MaxValue``)."""

    def __init__(self, child: Expression, pos: Expression,
                 length: Expression):
        self.child = child
        self.pos = pos
        self.length = length

    @property
    def children(self):
        return (self.child, self.pos, self.length)

    def data_type(self) -> DataType:
        return dt.STRING

    @staticmethod
    def _keep(data, lengths, pos, slen, xp):
        """(N, W) bool: the bytes of the kept characters."""
        starts = char_starts(data, lengths, xp)
        if xp is torch:
            nchars = starts.sum(dim=1, dtype=torch.int64)
            cidx = torch.cumsum(starts.to(torch.int64), dim=1) - 1
            pos, slen = pos.to(torch.int64), slen.to(torch.int64)
            zero = torch.zeros_like(pos)
            inside = byte_mask(data.shape[1], lengths)
        else:
            nchars = starts.sum(axis=1).astype(np.int64)
            cidx = np.cumsum(starts.astype(np.int64), axis=1) - 1
            pos, slen = pos.astype(np.int64), slen.astype(np.int64)
            zero = np.zeros_like(pos)
            inside = np.arange(data.shape[1], dtype=np.int32)[None, :] \
                < lengths[:, None]
        slen = xp.maximum(slen, zero)
        # pos > 0: 1-based from the start; pos < 0: from the end; 0 -> 1.
        start = xp.where(pos > 0, pos - 1, xp.where(pos < 0, nchars + pos,
                                                     zero))
        start0 = xp.maximum(start, zero)
        end = start0 + xp.where(start < 0, xp.maximum(slen + start, zero),
                                slen)
        return inside & (cidx >= start0[:, None]) & (cidx < end[:, None])

    def eval(self, batch):
        col = as_device_column(self.child.eval(batch), batch)
        p = as_device_column(self.pos.eval(batch), batch)
        n = as_device_column(self.length.eval(batch), batch)
        keep = self._keep(col.data, col.lengths, p.data, n.data, torch)
        data, lengths = pack_left(col.data, keep)
        return make_column(dt.STRING, data,
                           col.validity & p.validity & n.validity, lengths)

    def eval_host(self, batch):
        col = as_host_column(self.child.eval_host(batch), batch)
        p = as_host_column(self.pos.eval_host(batch), batch)
        n = as_host_column(self.length.eval_host(batch), batch)
        m, lens = strings_to_matrix(col)
        keep = self._keep(m, lens, np.asarray(p.data), np.asarray(n.data),
                          np)
        data, lengths = pack_left(m, keep, np)
        validity = np.asarray(col.validity, np.bool_) \
            & np.asarray(p.validity, np.bool_) \
            & np.asarray(n.validity, np.bool_)
        return HostColumn(dt.STRING, None, validity, str_matrix=data,
                          str_lengths=np.where(validity, lengths, 0)
                          .astype(np.int32))


def _sliding_match(data: torch.Tensor, lengths: torch.Tensor,
                   needle: bytes) -> torch.Tensor:
    """(N, W) bool: True at byte offset i iff ``needle`` matches starting
    at i and fits inside the string. The empty needle matches at every
    offset up to and including the string's end."""
    n, w = data.shape
    m = len(needle)
    if m == 0:
        return byte_mask(w, lengths + 1)
    if m > w:
        return torch.zeros((n, w), dtype=torch.bool, device=data.device)
    acc = torch.ones((n, w), dtype=torch.bool, device=data.device)
    for j, byte in enumerate(needle):
        # data shifted left by j: data[:, i + j] against needle[j]
        shifted = torch.cat([data[:, j:], data.new_zeros((n, j))], dim=1)
        acc = acc & (shifted == byte)
    fits = torch.arange(w, dtype=torch.int32, device=data.device)[None, :] \
        <= (lengths - m)[:, None]
    return acc & fits


def _sliding_match_host(data: np.ndarray, lengths: np.ndarray,
                        needle: bytes) -> np.ndarray:
    """:func:`_sliding_match` in numpy, over a host byte matrix."""
    n, w = data.shape
    m = len(needle)
    if m == 0:
        return np.arange(w, dtype=np.int32)[None, :] < (lengths + 1)[:, None]
    if m > w:
        return np.zeros((n, w), dtype=np.bool_)
    acc = np.ones((n, w), dtype=np.bool_)
    for j, byte in enumerate(needle):
        shifted = np.concatenate([data[:, j:], np.zeros((n, j), np.uint8)],
                                 axis=1)
        acc = acc & (shifted == byte)
    fits = np.arange(w, dtype=np.int32)[None, :] <= (lengths - m)[:, None]
    return acc & fits


class _NeedleOp(Expression):
    """Binary string predicate whose right side must be a literal (the
    restriction the reference places on StartsWith/EndsWith/Contains
    needles). A NULL needle gives NULL for every row."""

    def __init__(self, child: Expression, needle: Expression):
        self.child = child
        self.needle = needle

    @property
    def children(self):
        return (self.child, self.needle)

    def data_type(self) -> DataType:
        return dt.BOOL

    def _needle_bytes(self, batch, device: bool = True) -> Tuple[bytes, bool]:
        v = self.needle.eval(batch) if device else \
            self.needle.eval_host(batch)
        if not isinstance(v, Scalar):
            raise TypeError(f"{type(self).__name__} needle must be a literal")
        if v.is_null:
            return b"", True
        return v.as_bytes(), False

    def _match(self, data: torch.Tensor, lengths: torch.Tensor,
               needle: bytes) -> torch.Tensor:
        raise NotImplementedError

    def _match_host(self, data: np.ndarray, lengths: np.ndarray,
                    needle: bytes) -> np.ndarray:
        raise NotImplementedError

    def eval(self, batch):
        col = as_device_column(self.child.eval(batch), batch)
        needle, null = self._needle_bytes(batch)
        if null:
            none = torch.zeros(batch.capacity, dtype=torch.bool,
                               device=batch.device)
            return make_column(dt.BOOL, none, none)
        return make_column(dt.BOOL, self._match(col.data, col.lengths,
                                                needle), col.validity)

    def eval_host(self, batch):
        col = as_host_column(self.child.eval_host(batch), batch)
        needle, null = self._needle_bytes(batch, device=False)
        if null:
            z = np.zeros(batch.num_rows, np.bool_)
            return make_host_column(dt.BOOL, z, z.copy())
        m, lens = strings_to_matrix(col)
        return make_host_column(dt.BOOL, self._match_host(m, lens, needle),
                                col.validity)


class Contains(_NeedleOp):
    def _match(self, data, lengths, needle):
        return _sliding_match(data, lengths, needle).any(dim=1)

    def _match_host(self, data, lengths, needle):
        return _sliding_match_host(data, lengths, needle).any(axis=1)


class StartsWith(_NeedleOp):
    def _match(self, data, lengths, needle):
        return _sliding_match(data, lengths, needle)[:, 0]

    def _match_host(self, data, lengths, needle):
        hits = _sliding_match_host(data, lengths, needle)
        return hits[:, 0] if hits.shape[1] > 0 else \
            np.zeros(data.shape[0], np.bool_)


class EndsWith(_NeedleOp):
    def _match(self, data, lengths, needle):
        hits = _sliding_match(data, lengths, needle)
        m = len(needle)
        pos = (lengths - m).clamp(0, data.shape[1] - 1)
        at_end = hits.gather(1, pos[:, None].long())[:, 0]
        return at_end & (lengths >= m)

    def _match_host(self, data, lengths, needle):
        hits = _sliding_match_host(data, lengths, needle)
        m = len(needle)
        pos = np.clip(lengths - m, 0, max(data.shape[1] - 1, 0))
        at_end = np.take_along_axis(hits, pos[:, None].astype(np.int32),
                                    axis=1)[:, 0]
        return at_end & (lengths >= m)


class Like(Expression):
    """SQL LIKE with a literal pattern. A pattern made only of literal
    segments and ``%`` matches on the device (``_device_match``); one with
    ``_`` takes a host roundtrip inside ``eval`` (``_host_match``, an
    anchored regular expression), the split the reference makes for
    GpuLike. ``escape`` makes the next pattern character literal. The
    result's validity is the child's."""

    def __init__(self, child: Expression, pattern: str, escape: str = "\\"):
        self.child = child
        self.pattern = pattern
        self.escape = escape

    @property
    def children(self):
        return (self.child,)

    def data_type(self) -> DataType:
        return dt.BOOL

    @property
    def self_jittable(self) -> bool:
        # A pattern with ``_`` matches on the host.
        return self._segments() is not None

    def _segments(self) -> Optional[List[str]]:
        """The pattern split on unescaped ``%``, or None when it holds an
        unescaped ``_``."""
        segs, cur = [], []
        p = self.pattern
        i = 0
        while i < len(p):
            ch = p[i]
            if ch == self.escape and i + 1 < len(p):
                cur.append(p[i + 1])
                i += 2
                continue
            if ch == "_":
                return None
            if ch == "%":
                segs.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
            i += 1
        segs.append("".join(cur))
        return segs

    def _device_match(self, data: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
        """(N,) bool over the (N, W) byte matrix: one segment is an exact
        match; otherwise the first segment is a prefix, the last a suffix,
        and the middle ones must occur in order without overlapping, each
        from the earliest offset the one before it leaves (``min_start``)."""
        segs = self._segments()
        n, w = data.shape
        dev = data.device
        bsegs = [s.encode() for s in segs]
        ok = lengths >= sum(len(b) for b in bsegs)
        if len(bsegs) == 1:
            b = bsegs[0]
            target = torch.tensor(list(b[:w].ljust(w, b"\0")),
                                  dtype=torch.uint8, device=dev)
            return (data == target[None, :]).all(dim=1) & \
                (lengths == len(b))
        if bsegs[0]:
            hits = _sliding_match(data, lengths, bsegs[0])
            ok = ok & hits[:, 0] if w else torch.zeros_like(ok)
        last = bsegs[-1]
        if last:
            hits = _sliding_match(data, lengths, last)
            pos = (lengths - len(last)).clamp(0, max(w - 1, 0))
            ok = ok & hits.gather(1, pos[:, None].long())[:, 0] & \
                (lengths >= len(last))
        min_start = torch.full((n,), len(bsegs[0]), dtype=torch.int32,
                               device=dev)
        idx = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
        for b in bsegs[1:-1]:
            if not b:
                continue
            usable = _sliding_match(data, lengths, b) & \
                (idx >= min_start[:, None])
            ok = ok & usable.any(dim=1)
            first = torch.argmax(usable.to(torch.uint8), dim=1)
            min_start = first.to(torch.int32) + len(b)
        if last:
            ok = ok & ((lengths - len(last)) >= min_start)
        return ok

    def _host_match(self, values: list, validity) -> np.ndarray:
        """The pattern as an anchored regular expression over each valid
        row's UTF-8 text (``%`` any run, ``_`` one character)."""
        rx = []
        p = self.pattern
        i = 0
        while i < len(p):
            ch = p[i]
            if ch == self.escape and i + 1 < len(p):
                rx.append(re.escape(p[i + 1]))
                i += 2
                continue
            rx.append(".*" if ch == "%" else "." if ch == "_"
                      else re.escape(ch))
            i += 1
        pat = re.compile("(?s)^" + "".join(rx) + "$")
        return np.asarray(
            [bool(ok) and pat.match(b.decode("utf-8", "replace"))
             is not None for b, ok in zip(values, validity)],
            dtype=np.bool_)

    def eval(self, batch):
        col = as_device_column(self.child.eval(batch), batch)
        if self._segments() is not None:
            return make_column(dt.BOOL, self._device_match(
                col.data, col.lengths), col.validity)
        # A '_' pattern: the host roundtrip.
        def host(hcol):
            res = self._host_match(_values(hcol), hcol.validity)
            return HostColumn(dt.BOOL, res,
                              np.array(hcol.validity, np.bool_))
        return host_roundtrip("like", col, batch, host)

    def eval_host(self, batch):
        col = as_host_column(self.child.eval_host(batch), batch)
        return make_host_column(dt.BOOL, self._host_match(
            _values(col), col.validity), col.validity)


# ---------------------------------------------------------------------------
# Array helpers over ``xp`` (``torch`` on the device, ``np`` on the host)
# ---------------------------------------------------------------------------

def _values(col: HostColumn) -> list:
    """A host string column's rows as python bytes (NULL rows empty)."""
    return [b"" if b is None else bytes(b) for b in col.data]


def _offsets(xp, w: int, like):
    """(1, W) int32 byte offsets."""
    if xp is torch:
        return torch.arange(w, dtype=torch.int32, device=like.device)[None, :]
    return np.arange(w, dtype=np.int32)[None, :]


def _inside(xp, w: int, lengths):
    """(N, W) bool: the bytes inside each string."""
    return _offsets(xp, w, lengths) < lengths[:, None]


def _zeros(xp, shape, like, dtype=np.uint8):
    if xp is torch:
        return torch.zeros(shape, dtype=_TORCH_OF[np.dtype(dtype)],
                           device=like.device)
    return np.zeros(shape, dtype)


_TORCH_OF = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int32): torch.int32,
             np.dtype(np.bool_): torch.bool}


def _i32(xp, x):
    return x.to(torch.int32) if xp is torch else x.astype(np.int32)


def _count(xp, mask):
    """(N,) int32 count of True along the width."""
    if xp is torch:
        return mask.sum(dim=1, dtype=torch.int32)
    return mask.sum(axis=1).astype(np.int32)


def _running(xp, mask):
    """(N, W) int32 inclusive running count of True along the width."""
    if xp is torch:
        return torch.cumsum(mask.to(torch.int32), dim=1, dtype=torch.int32)
    return np.cumsum(mask.astype(np.int32), axis=1, dtype=np.int32)


def _take(xp, data, idx):
    """``data[r, idx[r, j]]`` row by row."""
    if xp is torch:
        return torch.gather(data, 1, idx.long())
    return np.take_along_axis(data, idx.astype(np.intp), axis=1)


def _cat(xp, parts):
    return torch.cat(parts, dim=1) if xp is torch \
        else np.concatenate(parts, axis=1)


def _stable_order(xp, key):
    """Each row's stable ascending order of ``key``."""
    if xp is torch:
        return torch.sort(key, dim=1, stable=True).indices
    return np.argsort(key, axis=1, kind="stable")


def _clamp_min(xp, x, lo: int):
    return torch.clamp(x, min=lo) if xp is torch else np.maximum(x, lo)


def _slide(xp, data, lengths, needle: bytes):
    return _sliding_match(data, lengths, needle) if xp is torch \
        else _sliding_match_host(data, lengths, needle)


def _char_count(xp, data, lengths):
    """(N,) int32 character (codepoint) count of each row."""
    return _count(xp, char_starts(data, lengths, xp))


def _literal_int(v) -> int:
    """An int argument given as a python int or a ``Literal``."""
    return int(v.value if isinstance(v, Literal) else v)


# ---------------------------------------------------------------------------
# One-string -> string templates and the case, length and trim functions
# ---------------------------------------------------------------------------

class StringUnary(Expression):
    """Template for string -> string ops defined on the byte matrix by
    ``kernel(xp, data, lengths, validity) -> (data, lengths, validity)``."""

    def __init__(self, child: Expression):
        self.child = child

    @property
    def children(self):
        return (self.child,)

    def data_type(self) -> DataType:
        return dt.STRING

    def kernel(self, xp, data, lengths, validity):
        raise NotImplementedError

    def eval(self, batch):
        col = as_device_column(self.child.eval(batch), batch)
        data, lengths, validity = self.kernel(torch, col.data, col.lengths,
                                              col.validity)
        return make_column(dt.STRING, data, validity, lengths)

    def eval_host(self, batch):
        col = as_host_column(self.child.eval_host(batch), batch)
        m, lens = strings_to_matrix(col)
        data, lengths, validity = self.kernel(
            np, m, lens, np.asarray(col.validity, np.bool_))
        return matrix_to_strings(data, lengths, validity)


class Upper(StringUnary):
    def kernel(self, xp, data, lengths, validity):
        lower = (data >= ord("a")) & (data <= ord("z"))
        return xp.where(lower, data - 32, data), lengths, validity


class Lower(StringUnary):
    def kernel(self, xp, data, lengths, validity):
        upper = (data >= ord("A")) & (data <= ord("Z"))
        return xp.where(upper, data + 32, data), lengths, validity


class InitCap(StringUnary):
    """initcap(): the first letter of each space-separated word upper
    case, the rest lower case (ASCII, the incompat of upper / lower)."""

    def kernel(self, xp, data, lengths, validity):
        n, w = data.shape
        space = _zeros(xp, (n, 1), data) + 0x20
        prev = _cat(xp, [space, data[:, :-1]])
        word_start = prev == 0x20
        is_lower = (data >= ord("a")) & (data <= ord("z"))
        is_upper = (data >= ord("A")) & (data <= ord("Z"))
        up = xp.where(word_start & is_lower, data - 32, data)
        out = xp.where(~word_start & is_upper, up + 32, up)
        out = xp.where(_inside(xp, w, lengths), out, 0)
        return out, lengths, validity


class Length(Expression):
    """Character (codepoint) length, Spark's length()."""

    def __init__(self, child: Expression):
        self.child = child

    @property
    def children(self):
        return (self.child,)

    def data_type(self) -> DataType:
        return dt.INT32

    def eval(self, batch):
        col = as_device_column(self.child.eval(batch), batch)
        return make_column(dt.INT32, _char_count(torch, col.data,
                                                 col.lengths), col.validity)

    def eval_host(self, batch):
        col = as_host_column(self.child.eval_host(batch), batch)
        m, lens = strings_to_matrix(col)
        return make_host_column(dt.INT32, _char_count(np, m, lens),
                                col.validity)


class StringTrim(StringUnary):
    """trim(): strip leading and trailing spaces (0x20), Spark's default;
    an all-space string trims to empty."""

    def _bounds(self, xp, data, lengths):
        w = data.shape[1]
        inside = _inside(xp, w, lengths)
        nonspace = inside & (data != 0x20)
        idx = _offsets(xp, w, data)
        has = nonspace.any(1)
        return inside, nonspace, idx, has

    def kernel(self, xp, data, lengths, validity):
        w = data.shape[1]
        inside, nonspace, idx, has = self._bounds(xp, data, lengths)
        first = xp.where(has, _amin(xp, xp.where(nonspace, idx, w)), 0)
        last = xp.where(has, _amax(xp, xp.where(nonspace, idx, -1)), -1)
        keep = inside & (idx >= first[:, None]) & (idx < (last + 1)[:, None])
        keep = keep & has[:, None]
        out, out_len = pack_left(data, keep, xp)
        return out, out_len, validity


class StringTrimLeft(StringTrim):
    def kernel(self, xp, data, lengths, validity):
        w = data.shape[1]
        inside, nonspace, idx, has = self._bounds(xp, data, lengths)
        first = xp.where(has, _amin(xp, xp.where(nonspace, idx, w)),
                         lengths)
        out, out_len = pack_left(data, inside & (idx >= first[:, None]), xp)
        return out, out_len, validity


class StringTrimRight(StringTrim):
    def kernel(self, xp, data, lengths, validity):
        inside, nonspace, idx, has = self._bounds(xp, data, lengths)
        last = xp.where(has, _amax(xp, xp.where(nonspace, idx, -1)) + 1, 0)
        out, out_len = pack_left(data, inside & (idx < last[:, None]), xp)
        return out, out_len, validity


def _amin(xp, x):
    return x.amin(dim=1) if xp is torch else x.min(axis=1)


def _amax(xp, x):
    return x.amax(dim=1) if xp is torch else x.max(axis=1)


class StringReverse(StringUnary):
    """reverse(str): character-level (UTF-8 aware) reversal, a stable sort
    of each row on (reversed character ordinal) * (W + 1) + (byte within
    its character); bytes past the length sort last."""

    def kernel(self, xp, data, lengths, validity):
        w = data.shape[1]
        idx = _offsets(xp, w, data)
        inside = _inside(xp, w, lengths)
        starts = char_starts(data, lengths, xp)
        char_ord = _running(xp, starts) - 1
        # A byte's offset within its codepoint: its distance from the
        # last character start at or before it (a running maximum).
        start_pos = xp.where(starts, idx, -1)
        if xp is torch:
            last_start = torch.cummax(start_pos, dim=1).values
        else:
            last_start = np.maximum.accumulate(start_pos, axis=1)
        within = idx - last_start
        nchars = _count(xp, starts)
        key = xp.where(inside,
                       (nchars[:, None] - 1 - char_ord) * (w + 1) + within,
                       2 * w * (w + 1))
        out = _take(xp, data, _stable_order(xp, _i32(xp, key)))
        return xp.where(idx < lengths[:, None], out, 0), lengths, validity


# ---------------------------------------------------------------------------
# Delimiter scans: substring_index and split(...)[i]
# ---------------------------------------------------------------------------

def _greedy_matches(xp, hits, m: int):
    """Greedy left-to-right non-overlapping occurrence selection over the
    sliding-window hits (N, W): a hit is real iff no real hit covers it,
    the scan Java's indexOf loop performs, vectorized over rows. A loop
    over the width on both engines (three launches a byte on the
    device)."""
    n, w = hits.shape
    if m <= 1 or w == 0:
        return hits
    next_free = _zeros(xp, (n,), hits, np.int32)
    cols = []
    for j in range(w):
        real_j = hits[:, j] & (next_free <= j)
        next_free = xp.where(real_j, j + m, next_free)
        cols.append(real_j)
    return torch.stack(cols, dim=1) if xp is torch else np.stack(cols, 1)


def _delim_scan(xp, data, lengths, delim: bytes):
    """(occ_incl, completed, total) of the greedy occurrences of
    ``delim``: occ_incl[j] counts occurrences started at or before byte
    j, completed[j] those fully before byte j, total all of them."""
    m = len(delim)
    real = _greedy_matches(xp, _slide(xp, data, lengths, delim), m)
    occ_incl = _running(xp, real)
    n, w = data.shape
    if w > m:
        completed = _cat(xp, [_zeros(xp, (n, m), data, np.int32),
                              occ_incl[:, :-m]])
    else:
        completed = _zeros(xp, (n, w), data, np.int32)
    total = occ_incl[:, -1] if w else _zeros(xp, (n,), data, np.int32)
    return occ_incl, completed, total


class SubstringIndex(StringUnary):
    """substring_index(str, delim, count), Spark / Hive semantics over a
    literal delimiter: count > 0 keeps what comes before the count-th
    occurrence, count < 0 what comes after the |count|-th from the end,
    count == 0 nothing; fewer occurrences keep the whole string."""

    def __init__(self, child: Expression, delim: str, count: int):
        super().__init__(child)
        if not delim:
            raise ValueError(
                "substring_index delimiter must be a non-empty literal")
        self.delim = delim
        self.count = int(count)

    def kernel(self, xp, data, lengths, validity):
        occ_incl, completed, total = _delim_scan(
            xp, data, lengths, self.delim.encode("utf-8"))
        inside = _inside(xp, data.shape[1], lengths)
        if self.count > 0:
            keep = inside & (occ_incl < self.count)
        elif self.count < 0:
            keep = inside & (completed >= (total + self.count + 1)[:, None])
        else:
            keep = inside & False
        out, out_len = pack_left(data, keep, xp)
        return out, out_len, validity


class StringSplit(StringUnary):
    """split(str, delim)[index], the element access of Spark's StringSplit
    (the split(...).getItem(i) pattern; arrays are not a device type).
    The delimiter is a literal matched verbatim (no regex, as the
    reference's); a negative or out-of-range index gives NULL, and
    trailing empty elements are kept (limit = -1)."""

    def __init__(self, child: Expression, delim: str, index: int):
        if not delim:
            raise ValueError("split delimiter must be a non-empty literal")
        super().__init__(child)
        self.delim = delim
        self.index = int(index)

    def kernel(self, xp, data, lengths, validity):
        occ_incl, completed, total = _delim_scan(
            xp, data, lengths, self.delim.encode("utf-8"))
        inside = _inside(xp, data.shape[1], lengths)
        in_delim = (occ_incl - completed) > 0
        if self.index < 0:
            keep = inside & False
            valid = validity & False
        else:
            keep = inside & ~in_delim & (completed == self.index)
            valid = validity & (self.index < total + 1)
        out, out_len = pack_left(data, keep, xp)
        return out, out_len, valid


class StringLocate(Expression):
    """locate(needle, str, start = 1): the 1-based character position of
    the first match at or after character ``start``, 0 when there is
    none; an empty needle gives ``start`` while it is at most the length
    plus one; any ``start < 1`` gives 0 (ref GpuStringLocate)."""

    def __init__(self, needle: Expression, child: Expression,
                 start: Expression):
        self.needle = needle
        self.child = child
        self.start = start

    @property
    def children(self):
        return (self.needle, self.child, self.start)

    def data_type(self) -> DataType:
        return dt.INT32

    @staticmethod
    def _kernel(xp, data, lengths, needle: bytes, start):
        hits = _slide(xp, data, lengths, needle)
        starts = char_starts(data, lengths, xp)
        cidx = _running(xp, starts) - 1
        # Only hits at character starts count, from character start - 1.
        ok = hits & starts & (cidx >= (start - 1)[:, None])
        any_hit = ok.any(1)
        if xp is torch:
            first = torch.argmax(ok.to(torch.uint8), dim=1)[:, None]
        else:
            first = np.argmax(ok, axis=1)[:, None]
        charpos = _take(xp, cidx, first)[:, 0] + 1
        res = xp.where(any_hit, charpos, 0)
        if not needle:
            res = xp.where(start <= _char_count(xp, data, lengths) + 1,
                           start, 0)
        return _i32(xp, xp.where(start >= 1, res, 0))

    def _needle(self, v) -> Scalar:
        if not isinstance(v, Scalar):
            raise TypeError("locate needle must be a literal")
        return v

    def eval(self, batch):
        col = as_device_column(self.child.eval(batch), batch)
        nv = self._needle(self.needle.eval(batch))
        sv = as_device_column(self.start.eval(batch), batch)
        if nv.is_null:
            none = torch.zeros(batch.capacity, dtype=torch.bool,
                               device=batch.device)
            return make_column(dt.INT32, none.to(torch.int32), none)
        data = self._kernel(torch, col.data, col.lengths, nv.as_bytes(),
                            sv.data.to(torch.int32))
        return make_column(dt.INT32, data, col.validity & sv.validity)

    def eval_host(self, batch):
        col = as_host_column(self.child.eval_host(batch), batch)
        nv = self._needle(self.needle.eval_host(batch))
        sv = as_host_column(self.start.eval_host(batch), batch)
        if nv.is_null:
            z = np.zeros(batch.num_rows, np.bool_)
            return make_host_column(dt.INT32, z.astype(np.int32), z)
        m, lens = strings_to_matrix(col)
        data = self._kernel(np, m, lens, nv.as_bytes(),
                            np.asarray(sv.data).astype(np.int32))
        return make_host_column(dt.INT32, data, np.asarray(
            col.validity, np.bool_) & np.asarray(sv.validity, np.bool_))


# ---------------------------------------------------------------------------
# Concatenation and repetition
# ---------------------------------------------------------------------------

def _concat2(xp, a_data, a_len, b_data, b_len):
    """Row-wise a + b at width ``wa + wb``: output byte j comes from a
    below a's length, else from b at ``j - len(a)`` (one gather)."""
    n, wa = a_data.shape
    wb = b_data.shape[1]
    w = wa + wb
    j = _offsets(xp, w, a_data)
    from_a = j < a_len[:, None]
    bj = j - a_len[:, None]
    bj = torch.clamp(bj, 0, max(wb - 1, 0)) if xp is torch \
        else np.clip(bj, 0, max(wb - 1, 0))
    a_pad = _cat(xp, [a_data, _zeros(xp, (n, w - wa), a_data)])
    b_g = _take(xp, _cat(xp, [b_data, _zeros(xp, (n, w - wb), b_data)]), bj)
    out_len = a_len + b_len
    out = xp.where(from_a, a_pad, b_g)
    return xp.where(j < out_len[:, None], out, 0), out_len


class ConcatStrings(Expression):
    """concat(s1, s2, ...): NULL if any input is NULL (Spark concat); the
    width is the sum of the inputs' widths."""

    def __init__(self, *children: Expression):
        self._children = tuple(children)

    @property
    def children(self):
        return self._children

    def data_type(self) -> DataType:
        return dt.STRING

    @staticmethod
    def _run(xp, cols):
        data, lengths, validity = cols[0]
        for d, ln, v in cols[1:]:
            data, lengths = _concat2(xp, data, lengths, d, ln)
            validity = validity & v
        return data, lengths, validity

    def eval(self, batch):
        cols = [as_device_column(c.eval(batch), batch)
                for c in self._children]
        data, lengths, validity = self._run(
            torch, [(c.data, c.lengths, c.validity) for c in cols])
        return make_column(dt.STRING, data, validity, lengths)

    def eval_host(self, batch):
        cols = []
        for c in self._children:
            col = as_host_column(c.eval_host(batch), batch)
            m, lens = strings_to_matrix(col)
            cols.append((m, lens, np.asarray(col.validity, np.bool_)))
        return matrix_to_strings(*self._run(np, cols))


class ConcatWs(Expression):
    """concat_ws(sep, s1, s2, ...): the non-NULL inputs joined by the
    literal separator; NULL inputs and their separators add nothing, and
    the result is never NULL (padding rows stay invalid). Its width is
    one plus each input's width and the separator's."""

    def __init__(self, sep: str, *children: Expression):
        self.sep = sep.encode() if isinstance(sep, str) else bytes(sep)
        self._children = tuple(children)

    @property
    def children(self):
        return self._children

    def data_type(self) -> DataType:
        return dt.STRING

    def _run(self, xp, cols):
        like = cols[0][0]
        n = like.shape[0]
        ws = len(self.sep)
        sep = np.frombuffer(self.sep, np.uint8)
        if xp is torch:
            sep_row = torch.from_numpy(sep.copy()).to(like.device)
        else:
            sep_row = sep
        acc_data = _zeros(xp, (n, 1), like)
        acc_len = _zeros(xp, (n,), like, np.int32)
        has_prev = _zeros(xp, (n,), like, np.bool_)
        for d, ln, v in cols:
            eff_len = _i32(xp, xp.where(v, ln, 0))
            if ws:
                sep_len = _i32(xp, xp.where(has_prev & v, ws, 0))
                sep_data = sep_row[None, :].expand(n, ws) if xp is torch \
                    else np.broadcast_to(sep_row[None, :], (n, ws))
                acc_data, acc_len = _concat2(xp, acc_data, acc_len,
                                             sep_data, sep_len)
            acc_data, acc_len = _concat2(xp, acc_data, acc_len, d, eff_len)
            has_prev = has_prev | v
        return acc_data, acc_len

    def eval(self, batch):
        live = batch.row_mask()
        if not self._children:
            n = batch.capacity
            return make_column(
                dt.STRING, torch.zeros((n, 1), dtype=torch.uint8,
                                       device=batch.device), live,
                torch.zeros(n, dtype=torch.int32, device=batch.device))
        cols = [as_device_column(c.eval(batch), batch)
                for c in self._children]
        data, lengths = self._run(torch, [(c.data, c.lengths, c.validity)
                                          for c in cols])
        return make_column(dt.STRING, data, live, lengths)

    def eval_host(self, batch):
        n = batch.num_rows
        if not self._children:
            return matrix_to_strings(np.zeros((n, 1), np.uint8),
                                     np.zeros(n, np.int32), all_valid(n))
        cols = []
        for c in self._children:
            col = as_host_column(c.eval_host(batch), batch)
            m, lens = strings_to_matrix(col)
            cols.append((m, lens, np.asarray(col.validity, np.bool_)))
        data, lengths = self._run(np, cols)
        return matrix_to_strings(data, lengths, all_valid(n))


class StringRepeat(StringUnary):
    """repeat(str, n) with a literal n (ref GpuStringRepeat); n <= 0 gives
    the empty string, and the width is ``w * n``."""

    def __init__(self, child: Expression, n):
        super().__init__(child)
        self.n = max(_literal_int(n), 0)

    def kernel(self, xp, data, lengths, validity):
        rows, w = data.shape
        k = self.n
        if k == 0 or w == 0:
            return _zeros(xp, (rows, 1), data), \
                _zeros(xp, (rows,), data, np.int32), validity
        j = _offsets(xp, w * k, data)
        src = j % _clamp_min(xp, lengths, 1)[:, None]
        out = _take(xp, data, src)
        out_len = _i32(xp, lengths * k)
        return xp.where(j < out_len[:, None], out, 0), out_len, validity


# ---------------------------------------------------------------------------
# Host-roundtrip kinds: the reference runs these on the host even inside a
# device plan (its boundary at cudf's regex support)
# ---------------------------------------------------------------------------

class _HostStringOp(Expression):
    """Template for string -> string ops computed per row on the host by
    ``_host_kernel(values, validity) -> HostColumn``; the device half is a
    counted host roundtrip (``island.<kind>.*`` in the operator's
    metrics)."""

    kind = ""

    def data_type(self) -> DataType:
        return dt.STRING

    @property
    def self_jittable(self) -> bool:
        return False

    @property
    def children(self):
        return (self.child,)

    def _host_kernel(self, values: list, validity) -> HostColumn:
        raise NotImplementedError

    def _host(self, col: HostColumn) -> HostColumn:
        validity = np.array(col.validity, np.bool_)
        return self._host_kernel(_values(col), validity)

    def eval(self, batch):
        col = as_device_column(self.child.eval(batch), batch)
        return host_roundtrip(self.kind, col, batch, self._host)

    def eval_host(self, batch):
        return self._host(as_host_column(self.child.eval_host(batch), batch))


def _object_column(out: list, validity: np.ndarray) -> HostColumn:
    data = np.empty(len(out), dtype=object)
    data[:] = out
    return HostColumn(dt.STRING, data, validity)


class StringReplace(_HostStringOp):
    """replace(str, search, replace) with a literal search
    (GpuStringReplace); an empty search changes nothing."""

    kind = "replace"

    def __init__(self, child: Expression, search, replace):
        self.child = child
        self.search = search.encode() if isinstance(search, str) else search
        self.replace = replace.encode() if isinstance(replace, str) \
            else replace

    def _host_kernel(self, values, validity):
        s, r = self.search, self.replace
        return _object_column(
            [v.replace(s, r) if ok and s else v
             for v, ok in zip(values, validity.tolist())], validity)


class RegExpReplace(_HostStringOp):
    """regexp_replace(str, pattern, replacement): python ``re`` over the
    bytes (the host boundary the reference draws)."""

    kind = "regexp_replace"

    def __init__(self, child: Expression, pattern, replacement):
        self.child = child
        self.pattern = re.compile(pattern.encode()
                                  if isinstance(pattern, str) else pattern)
        self.replacement = replacement.encode() \
            if isinstance(replacement, str) else replacement

    def _host_kernel(self, values, validity):
        sub, r = self.pattern.sub, self.replacement
        return _object_column(
            [sub(r, v) if ok else b""
             for v, ok in zip(values, validity.tolist())], validity)


class RegExpExtract(_HostStringOp):
    """regexp_extract(str, pattern, idx): group ``idx`` of the first match,
    '' when there is none (Spark semantics; python ``re`` over the UTF-8
    text)."""

    kind = "regexp_extract"

    def __init__(self, child: Expression, pattern: str, idx: int = 1):
        self.child = child
        self.pattern = re.compile(pattern)
        self.idx = int(idx)

    def _host_kernel(self, values, validity):
        search, idx = self.pattern.search, self.idx
        out = []
        for v, ok in zip(values, validity.tolist()):
            m = search(v.decode("utf-8", "replace")) if ok else None
            out.append(b"" if m is None else (m.group(idx) or "").encode())
        return _object_column(out, validity)


class Translate(_HostStringOp):
    """translate(str, from, to): a per-character mapping; characters of
    ``from`` past the length of ``to`` are deleted (Spark semantics)."""

    kind = "translate"

    def __init__(self, child: Expression, src: str, to: str):
        self.child = child
        self.table = {}
        for i, ch in enumerate(src):
            if ch not in self.table:
                self.table[ch] = to[i] if i < len(to) else None
        self._map = str.maketrans({k: v for k, v in self.table.items()})

    def _host_kernel(self, values, validity):
        # str.translate deletes characters mapped to None, as the
        # reference's per-character loop does.
        m = self._map
        return _object_column(
            [v.decode("utf-8", "replace").translate(m).encode() if ok
             else b"" for v, ok in zip(values, validity.tolist())],
            validity)


class _StringPad(_HostStringOp):
    """lpad / rpad(str, len, pad): character-addressed pad or truncate
    (GpuStringLPad / RPad), on the host (exact character semantics)."""

    left = True

    def __init__(self, child: Expression, length, pad: str = " "):
        self.child = child
        self.length = _literal_int(length)
        self.pad = pad

    def _one(self, s: str) -> bytes:
        want = self.length
        if want <= 0:
            return b""
        if len(s) >= want:
            return s[:want].encode()
        if not self.pad:
            return s.encode()
        fill = (self.pad * want)[:want - len(s)]
        return (fill + s if self.left else s + fill).encode()

    def _host_kernel(self, values, validity):
        one = self._one
        return _object_column(
            [one(v.decode("utf-8", "replace")) if ok else b""
             for v, ok in zip(values, validity.tolist())], validity)


class StringLPad(_StringPad):
    kind = "lpad"
    left = True


class StringRPad(_StringPad):
    kind = "rpad"
    left = False
