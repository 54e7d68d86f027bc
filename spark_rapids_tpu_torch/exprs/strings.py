"""String predicates with a literal needle or pattern (port of the JAX
package's ``exprs/strings.py``, cut to ``byte_mask``, ``_sliding_match``,
``_NeedleOp``, ``Contains``, ``StartsWith``, ``EndsWith`` and ``Like``).

A string column is a dense ``(N, W)`` uint8 matrix plus int32 lengths
(``columnar/batch.py``). A needle match is a sliding-window equality over
the width axis: ``O(W * |needle|)`` elementwise work and no per-row loop,
in torch on the device and in numpy over the host byte matrix
(``eval_host``, either host string layout).
Bytes are compared, so multibyte UTF-8 needles match as the reference
matches them. ``Like`` splits its pattern on ``%``: literal segments
match on the device as an exact match, a prefix, a suffix and ordered
containment; a pattern with ``_`` takes the reference's host roundtrip
(an anchored ``re`` match). The rest of the module (case, length,
substring, locate, replace) comes in a later slice.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.columnar.host import (
    HostBatch, HostColumn, device_to_host, host_to_device,
    strings_to_matrix)
from spark_rapids_tpu_torch.exprs.base import (
    Expression, Scalar, as_device_column, as_host_column, make_column,
    make_host_column)


def byte_mask(width: int, lengths: torch.Tensor) -> torch.Tensor:
    """(N, W) bool: True for bytes inside the string."""
    return torch.arange(width, dtype=torch.int32,
                        device=lengths.device)[None, :] < lengths[:, None]


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
        hb = device_to_host(DeviceBatch((col,), batch.num_rows))
        hcol = hb.columns[0]
        res = self._host_match([bytes(b) for b in hcol.data], hcol.validity)
        dev = host_to_device(
            HostBatch(("c",), [HostColumn(dt.BOOL, res,
                                          hcol.validity.copy())]),
            capacity=batch.capacity, device=batch.device)
        return dev.columns[0]

    def eval_host(self, batch):
        col = as_host_column(self.child.eval_host(batch), batch)
        vals = [b"" if b is None else bytes(b) for b in col.data]
        return make_host_column(dt.BOOL, self._host_match(vals,
                                                          col.validity),
                                col.validity)
