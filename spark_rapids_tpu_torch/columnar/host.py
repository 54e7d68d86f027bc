"""Host-resident columnar batches, the host engine's key encoders, and
host<->device transitions.

Port of the JAX package's ``columnar/host.py``. Host data is numpy (fixed
width) or, for strings, either a numpy object array of ``bytes`` or the
dense device layout (``str_matrix`` (n, w) uint8 + ``str_lengths``
int32). Host batches are the currency of the host engine (each exec's
``execute_host``), which runs numpy over them; every host function takes
both string layouts.

The upload goes through the wire codec (``columnar/wire.py``, default
``v2``, as in the reference). The download pulls every batch's buffers
with one batched copy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import DeviceLike, resolve_device
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (
    MIN_SHRINK_BYTES, DeviceBatch, DeviceColumn, shrink_all)
from spark_rapids_tpu_torch.columnar.dtypes import DataType


# One read-only all-True validity buffer, grown on demand; every caller
# slices a view instead of allocating ``np.ones(n)`` per call.
_ALL_VALID = np.ones(0, dtype=np.bool_)


def all_valid(n: int) -> np.ndarray:
    """A read-only all-True validity mask of length ``n`` (shared buffer).

    Callers that need to flip bits must copy: the read-only flag turns a
    silent shared-mask corruption into an immediate ValueError."""
    global _ALL_VALID
    if n > _ALL_VALID.shape[0]:
        _ALL_VALID = np.ones(max(n, 2 * _ALL_VALID.shape[0], 1024),
                             dtype=np.bool_)
        _ALL_VALID.setflags(write=False)
    return _ALL_VALID[:n]


class HostColumn:
    """One host column: values + validity. Strings are ``object`` arrays of
    python ``bytes`` (None entries mean null), or the dense matrix layout
    (``str_matrix`` (n, w) uint8 + ``str_lengths`` int32), whose object
    array is built lazily when a host kernel asks for ``.data``.

    ``encode_key`` memoizes a column's key codes here. ``_key_uniq`` is the
    string coding space (the sorted unique byte records the rank codes
    index into); ``take``/``filter`` carry codes and space to the derived
    column, or, when the parent has no codes yet, record the gather
    (``_key_src``) so the parent is ranked once and its codes gathered."""

    def __init__(self, dtype: DataType, data: Optional[np.ndarray],
                 validity: np.ndarray,
                 str_matrix: Optional[np.ndarray] = None,
                 str_lengths: Optional[np.ndarray] = None):
        self.dtype = dtype
        self._data = data
        self.validity = validity
        self.str_matrix = str_matrix
        self.str_lengths = str_lengths
        self._key_codes: Optional[np.ndarray] = None
        self._key_uniq: Optional[np.ndarray] = None
        self._key_src = None

    @property
    def data(self) -> np.ndarray:
        if self._data is None:
            m, lens, val = self.str_matrix, self.str_lengths, self.validity
            n, w = m.shape[0], m.shape[1]
            out = np.empty(n, dtype=object)
            buf = np.ascontiguousarray(m).tobytes()
            lens_l = lens.tolist()
            val_l = np.asarray(val, np.bool_).tolist()
            out[:] = [buf[i * w:i * w + lens_l[i]] if val_l[i] else b""
                      for i in range(n)]
            self._data = out
        return self._data

    @data.setter
    def data(self, v):
        self._data = v
        self._key_codes = None
        self._key_uniq = None
        self._key_src = None

    @property
    def num_rows(self) -> int:
        return len(self.validity)

    def take(self, indices: np.ndarray,
             null_on_negative: bool = False) -> "HostColumn":
        """Row gather keeping the dense string layout. With
        ``null_on_negative`` a negative index gives a null row (an outer
        join's null extension)."""
        idx = np.asarray(indices, dtype=np.int64)
        if null_on_negative:
            if self.num_rows == 0:
                n = len(idx)
                if self.dtype.is_string:
                    return HostColumn(self.dtype, None,
                                      np.zeros(n, np.bool_),
                                      str_matrix=np.zeros((n, 1), np.uint8),
                                      str_lengths=np.zeros(n, np.int32))
                return HostColumn(self.dtype,
                                  np.zeros(n, self.dtype.np_dtype),
                                  np.zeros(n, np.bool_))
            neg = idx < 0
            safe = np.where(neg, 0, idx)
            val = self.validity[safe] & ~neg
        else:
            safe = idx
            val = self.validity[safe]
        if self.dtype.is_string and self._data is None:
            m = self.str_matrix[safe]
            lens = np.where(val, self.str_lengths[safe], 0).astype(np.int32)
            out = HostColumn(self.dtype, None, np.asarray(val, np.bool_),
                             str_matrix=m, str_lengths=lens)
            return self._propagate_key_codes(out, safe, val)
        # Fancy indexing copies, so the null zeroing below never writes
        # into the source column.
        d = self.data[safe]
        if not val.all():
            if self.dtype.is_string:
                for i in np.flatnonzero(~val):
                    d[i] = b""
            else:
                d[~val] = np.zeros(1, self.dtype.np_dtype)
        out = HostColumn(self.dtype, d, np.asarray(val, np.bool_))
        return self._propagate_key_codes(out, safe, val)

    def _propagate_key_codes(self, out: "HostColumn", safe: np.ndarray,
                             val: np.ndarray) -> "HostColumn":
        """Carry (rank codes, coding space) through a gather: ranks stay
        order-preserving and equality-exact over any row subset. Rows the
        gather nulled take code 0, as a fresh encoding would give."""
        if self._key_codes is not None:
            kc = self._key_codes[safe]
            if not val.all():
                kc = np.where(val, kc, np.int64(0))
            out._key_codes = kc
            out._key_uniq = self._key_uniq
        elif self.dtype.is_string:
            out._key_src = (self, safe, val)
        return out

    def filter(self, keep: np.ndarray) -> "HostColumn":
        """Boolean-mask row filter, keeping the matrix layout as ``take``
        does."""
        keep = np.asarray(keep, np.bool_)
        if self.dtype.is_string and self._data is None:
            out = HostColumn(self.dtype, None, self.validity[keep],
                             str_matrix=self.str_matrix[keep],
                             str_lengths=self.str_lengths[keep])
        else:
            out = HostColumn(self.dtype, self.data[keep],
                             self.validity[keep])
        if self._key_codes is not None:
            out._key_codes = self._key_codes[keep]
            out._key_uniq = self._key_uniq
        elif self.dtype.is_string:
            out._key_src = (self, keep, None)
        return out

    @classmethod
    def from_values(cls, dtype: DataType, values: Sequence) -> "HostColumn":
        """Build from a python sequence; None means null."""
        n = len(values)
        validity = np.array([v is not None for v in values], dtype=np.bool_)
        if dtype.is_string:
            data = np.empty(n, dtype=object)
            data[:] = [b"" if v is None else
                       (v.encode("utf-8") if isinstance(v, str) else bytes(v))
                       for v in values]
        else:
            data = np.zeros(n, dtype=dtype.np_dtype)
            idx = np.nonzero(validity)[0]
            if len(idx):
                data[idx] = np.asarray([values[i] for i in idx],
                                       dtype=dtype.np_dtype)
        return cls(dtype, data, validity)

    def to_list(self) -> list:
        """Python values with None for nulls."""
        val = np.asarray(self.validity, dtype=np.bool_)
        if self.dtype.is_string:
            if self._data is not None:
                return [bytes(b).decode("utf-8", "replace") if v else None
                        for b, v in zip(self._data, val.tolist())]
            m, lens = self.str_matrix, self.str_lengths
            w = m.shape[1]
            buf = np.ascontiguousarray(m).tobytes()
            lens_l = lens.tolist()
            return [buf[i * w:i * w + lens_l[i]].decode("utf-8", "replace")
                    if v else None for i, v in enumerate(val.tolist())]
        out = np.asarray(self.data)[:len(val)].tolist()
        for i in np.flatnonzero(~val).tolist():
            out[i] = None
        return out


@dataclasses.dataclass
class HostBatch:
    names: Tuple[str, ...]
    columns: List[HostColumn]

    @property
    def num_rows(self) -> int:
        return self.columns[0].num_rows if self.columns else 0

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def column(self, name: str) -> HostColumn:
        return self.columns[self.names.index(name)]

    def to_pylist(self) -> List[tuple]:
        cols = [c.to_list() for c in self.columns]
        return list(zip(*cols)) if cols else []

    @classmethod
    def from_pydict(cls, schema: Sequence[Tuple[str, DataType]],
                    data: dict) -> "HostBatch":
        names = tuple(n for n, _ in schema)
        return cls(names, [HostColumn.from_values(t, data[n])
                           for n, t in schema])

    def take(self, indices: np.ndarray,
             null_on_negative: bool = False) -> "HostBatch":
        return HostBatch(self.names, [c.take(indices, null_on_negative)
                                      for c in self.columns])

    def filter(self, keep: np.ndarray) -> "HostBatch":
        # One mask scan for the whole batch: the mask becomes a gather
        # index once instead of a mask pass per column.
        idx = np.flatnonzero(np.asarray(keep, np.bool_))
        return HostBatch(self.names, [c.take(idx) for c in self.columns])


# ---------------------------------------------------------------------------
# Type-aware key encoding (host sort, group-by and join)
# ---------------------------------------------------------------------------
#
# Every host operator that orders or matches rows reduces each key column
# to ONE int64 code array with the invariants:
#   * order-preserving: code(a) < code(b) iff a sorts before b under the
#     engine's total order (floats: -inf..inf, every NaN equal and
#     greatest; -0.0 == +0.0),
#   * equality-exact: code(a) == code(b) iff a == b under group/join
#     semantics (NaN matches NaN, -0.0 matches +0.0),
#   * null-blind: invalid rows get code 0; callers carry validity beside
#     the codes and order nulls by a validity plane.
# The host engine never flushes subnormals: 1e-310 is its own key, as in
# the JAX package's numpy host engine.

_NAN_CANON = np.int64(0x7FF8000000000000)


def encode_key(col: HostColumn) -> np.ndarray:
    """Order-preserving int64 codes for one column (see above). String
    codes are ranks within THIS column only; joins use
    :func:`encode_key_pair` for a shared code space. Codes are memoized
    on the column (the ``data`` setter drops the memo)."""
    if col._key_codes is not None:
        return col._key_codes
    if col.dtype.is_string:
        src = col._key_src
        if src is not None:
            # Deferred gather: rank the parent once and pull this
            # column's codes through the recorded selection.
            parent, sel, val = src
            kc = encode_key(parent)[sel]
            if val is not None and not val.all():
                kc = np.where(val, kc, np.int64(0))
            col._key_codes = kc
            col._key_uniq = parent._key_uniq
            col._key_src = None
            return kc
        codes_l, uniq = _string_codes([col])
        codes = codes_l[0]
        col._key_uniq = uniq
    else:
        codes = _fixed_codes(col)
    col._key_codes = codes
    return codes


def encode_key_concat(cols: Sequence[HostColumn]
                      ) -> Tuple[np.ndarray, np.ndarray,
                                 Optional[np.ndarray]]:
    """``(codes, validity, space)`` for the row concatenation of ``cols``
    without ranking the materialized concat. ``space`` is the unique
    records matrix the string codes index into (None for fixed-width
    keys). String pieces are coded per instance (memoized), then their
    coding spaces merge over distinct values only."""
    if len(cols) == 1:
        c = cols[0]
        return (encode_key(c), np.asarray(c.validity, np.bool_),
                c._key_uniq)
    validity = np.concatenate(
        [np.asarray(c.validity, np.bool_) for c in cols])
    if not cols[0].dtype.is_string:
        return (np.concatenate([encode_key(c) for c in cols]), validity,
                None)
    distinct: List[HostColumn] = []
    seen = {}
    for c in cols:
        if id(c) not in seen:
            seen[id(c)] = c
            distinct.append(c)
    live = [c for c in distinct if bool(np.any(c.validity))]
    space: Optional[np.ndarray] = None
    if len(live) == 1:
        percodes = {id(live[0]): encode_key(live[0])}
        space = live[0]._key_uniq
    elif live:
        for c in live:
            encode_key(c)
        spaces: List[np.ndarray] = []
        space_idx = {}
        for c in live:
            u = c._key_uniq
            if u is not None and id(u) not in space_idx:
                space_idx[id(u)] = len(spaces)
                spaces.append(u)
        if any(c._key_uniq is None for c in live):
            codes_l, space = _string_codes(live)
            percodes = {id(c): k for c, k in zip(live, codes_l)}
        elif len(spaces) == 1:
            percodes = {id(c): c._key_codes for c in live}
            space = spaces[0]
        else:
            remaps, space = _merge_string_spaces(spaces)
            percodes = {
                id(c): remaps[space_idx[id(c._key_uniq)]][c._key_codes]
                for c in live}
    else:
        percodes = {}
    codes = np.concatenate([
        percodes.get(id(c), np.zeros(c.num_rows, np.int64)) for c in cols])
    return codes, validity, space


def encode_key_pair(a: HostColumn,
                    b: HostColumn) -> Tuple[np.ndarray, np.ndarray]:
    """Codes for two same-type columns drawn from ONE shared code space:
    the join-key currency (probe codes comparable to build codes)."""
    if a.dtype.is_string or b.dtype.is_string:
        ca, cb = encode_key(a), encode_key(b)
        ua, ub = a._key_uniq, b._key_uniq
        if ua is not None and ua is ub:
            return ca, cb
        if ua is not None and ub is not None:
            remaps, _ = _merge_string_spaces([ua, ub])
            return remaps[0][ca], remaps[1][cb]
        codes_l, _ = _string_codes([a, b])
        return codes_l[0], codes_l[1]
    # A mixed int/float key pair encodes both sides as floats (1 == 1.0).
    ff = a.dtype.is_floating != b.dtype.is_floating
    if not ff:
        return encode_key(a), encode_key(b)
    return _fixed_codes(a, force_float=ff), _fixed_codes(b, force_float=ff)


def encode_sort_key(col: HostColumn) -> np.ndarray:
    """Codes in SQL sort order. :func:`encode_key` is the equality
    currency and folds ``-0.0`` into ``0.0``; a sort keeps the IEEE total
    order's two zeros (``-0.0 < 0.0``). NaN canonical and greatest, nulls
    code 0, as there."""
    if col.dtype.is_floating:
        arr = np.asarray(col.data)
        val = np.asarray(col.validity, np.bool_)
        f = arr.astype(np.float64)
        bits = f.view(np.int64)
        bits = np.where(np.isnan(f), _NAN_CANON, bits)
        bits = np.where(bits >= 0, bits,
                        bits ^ np.int64(0x7FFFFFFFFFFFFFFF))
        return np.where(val, bits, np.int64(0))
    return encode_key(col)


def stable_code_argsort(codes: np.ndarray) -> np.ndarray:
    """Stable argsort of int64 key codes. When range * n fits below 2**62
    the row index composited into the key makes every key distinct, so
    the default sort gives the identical stable order faster."""
    n = len(codes)
    if n > 1:
        cmin = int(codes.min())
        crange = int(codes.max()) - cmin + 1
        if crange * n < (1 << 62):
            comp = ((codes - np.int64(cmin)) * np.int64(n)
                    + np.arange(n, dtype=np.int64))
            return np.argsort(comp)
    return np.argsort(codes, kind="stable")


def _merge_string_spaces(uniqs: Sequence[np.ndarray]
                         ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Merge string coding spaces over their distinct records. Each space
    is a sorted (d, w) matrix of unique records (payload zero-padded to
    w - 4, then a 4-byte big-endian length). Returns ``(remaps, merged)``:
    ``remaps[i][old_code]`` is the merged code (0 stays 0, the null
    code)."""
    pw = max(u.shape[1] for u in uniqs) - 4
    recs = []
    for u in uniqs:
        w = u.shape[1] - 4
        if w < pw:
            u = np.concatenate(
                [u[:, :w], np.zeros((len(u), pw - w), np.uint8),
                 u[:, w:]], axis=1)
        recs.append(u)
    allu = np.ascontiguousarray(np.concatenate(recs, axis=0))
    if not len(allu):
        return [np.zeros(1, np.int64) for _ in uniqs], allu
    inv, merged = _rank_byte_rows(allu)
    remaps, off = [], 0
    for u in uniqs:
        r = np.zeros(len(u) + 1, np.int64)
        r[1:] = inv[off:off + len(u)] + 1
        remaps.append(r)
        off += len(u)
    return remaps, merged


def _fixed_codes(col: HostColumn, force_float: bool = False) -> np.ndarray:
    arr = np.asarray(col.data)
    val = np.asarray(col.validity, np.bool_)
    if arr.dtype.kind == "f" or force_float:
        f = arr.astype(np.float64) + 0.0          # -0.0 -> 0.0
        bits = f.view(np.int64)
        bits = np.where(np.isnan(f), _NAN_CANON, bits)
        # Sign-flip encode: total order over the reals, NaN greatest.
        bits = np.where(bits >= 0, bits,
                        bits ^ np.int64(0x7FFFFFFFFFFFFFFF))
        return np.where(val, bits, np.int64(0))
    codes = arr.astype(np.int64, copy=False)
    return np.where(val, codes, np.int64(0))


def _string_codes(cols: Sequence[HostColumn]
                  ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Jointly rank string columns into lexicographic codes; returns
    ``(codes_per_col, unique_records)``. Rows become zero-padded byte
    records with a big-endian length suffix (a string with trailing NULs
    cannot collide with its shorter prefix), so record order is bytewise
    lexicographic order and the ranks are order-preserving and
    equality-exact."""
    mats, lens_l, vals_l = [], [], []
    for c in cols:
        m, lens = strings_to_matrix(c)
        val = np.asarray(c.validity, np.bool_)
        # Only the first ``len`` bytes are contractual.
        live = (np.arange(m.shape[1]) < lens[:, None]) & val[:, None]
        mats.append(np.where(live, m, np.uint8(0)))
        lens_l.append(np.where(val, lens, 0).astype(np.int64))
        vals_l.append(val)
    w = max((m.shape[1] for m in mats), default=1)
    recs = []
    for m, lens in zip(mats, lens_l):
        if m.shape[1] < w:
            m = np.pad(m, ((0, 0), (0, w - m.shape[1])))
        recs.append(np.concatenate(
            [m, lens.astype(">u4").view(np.uint8).reshape(len(lens), 4)],
            axis=1))
    allm = np.ascontiguousarray(np.concatenate(recs, axis=0))
    uniq = np.zeros((0, allm.shape[1] if allm.ndim == 2 else w + 4),
                    np.uint8)
    if not allm.shape[0]:
        return [np.zeros(0, np.int64) for _ in cols], uniq
    # Rank the valid rows only: null rows take code 0.
    validall = np.concatenate(vals_l) if len(vals_l) > 1 else \
        np.asarray(vals_l[0], np.bool_)
    inv = np.zeros(allm.shape[0], np.int64)
    sel = np.flatnonzero(validall)
    if len(sel):
        sub = allm[sel] if len(sel) < allm.shape[0] else allm
        ranks, uniq = _rank_byte_rows(sub)
        inv[sel] = ranks + 1
    out, off = [], 0
    for c in cols:
        out.append(inv[off:off + c.num_rows])
        off += c.num_rows
    return out, uniq


def _rank_byte_rows(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Dense lexicographic rank of (n, w) uint8 rows; returns ``(ranks,
    unique_rows)`` with unique_rows sorted. Narrow keys pack into
    big-endian uint64 words ranked by lexsort passes; wide keys rank by
    ``np.unique`` over a void view."""
    n, w = rows.shape
    w8 = -(-w // 8) * 8
    if w8 > 24:
        voided = np.ascontiguousarray(rows) \
            .view(np.dtype((np.void, w))).ravel()
        u, inv = np.unique(voided, return_inverse=True)
        return (inv.astype(np.int64),
                np.ascontiguousarray(u).view(np.uint8).reshape(-1, w))
    orig = rows
    if w8 != w:
        rows = np.pad(rows, ((0, 0), (0, w8 - w)))
    words = np.ascontiguousarray(rows).view(">u8").astype(np.uint64)
    planes = tuple(words[:, j] for j in range(words.shape[1] - 1, -1, -1))
    order = planes[-1].argsort(kind="stable") if len(planes) == 1 \
        else np.lexsort(planes)
    sw = words[order]
    newg = np.empty(n, np.bool_)
    newg[0] = True
    np.any(sw[1:] != sw[:-1], axis=1, out=newg[1:])
    inv = np.empty(n, np.int64)
    inv[order] = np.cumsum(newg) - 1
    return inv, np.ascontiguousarray(orig[order[newg]])


def strings_to_matrix(col: HostColumn) -> Tuple[np.ndarray, np.ndarray]:
    """Host string column -> ((n, w) uint8 byte matrix, (n,) int32
    lengths). ``None`` entries become empty strings."""
    if col.str_matrix is not None:
        return col.str_matrix, col.str_lengths
    n = col.num_rows
    vals = [b"" if b is None else bytes(b) for b in col.data]
    if not n:
        return np.zeros((0, 1), np.uint8), np.zeros(0, np.int32)
    lens = np.fromiter(map(len, vals), dtype=np.int64, count=n)
    w = max(int(lens.max()), 1)
    m = np.zeros((n, w), dtype=np.uint8)
    total = int(lens.sum())
    if total:
        flat = np.frombuffer(b"".join(vals), dtype=np.uint8)
        rows = np.repeat(np.arange(n, dtype=np.int64), lens)
        starts = np.cumsum(lens) - lens
        pos = np.arange(total, dtype=np.int64) - np.repeat(starts, lens)
        m[rows, pos] = flat
    return m, lens.astype(np.int32)


def matrix_to_strings(data: np.ndarray, lengths: np.ndarray,
                      validity: np.ndarray) -> HostColumn:
    """Inverse of strings_to_matrix; the object array stays lazy."""
    return HostColumn(dt.STRING, None, np.asarray(validity, np.bool_),
                      str_matrix=np.asarray(data),
                      str_lengths=np.asarray(lengths, np.int32))


@dataclasses.dataclass
class StringMatrixView:
    """A host string column in the dense device layout (byte matrix +
    lengths + validity, with its dtype): the adapter every host string
    kernel reads."""

    dtype: DataType
    data: np.ndarray          # (n, w) uint8
    lengths: np.ndarray       # (n,) int32
    validity: np.ndarray      # (n,) bool

    @classmethod
    def of(cls, col: HostColumn) -> "StringMatrixView":
        m, lens = strings_to_matrix(col)
        return cls(col.dtype, m, lens, col.validity)


def concat_host_batches(hbs: Sequence[HostBatch]) -> HostBatch:
    """Row-concatenate host batches; string columns merge as byte
    matrices, so no object arrays are built."""
    assert hbs, "concat of zero host batches"
    if len(hbs) == 1:
        return hbs[0]
    cols = []
    for ci, c0 in enumerate(hbs[0].columns):
        members = [hb.columns[ci] for hb in hbs]
        val = np.concatenate([m.validity for m in members])
        if c0.dtype.is_string:
            mats = [strings_to_matrix(m) for m in members]
            w = max(mm.shape[1] for mm, _ in mats)
            mat = np.zeros((len(val), w), np.uint8)
            lens = np.concatenate([ln for _, ln in mats]).astype(np.int32)
            off = 0
            for mm, _ in mats:
                mat[off:off + mm.shape[0], :mm.shape[1]] = mm
                off += mm.shape[0]
            out = HostColumn(c0.dtype, None, val,
                             str_matrix=mat, str_lengths=lens)
            # Pieces coded in ONE shared space concatenate their codes.
            if all(m._key_codes is not None for m in members) and \
                    len({id(m._key_uniq) for m in members}) == 1 and \
                    members[0]._key_uniq is not None:
                out._key_codes = np.concatenate(
                    [m._key_codes for m in members])
                out._key_uniq = members[0]._key_uniq
            cols.append(out)
        else:
            cols.append(HostColumn(
                c0.dtype, np.concatenate([m.data for m in members]), val))
    return HostBatch(hbs[0].names, cols)


# ---------------------------------------------------------------------------
# Transitions (host -> device -> host)
# ---------------------------------------------------------------------------

def host_to_device(batch: HostBatch, capacity: Optional[int] = None,
                   string_widths: Optional[dict] = None,
                   device: DeviceLike = None,
                   mode: Optional[str] = None) -> DeviceBatch:
    """Upload a host batch into a fresh fixed-capacity device batch on
    ``device`` (``None`` = the CUDA card, raising when there is none).

    The upload goes through the wire codec (``columnar/wire.py``): narrow
    lossless wire dtypes and packed or absent validity in one staging
    buffer, one host->device copy, and an on-device widen back to the
    logical layout, as the JAX package's ``host_to_device`` does.
    ``mode`` picks the codec (None: the active mode); every mode gives
    the same device buffers."""
    from spark_rapids_tpu_torch.columnar import wire
    return wire.upload(batch, capacity, string_widths, device, mode)


def download_batches(batches: Sequence[DeviceBatch],
                     names: Optional[Sequence[str]] = None,
                     moved: Optional[dict] = None) -> List[HostBatch]:
    """Download device batches with one batched copy: large batches first
    shrink to their live bucket (one batched row-count pull), then every
    remaining buffer is copied to the host in one pass and synchronized
    once; selection vectors filter on the host. ``moved``, when given,
    gains the bytes copied (``bytes``) and the live rows (``rows``)."""
    batches, _ = shrink_all(batches, min_bytes=MIN_SHRINK_BYTES)
    leaves: List[torch.Tensor] = []
    for b in batches:
        leaves.append(b.num_rows)
        if b.sel is not None:
            leaves.append(b.sel)
        for c in b.columns:
            leaves.append(c.data)
            leaves.append(c.validity)
            if c.dtype.is_string:
                leaves.append(c.lengths)
    fetched = [t.to("cpu", non_blocking=True) for t in leaves]
    if any(t.is_cuda for t in leaves):
        torch.cuda.synchronize()
    if moved is not None:
        moved["bytes"] = moved.get("bytes", 0) + sum(
            t.numel() * t.element_size() for t in leaves)
    it = iter(fetched)
    out = []
    for b in batches:
        n = int(next(it))
        keep = next(it).numpy()[:n] if b.sel is not None else None
        cols = []
        for c in b.columns:
            data_h = next(it).numpy()[:n]
            validity = next(it).numpy()[:n]
            lengths = next(it).numpy()[:n] if c.dtype.is_string else None
            if keep is not None:
                data_h, validity = data_h[keep], validity[keep]
                if lengths is not None:
                    lengths = lengths[keep]
            if c.dtype.is_string:
                cols.append(matrix_to_strings(data_h, lengths, validity))
            else:
                data = data_h.copy()
                data[~validity] = np.zeros(1, c.dtype.np_dtype)
                cols.append(HostColumn(c.dtype, data, validity))
        batch_names = tuple(names) if names is not None else \
            tuple(f"c{i}" for i in range(b.num_columns))
        out.append(HostBatch(batch_names, cols))
        if moved is not None:
            moved["rows"] = moved.get("rows", 0) + out[-1].num_rows
    return out


def device_to_host(batch: DeviceBatch,
                   names: Optional[Sequence[str]] = None) -> HostBatch:
    """Download one device batch, trimming padding rows."""
    return download_batches([batch], names)[0]


def from_jax_batch_arrays(dtypes: Sequence[DataType],
                          columns: Sequence[Tuple[np.ndarray, np.ndarray,
                                                  Optional[np.ndarray]]],
                          num_rows: int, device: DeviceLike = None,
                          sel: Optional[np.ndarray] = None) -> DeviceBatch:
    """The JAX package's device batch, as numpy arrays — each column's
    ``(data, validity, lengths-or-None)`` plus ``num_rows`` (and ``sel``
    where it has one) — turned into this package's ``DeviceBatch``
    buffer for buffer, so a test can feed both engines identical device
    state."""
    dev = resolve_device(device)
    cols = []
    for t, (data, validity, lengths) in zip(dtypes, columns):
        lens = None if lengths is None else \
            torch.from_numpy(np.asarray(lengths, np.int32).copy()).to(dev)
        cols.append(DeviceColumn(
            t, torch.from_numpy(np.asarray(data, t.np_dtype).copy()).to(dev),
            torch.from_numpy(np.asarray(validity, np.bool_).copy()).to(dev),
            lens))
    sel_t = None if sel is None else \
        torch.from_numpy(np.asarray(sel, np.bool_).copy()).to(dev)
    return DeviceBatch(tuple(cols),
                       torch.tensor(int(num_rows), dtype=torch.int32,
                                    device=dev), sel=sel_t)
