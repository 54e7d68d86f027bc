"""String predicates with a literal needle (port of the JAX package's
``exprs/strings.py``, cut to ``byte_mask``, ``_sliding_match``,
``_NeedleOp``, ``Contains``, ``StartsWith`` and ``EndsWith``).

A string column is a dense ``(N, W)`` uint8 matrix plus int32 lengths
(``columnar/batch.py``). A needle match is a sliding-window equality over
the width axis: ``O(W * |needle|)`` elementwise work and no per-row loop.
Bytes are compared, so multibyte UTF-8 needles match as the reference
matches them. The rest of the module (case, length, substring, locate,
like, replace) comes in a later slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exprs.base import (
    Expression, Scalar, as_device_column, make_column)


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

    def _needle_bytes(self, batch) -> Tuple[bytes, bool]:
        v = self.needle.eval(batch)
        if not isinstance(v, Scalar):
            raise TypeError(f"{type(self).__name__} needle must be a literal")
        if v.is_null:
            return b"", True
        return v.as_bytes(), False

    def _match(self, data: torch.Tensor, lengths: torch.Tensor,
               needle: bytes) -> torch.Tensor:
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


class Contains(_NeedleOp):
    def _match(self, data, lengths, needle):
        return _sliding_match(data, lengths, needle).any(dim=1)


class StartsWith(_NeedleOp):
    def _match(self, data, lengths, needle):
        return _sliding_match(data, lengths, needle)[:, 0]


class EndsWith(_NeedleOp):
    def _match(self, data, lengths, needle):
        hits = _sliding_match(data, lengths, needle)
        m = len(needle)
        pos = (lengths - m).clamp(0, data.shape[1] - 1)
        at_end = hits.gather(1, pos[:, None].long())[:, 0]
        return at_end & (lengths >= m)
