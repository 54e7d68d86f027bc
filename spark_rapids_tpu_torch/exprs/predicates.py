"""Predicates and comparisons (port of the JAX package's
``exprs/predicates.py``: the ``_Comparison`` family, ``And``/``Or``/``Not``,
``IsNull``/``IsNotNull``).

Spark semantics:
- NaN equals NaN and is greater than every other float value.
- A subnormal float compares as a zero of its sign, as the JAX package's
  device path does (it flushes denormals).
- And/Or use Kleene three-valued logic (false AND null = false,
  true OR null = true).
- EqualNullSafe (``<=>``) never returns NULL.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import flush_subnormal
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exprs.base import (
    BinaryExpression, UnaryExpression, as_device_column, make_column)


def _string_cmp(l_data, l_len, r_data, r_len):
    """Lexicographic byte compare of two (N, W) padded matrices; returns
    (lt, eq). Zero padding is safe: bytes compare unsigned and the real
    lengths break ties."""
    wl, wr = l_data.shape[1], r_data.shape[1]
    w = max(wl, wr)
    n = l_data.shape[0]
    if wl < w:
        l_data = torch.cat([l_data, l_data.new_zeros((n, w - wl))], dim=1)
    if wr < w:
        r_data = torch.cat([r_data, r_data.new_zeros((n, w - wr))], dim=1)
    diff = l_data.to(torch.int16) - r_data.to(torch.int16)
    nz = diff != 0
    any_nz = nz.any(dim=1)
    first = torch.where(any_nz, nz.to(torch.int8).argmax(dim=1),
                        torch.full((), w, dtype=torch.int64,
                                   device=diff.device))
    idx = first.clamp(max=w - 1)
    d = diff.gather(1, idx[:, None])[:, 0]
    bytes_eq = first == w
    eq = bytes_eq & (l_len == r_len)
    lt = torch.where(bytes_eq, l_len < r_len, d < 0)
    return lt, eq


class _Comparison(BinaryExpression):
    def data_type(self) -> DataType:
        return dt.BOOL

    def _lt_eq(self, l_col, r_col):
        """(lt, eq) with Spark NaN ordering for floats."""
        t = self.left.data_type()
        if t.is_string:
            return _string_cmp(l_col.data, l_col.lengths,
                               r_col.data, r_col.lengths)
        a, b = l_col.data, r_col.data
        if a.is_floating_point():
            a = flush_subnormal(a)      # as the reference compares
        if b.is_floating_point():
            b = flush_subnormal(b)
        if a.dtype != b.dtype:
            common = torch.promote_types(a.dtype, b.dtype)
            a, b = a.to(common), b.to(common)
        if t.is_floating:
            na, nb = torch.isnan(a), torch.isnan(b)
            eq = (a == b) | (na & nb)
            lt = (~na & nb) | ((a < b) & ~na & ~nb)
            return lt, eq
        return a < b, a == b

    def _pick(self, lt, eq):
        raise NotImplementedError

    def eval(self, batch):
        lc = as_device_column(self.left.eval(batch), batch)
        rc = as_device_column(self.right.eval(batch), batch)
        lt, eq = self._lt_eq(lc, rc)
        return make_column(dt.BOOL, self._pick(lt, eq),
                           lc.validity & rc.validity)


class EqualTo(_Comparison):
    def _pick(self, lt, eq):
        return eq


class LessThan(_Comparison):
    def _pick(self, lt, eq):
        return lt


class LessThanOrEqual(_Comparison):
    def _pick(self, lt, eq):
        return lt | eq


class GreaterThan(_Comparison):
    def _pick(self, lt, eq):
        return ~(lt | eq)


class GreaterThanOrEqual(_Comparison):
    def _pick(self, lt, eq):
        return ~lt


class EqualNullSafe(_Comparison):
    """``<=>``: NULL <=> NULL is true; never returns NULL."""

    def eval(self, batch):
        lc = as_device_column(self.left.eval(batch), batch)
        rc = as_device_column(self.right.eval(batch), batch)
        _, eq = self._lt_eq(lc, rc)
        lv, rv = lc.validity, rc.validity
        data = (lv & rv & eq) | (~lv & ~rv)
        # Padding rows must still be invalid.
        return make_column(dt.BOOL, data, batch.row_mask())


class Not(UnaryExpression):
    def data_type(self) -> DataType:
        return dt.BOOL

    def do_columnar(self, data, validity, col):
        return ~data, validity


class And(BinaryExpression):
    """Kleene: F AND x = F even when x is NULL."""

    def data_type(self) -> DataType:
        return dt.BOOL

    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        l_false = l_valid & ~l_data
        r_false = r_valid & ~r_data
        data = l_data & r_data
        validity = (l_valid & r_valid) | l_false | r_false
        return data & l_valid & r_valid, validity


class Or(BinaryExpression):
    """Kleene: T OR x = T even when x is NULL."""

    def data_type(self) -> DataType:
        return dt.BOOL

    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        l_true = l_valid & l_data
        r_true = r_valid & r_data
        data = l_true | r_true
        validity = (l_valid & r_valid) | l_true | r_true
        return data, validity


class IsNull(UnaryExpression):
    def data_type(self) -> DataType:
        return dt.BOOL

    def eval(self, batch):
        col = as_device_column(self.child.eval(batch), batch)
        return make_column(dt.BOOL, ~col.validity, batch.row_mask())


class IsNotNull(UnaryExpression):
    def data_type(self) -> DataType:
        return dt.BOOL

    def eval(self, batch):
        col = as_device_column(self.child.eval(batch), batch)
        return make_column(dt.BOOL, col.validity, batch.row_mask())
