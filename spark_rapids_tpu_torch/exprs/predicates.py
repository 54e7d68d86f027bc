"""Predicates and comparisons (port of the JAX package's
``exprs/predicates.py``: the ``_Comparison`` family, ``And``/``Or``/``Not``,
``IsNull``/``IsNotNull``, ``IsNan``, ``AtLeastNNonNulls``, ``InSet``).

Spark semantics:
- NaN equals NaN and is greater than every other float value.
- On the device a subnormal float compares as a zero of its sign, as the
  JAX package's device path does (it flushes denormals). The host half
  (``eval_host``, numpy) never flushes, as the reference's host engine.
- And/Or use Kleene three-valued logic (false AND null = false,
  true OR null = true).
- EqualNullSafe (``<=>``) never returns NULL.
- AtLeastNNonNulls counts NaN in a float child as NULL, and is never
  NULL itself (the predicate behind ``df.na.drop(thresh=n)``).
- InSet (``IN (v1, ...)``): a NULL value gives NULL, and so does a value
  that matches nothing when the list holds a NULL; a NaN in the list
  matches NaN.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import flush_subnormal
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.columnar.host import StringMatrixView, all_valid
from spark_rapids_tpu_torch.exprs.base import (
    BinaryExpression, Expression, UnaryExpression, as_device_column,
    as_host_column, make_column, make_host_column)


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


def _string_cmp_host(l_data, l_len, r_data, r_len):
    """:func:`_string_cmp` in numpy, over host byte matrices."""
    wl, wr = l_data.shape[1], r_data.shape[1]
    w = max(wl, wr)
    if wl < w:
        l_data = np.concatenate(
            [l_data, np.zeros((l_data.shape[0], w - wl), np.uint8)], axis=1)
    if wr < w:
        r_data = np.concatenate(
            [r_data, np.zeros((r_data.shape[0], w - wr), np.uint8)], axis=1)
    diff = l_data.astype(np.int16) - r_data.astype(np.int16)
    nz = diff != 0
    first = np.where(nz.any(axis=1), np.argmax(nz, axis=1), w)
    idx = np.minimum(first, w - 1)
    d = np.take_along_axis(diff, idx[:, None], axis=1)[:, 0]
    bytes_eq = first == w
    eq = bytes_eq & (l_len == r_len)
    lt = np.where(bytes_eq, l_len < r_len, d < 0)
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

    def _lt_eq_host(self, l_col, r_col):
        """(lt, eq) over host columns: numpy's promotion, no flush."""
        if self.left.data_type().is_string:
            lm, rm = StringMatrixView.of(l_col), StringMatrixView.of(r_col)
            return _string_cmp_host(lm.data, lm.lengths, rm.data,
                                    rm.lengths)
        a, b = l_col.data, r_col.data
        if self.left.data_type().is_floating:
            na, nb = np.isnan(a), np.isnan(b)
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

    def eval_host(self, batch):
        lc = as_host_column(self.left.eval_host(batch), batch)
        rc = as_host_column(self.right.eval_host(batch), batch)
        lt, eq = self._lt_eq_host(lc, rc)
        return make_host_column(dt.BOOL, self._pick(lt, eq),
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

    def eval_host(self, batch):
        lc = as_host_column(self.left.eval_host(batch), batch)
        rc = as_host_column(self.right.eval_host(batch), batch)
        _, eq = self._lt_eq_host(lc, rc)
        lv, rv = lc.validity, rc.validity
        return make_host_column(dt.BOOL, (lv & rv & eq) | (~lv & ~rv),
                                all_valid(batch.num_rows))


class Not(UnaryExpression):
    def data_type(self) -> DataType:
        return dt.BOOL

    def do_columnar(self, data, validity, col):
        return ~data, validity

    # The same boolean operators on numpy arrays.
    do_host = do_columnar


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

    do_host = do_columnar


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

    do_host = do_columnar


class IsNull(UnaryExpression):
    def data_type(self) -> DataType:
        return dt.BOOL

    def eval(self, batch):
        col = as_device_column(self.child.eval(batch), batch)
        return make_column(dt.BOOL, ~col.validity, batch.row_mask())

    def eval_host(self, batch):
        col = as_host_column(self.child.eval_host(batch), batch)
        return make_host_column(dt.BOOL, ~col.validity,
                                all_valid(batch.num_rows))


class IsNotNull(UnaryExpression):
    def data_type(self) -> DataType:
        return dt.BOOL

    def eval(self, batch):
        col = as_device_column(self.child.eval(batch), batch)
        return make_column(dt.BOOL, col.validity, batch.row_mask())

    def eval_host(self, batch):
        col = as_host_column(self.child.eval_host(batch), batch)
        return make_host_column(dt.BOOL, col.validity,
                                all_valid(batch.num_rows))


class IsNan(UnaryExpression):
    def data_type(self) -> DataType:
        return dt.BOOL

    def do_columnar(self, data, validity, col):
        return torch.isnan(data), validity

    def do_host(self, data, validity, col):
        return np.isnan(data), validity


class AtLeastNNonNulls(Expression):
    """True where at least ``n`` children are non-null (NaN in a float
    child counts as NULL); never NULL."""

    def __init__(self, n: int, *children: Expression):
        self.n = int(n)
        self._children = tuple(children)

    @property
    def children(self):
        return self._children

    def data_type(self) -> DataType:
        return dt.BOOL

    def _non_null(self, isnan, cols):
        """Each child's non-null (and, for floats, non-NaN) mask."""
        for e, c in zip(self._children, cols):
            ok = c.validity
            if e.data_type().is_floating:
                ok = ok & ~isnan(c.data)
            yield ok

    def eval(self, batch):
        cols = [as_device_column(e.eval(batch), batch)
                for e in self._children]
        acc = torch.zeros(batch.capacity, dtype=torch.int32,
                          device=batch.device)
        for ok in self._non_null(torch.isnan, cols):
            acc = acc + ok.to(torch.int32)
        return make_column(dt.BOOL, acc >= self.n, batch.row_mask())

    def eval_host(self, batch):
        cols = [as_host_column(e.eval_host(batch), batch)
                for e in self._children]
        acc = np.zeros(batch.num_rows, np.int32)
        for ok in self._non_null(np.isnan, cols):
            acc = acc + ok.astype(np.int32)
        return make_host_column(dt.BOOL, acc >= self.n,
                                all_valid(batch.num_rows))


def _host_strings_to_matrix(col):
    return StringMatrixView.of(col)


def _in_list_target(v, width: int):
    """A string list value as the (width,) zero-padded byte row it is held
    to, and its length: a value wider than the column's matrix is cut to
    the width and then fails on its length."""
    b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
    target = np.zeros(width, dtype=np.uint8)
    target[:min(len(b), width)] = np.frombuffer(b[:width], dtype=np.uint8)
    return target, len(b)


class InSet(Expression):
    """value IN (literals). A NULL value gives NULL; no match against a
    list that holds a NULL gives NULL. Strings match by bytes and length
    against the padded matrix; numbers after the cast to the column's
    numpy type. On the device a subnormal float compares as a zero of its
    sign (as the JAX package's device engine does), on the host as
    itself."""

    def __init__(self, child: Expression, values):
        self.child = child
        self.values = tuple(values)

    @property
    def children(self):
        return (self.child,)

    def data_type(self) -> DataType:
        return dt.BOOL

    def _split(self):
        has_null = any(v is None for v in self.values)
        return has_null, [v for v in self.values if v is not None]

    def eval(self, batch):
        col = as_device_column(self.child.eval(batch), batch)
        t = self.child.data_type()
        has_null, present = self._split()
        dev = col.data.device
        acc = torch.zeros(col.data.shape[0], dtype=torch.bool, device=dev)
        if t.is_string:
            for v in present:
                target, n = _in_list_target(v, col.data.shape[1])
                row = torch.from_numpy(target).to(dev)
                acc = acc | ((col.data == row[None, :]).all(dim=1)
                             & (col.lengths == n))
        else:
            data = col.data
            if data.is_floating_point():
                data = flush_subnormal(data)
            for v in present:
                if t.is_floating and isinstance(v, float) and np.isnan(v):
                    acc = acc | torch.isnan(data)
                    continue
                x = t.np_dtype.type(v)
                if t.is_floating and abs(x) < np.finfo(x.dtype).tiny:
                    x = x * 0           # a zero of its sign, as above
                acc = acc | (data == x.item())
        return make_column(dt.BOOL, acc, col.validity & (acc | (not has_null)))

    def eval_host(self, batch):
        col = as_host_column(self.child.eval_host(batch), batch)
        t = self.child.data_type()
        has_null, present = self._split()
        if t.is_string:
            col = _host_strings_to_matrix(col)
        acc = np.zeros(col.data.shape[0], dtype=np.bool_)
        for v in present:
            if t.is_string:
                target, n = _in_list_target(v, col.data.shape[1])
                acc = acc | ((col.data == target[None, :]).all(axis=1)
                             & (col.lengths == n))
            elif t.is_floating and isinstance(v, float) and np.isnan(v):
                acc = acc | np.isnan(col.data)
            else:
                acc = acc | (col.data == t.np_dtype.type(v))
        return make_host_column(dt.BOOL, acc,
                                col.validity & (acc | (not has_null)))
