"""Conditionals and null expressions (port of the JAX package's
``exprs/conditional.py``: ``If``, ``CaseWhen``, ``Coalesce``, ``Nvl``,
``NaNvl``, ``NormalizeNaNAndZero``, ``KnownFloatingPointNormalized``).

Whole-batch evaluation: every branch is evaluated over all rows and the
results are blended with ``where``, as in the reference (no divergent
control flow). Semantics:

- a NULL predicate takes the false branch (Spark's If and CaseWhen take a
  branch only where the predicate is true);
- ``CaseWhen`` folds right to left from the ELSE value, or from a typed
  NULL when there is none, so the first true branch wins;
- the result type is the first branch's;
- string branches of different widths are re-padded to the wider matrix;
- device validity is masked by the batch's live rows.

A blend is a select: subnormal floats pass through it unchanged on both
engines, as in the reference. The device half runs torch, the host half
numpy over host columns (strings in the byte-matrix layout).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import flush_subnormal
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.columnar.host import (
    StringMatrixView, matrix_to_strings)
from spark_rapids_tpu_torch.exprs.base import (
    BinaryExpression, Expression, Literal, UnaryExpression, as_device_column,
    as_host_column, make_column, make_host_column)


def _repad_matrix(data, w: int):
    """Widen (zero-pad) or narrow a raw (n, cur) byte matrix, a tensor or
    a numpy array, to width ``w``."""
    cur = data.shape[1]
    if cur == w:
        return data
    if cur > w:
        return data[:, :w]
    if isinstance(data, torch.Tensor):
        return torch.cat([data, data.new_zeros((data.shape[0], w - cur))],
                         dim=1)
    return np.concatenate(
        [data, np.zeros((data.shape[0], w - cur), np.uint8)], axis=1)


def _where(cond, a, b):
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return np.where(cond, a, b)


def _blend(cond, a_col, b_col, dtype):
    """Select ``a_col`` where ``cond`` else ``b_col``; returns (data,
    validity, lengths). Torch tensors on the device, numpy arrays on the
    host. Takes anything with (data, validity[, lengths]), the ``_Acc``
    fold included, so string widening happens on the raw matrices."""
    if dtype.is_string:
        w = max(a_col.data.shape[1], b_col.data.shape[1])
        data = _where(cond[:, None], _repad_matrix(a_col.data, w),
                      _repad_matrix(b_col.data, w))
        lengths = _where(cond, a_col.lengths, b_col.lengths)
        validity = _where(cond, a_col.validity, b_col.validity)
        return data, validity, lengths
    data = _where(cond, a_col.data, b_col.data)
    validity = _where(cond, a_col.validity, b_col.validity)
    return data, validity, None


# The reference's name for the numpy blend: the same body.
_host_blend = _blend


def _host_adapt(col, dtype):
    """A host column as ``_host_blend`` reads it: strings as their byte
    matrix view."""
    return StringMatrixView.of(col) if dtype.is_string else col


@dataclasses.dataclass
class _Acc:
    """The (data, validity, lengths) accumulator CaseWhen and Coalesce
    fold through: shaped like a column for the blends, without a dtype."""

    data: object
    validity: object
    lengths: object = None


def _matrix_to_host_strings(data, lengths, validity):
    return matrix_to_strings(data, lengths, validity)


def _host_result(t: DataType, data, validity, lengths):
    if t.is_string:
        return _matrix_to_host_strings(data, lengths, validity)
    return make_host_column(t, data, validity)


class If(Expression):
    """if(cond, a, b): the false branch wherever the predicate is not
    true, NULL included."""

    def __init__(self, predicate: Expression, true_value: Expression,
                 false_value: Expression):
        self.predicate = predicate
        self.true_value = true_value
        self.false_value = false_value

    @property
    def children(self):
        return (self.predicate, self.true_value, self.false_value)

    def data_type(self) -> DataType:
        return self.true_value.data_type()

    def eval(self, batch):
        t = self.data_type()
        p = as_device_column(self.predicate.eval(batch), batch)
        a = as_device_column(self.true_value.eval(batch), batch)
        b = as_device_column(self.false_value.eval(batch), batch)
        data, validity, lengths = _blend(p.data & p.validity, a, b, t)
        return make_column(t, data, validity & batch.row_mask(), lengths)

    def eval_host(self, batch):
        t = self.data_type()
        p = as_host_column(self.predicate.eval_host(batch), batch)
        a = _host_adapt(as_host_column(self.true_value.eval_host(batch),
                                       batch), t)
        b = _host_adapt(as_host_column(self.false_value.eval_host(batch),
                                       batch), t)
        return _host_result(t, *_host_blend(p.data & p.validity, a, b, t))


class CaseWhen(Expression):
    """CASE WHEN c1 THEN v1 ... [ELSE e] END: branch predicates over the
    whole batch, blended right to left so the first true branch wins."""

    def __init__(self, branches: Sequence[Tuple[Expression, Expression]],
                 else_value: Optional[Expression] = None):
        self.branches = list(branches)
        self.else_value = else_value

    @property
    def children(self):
        out: List[Expression] = []
        for c, v in self.branches:
            out.extend((c, v))
        if self.else_value is not None:
            out.append(self.else_value)
        return tuple(out)

    def data_type(self) -> DataType:
        return self.branches[0][1].data_type()

    def _else(self) -> Expression:
        return self.else_value or Literal(self.data_type(), None)

    def eval(self, batch):
        t = self.data_type()
        acc = as_device_column(self._else().eval(batch), batch)
        for cond_e, val_e in reversed(self.branches):
            c = as_device_column(cond_e.eval(batch), batch)
            v = as_device_column(val_e.eval(batch), batch)
            acc = _Acc(*_blend(c.data & c.validity, v, acc, t))
        return make_column(t, acc.data, acc.validity & batch.row_mask(),
                           acc.lengths)

    def eval_host(self, batch):
        t = self.data_type()
        acc = _host_adapt(as_host_column(self._else().eval_host(batch),
                                         batch), t)
        for cond_e, val_e in reversed(self.branches):
            c = as_host_column(cond_e.eval_host(batch), batch)
            v = _host_adapt(as_host_column(val_e.eval_host(batch), batch), t)
            acc = _Acc(*_host_blend(c.data & c.validity, v, acc, t))
        return _host_result(t, acc.data, acc.validity, acc.lengths)


class Coalesce(Expression):
    """The first non-null argument."""

    def __init__(self, *children: Expression):
        self._children = tuple(children)

    @property
    def children(self):
        return self._children

    def data_type(self) -> DataType:
        return self._children[0].data_type()

    def eval(self, batch):
        t = self.data_type()
        acc = as_device_column(self._children[-1].eval(batch), batch)
        for e in reversed(self._children[:-1]):
            c = as_device_column(e.eval(batch), batch)
            acc = _Acc(*_blend(c.validity, c, acc, t))
        return make_column(t, acc.data, acc.validity & batch.row_mask(),
                           acc.lengths)

    def eval_host(self, batch):
        t = self.data_type()
        acc = _host_adapt(as_host_column(
            self._children[-1].eval_host(batch), batch), t)
        for e in reversed(self._children[:-1]):
            c = _host_adapt(as_host_column(e.eval_host(batch), batch), t)
            acc = _Acc(*_host_blend(c.validity, c, acc, t))
        return _host_result(t, acc.data, acc.validity,
                            getattr(acc, "lengths", None))


def Nvl(a: Expression, b: Expression) -> Coalesce:
    return Coalesce(a, b)


class NaNvl(BinaryExpression):
    """nanvl(a, b): ``b`` (and its validity) where ``a`` is NaN."""

    def data_type(self) -> DataType:
        return self.left.data_type()

    def _blend(self, xp, l_data, l_valid, r_data, r_valid, r_cast):
        nan = xp.isnan(l_data)
        return (xp.where(nan, r_cast, l_data),
                xp.where(nan, r_valid, l_valid))

    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        return self._blend(torch, l_data, l_valid, r_data, r_valid,
                           r_data.to(l_data.dtype))

    def do_host(self, l_data, l_valid, r_data, r_valid):
        return self._blend(np, l_data, l_valid, r_data, r_valid,
                           r_data.astype(l_data.dtype))


class NormalizeNaNAndZero(UnaryExpression):
    """One NaN bit pattern and -0.0 as 0.0 (Spark's
    NormalizeFloatingNumbers, before grouping or joining on floats)."""

    def data_type(self) -> DataType:
        return self.child.data_type()

    def do_columnar(self, data, validity, col):
        data = torch.where(torch.isnan(data),
                           torch.full((), float("nan"), dtype=data.dtype,
                                      device=data.device), data)
        # The reference's engine compares a subnormal as a zero.
        return torch.where(flush_subnormal(data) == 0, data.abs(), data), \
            validity

    def do_host(self, data, validity, col):
        data = np.where(np.isnan(data), data.dtype.type(np.nan), data)
        return np.where(data == 0, np.abs(data), data), validity


class KnownFloatingPointNormalized(UnaryExpression):
    """Marker pass-through."""

    def data_type(self) -> DataType:
        return self.child.data_type()

    def do_columnar(self, data, validity, col):
        return data, validity

    def do_host(self, data, validity, col):
        return data, validity
