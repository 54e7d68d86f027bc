"""Expression engine core (port of the JAX package's ``exprs/base.py``).

``eval(DeviceBatch) -> DeviceColumn | Scalar`` runs eagerly in torch ops on
fixed-capacity columns. Null semantics are SQL three-valued: a row's output
validity is the AND of the input validities unless an expression overrides
it. Data under dead rows is zeroed so padding stays deterministic.

The JAX package's host (numpy) evaluation path is its CPU-fallback engine;
the port's CPU path is the same torch code on CPU tensors, so there is no
separate host eval here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, DeviceColumn, torch_dtype, zero_dead)
from spark_rapids_tpu_torch.columnar.dtypes import DataType


@dataclasses.dataclass(frozen=True)
class Scalar:
    """A typed scalar value; ``value is None`` means the SQL NULL literal."""

    dtype: DataType
    value: Any

    @property
    def is_null(self) -> bool:
        return self.value is None

    def as_bytes(self) -> bytes:
        assert self.dtype.is_string and self.value is not None
        v = self.value
        return v.encode("utf-8") if isinstance(v, str) else bytes(v)


ColumnLike = Union[DeviceColumn, Scalar]


class Expression:
    """Base expression node."""

    def data_type(self) -> DataType:
        raise NotImplementedError

    @property
    def children(self) -> Tuple["Expression", ...]:
        return ()

    def eval(self, batch: DeviceBatch) -> ColumnLike:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Scalar <-> column broadcasting
# ---------------------------------------------------------------------------

def expand_scalar(s: Scalar, capacity: int, row_mask: torch.Tensor,
                  string_width: Optional[int] = None) -> DeviceColumn:
    """Broadcast a scalar into a full device column (live rows only)."""
    dev = row_mask.device
    validity = row_mask & (not s.is_null)
    if s.dtype.is_string:
        b = b"" if s.is_null else s.as_bytes()
        width = max(string_width or dt.string_width_bucket(len(b)), len(b), 1)
        row = np.zeros(width, dtype=np.uint8)
        row[:len(b)] = np.frombuffer(b, dtype=np.uint8)
        data = torch.from_numpy(row).to(dev)[None, :].expand(capacity, width)
        data = zero_dead(data, validity)
        lengths = torch.where(validity,
                              torch.full((), len(b), dtype=torch.int32,
                                         device=dev),
                              torch.zeros((), dtype=torch.int32, device=dev))
        return DeviceColumn(s.dtype, data, validity, lengths)
    fill = s.dtype.np_dtype.type(0 if s.is_null else s.value)
    data = torch.full((capacity,), fill.item(), dtype=torch_dtype(s.dtype),
                      device=dev)
    return DeviceColumn(s.dtype, zero_dead(data, validity), validity)


def as_device_column(v: ColumnLike, batch: DeviceBatch,
                     string_width: Optional[int] = None) -> DeviceColumn:
    if isinstance(v, Scalar):
        return expand_scalar(v, batch.capacity, batch.row_mask(),
                             string_width)
    return v


def make_column(dtype: DataType, data: torch.Tensor, validity: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> DeviceColumn:
    """Build a device column, zeroing data under dead rows."""
    if not dtype.is_string:
        data = data.to(torch_dtype(dtype))
    data = zero_dead(data, validity)
    if dtype.is_string:
        lengths = torch.where(validity, lengths, torch.zeros_like(lengths))
        return DeviceColumn(dtype, data, validity, lengths)
    return DeviceColumn(dtype, data, validity)


# ---------------------------------------------------------------------------
# Leaf expressions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BoundReference(Expression):
    """Column by ordinal."""

    ordinal: int
    dtype: DataType
    name: str = ""

    def data_type(self) -> DataType:
        return self.dtype

    def eval(self, batch: DeviceBatch) -> DeviceColumn:
        return batch.columns[self.ordinal]


@dataclasses.dataclass
class Literal(Expression):
    """Constant. ``value is None`` -> typed NULL."""

    dtype: DataType
    value: Any

    def data_type(self) -> DataType:
        return self.dtype

    def eval(self, batch: DeviceBatch) -> Scalar:
        return Scalar(self.dtype, self.value)


def lit(value: Any, dtype: Optional[DataType] = None) -> Literal:
    """Literal builder with python-type inference (same rules as the JAX
    package: python ints are INT32 when they fit, floats are FLOAT64)."""
    if dtype is None:
        if isinstance(value, bool):
            dtype = dt.BOOL
        elif isinstance(value, int):
            dtype = dt.INT32 if -2**31 <= value < 2**31 else dt.INT64
        elif isinstance(value, float):
            dtype = dt.FLOAT64
        elif isinstance(value, (str, bytes)):
            dtype = dt.STRING
        else:
            raise TypeError(f"cannot infer literal type for {value!r}")
    return Literal(dtype, value)


# ---------------------------------------------------------------------------
# Unary / binary templates
# ---------------------------------------------------------------------------

class UnaryExpression(Expression):
    """Template: null in -> null out; subclass provides the kernel."""

    def __init__(self, child: Expression):
        self.child = child

    @property
    def children(self) -> Tuple[Expression, ...]:
        return (self.child,)

    def do_columnar(self, data, validity, col: DeviceColumn):
        """Return (data, validity) given raw tensors."""
        raise NotImplementedError

    def eval(self, batch: DeviceBatch) -> ColumnLike:
        col = as_device_column(self.child.eval(batch), batch)
        data, validity = self.do_columnar(col.data, col.validity, col)
        return make_column(self.data_type(), data, validity)


class BinaryExpression(Expression):
    """Template handling scalar/column operand combinations."""

    def __init__(self, left: Expression, right: Expression):
        self.left = left
        self.right = right

    @property
    def children(self) -> Tuple[Expression, ...]:
        return (self.left, self.right)

    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        """Return (data, validity) from raw operand tensors."""
        raise NotImplementedError

    def eval(self, batch: DeviceBatch) -> ColumnLike:
        lc = as_device_column(self.left.eval(batch), batch)
        rc = as_device_column(self.right.eval(batch), batch)
        data, validity = self.do_columnar(lc.data, lc.validity,
                                          rc.data, rc.validity)
        return make_column(self.data_type(), data, validity)


def eval_exprs(exprs: Sequence[Expression],
               batch: DeviceBatch) -> DeviceBatch:
    """Project: evaluate expressions into a new device batch."""
    return project_batch(
        tuple(as_device_column(e.eval(batch), batch) for e in exprs), batch)


def project_batch(cols, batch: DeviceBatch) -> DeviceBatch:
    """New batch of ``cols`` sharing ``batch``'s liveness. A zero-column
    projection keeps liveness in the selection vector."""
    sel = batch.sel
    if not cols and sel is None:
        sel = batch.row_mask()
    return DeviceBatch(tuple(cols), batch.num_rows, sel=sel)
