"""Expression engine core (port of the JAX package's ``exprs/base.py``).

Every expression has two evaluation paths:

- ``eval(DeviceBatch) -> DeviceColumn | Scalar`` runs eagerly in torch ops
  on fixed-capacity columns (the device engine);
- ``eval_host(HostBatch) -> HostColumn | Scalar`` runs numpy over host
  columns (the host engine, for the nodes the planner places on the
  host). It is numpy and not torch on the CPU: integer wrap, NaN and
  -0.0 handling and float rounding are numpy's, as in the reference's
  host engine, and subnormals are never flushed.

The unary and binary templates take a torch ``do_columnar`` and a numpy
``do_host`` (the reference's shared ``do_columnar(xp, ...)`` split in
two). Null semantics are SQL three-valued: a row's output validity is the
AND of the input validities unless an expression overrides it. Data under
dead (or null) rows is zeroed so padding stays deterministic.

A few expressions run on the host inside a device plan, as the reference
draws that line (regular expressions, translate, pad, replace, the
string side of casts, LIKE with ``_``): ``host_roundtrip`` downloads the
column, computes on the host and uploads the result. It is the
expression's own step, never a fallback for a device step that failed,
and it counts its rows and bytes (``island.<kind>.rows`` /
``.bytesDown`` / ``.bytesUp``) into the metrics of the operator whose
step is running (``island_sink``, set by ``ops.base.timed``).
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, DeviceColumn, torch_dtype, zero_dead)
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.columnar.host import (
    HostBatch, HostColumn, all_valid, download_batches, host_to_device,
    strings_to_matrix)


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
HostColumnLike = Union[HostColumn, Scalar]


class Expression:
    """Base expression node."""

    def data_type(self) -> DataType:
        raise NotImplementedError

    @property
    def children(self) -> Tuple["Expression", ...]:
        return ()

    def eval(self, batch: DeviceBatch) -> ColumnLike:
        raise NotImplementedError

    def eval_host(self, batch: HostBatch) -> HostColumnLike:
        raise NotImplementedError

    @property
    def self_jittable(self) -> bool:
        """False when this node's device eval does a host roundtrip (the
        JAX package's name: such a node stays out of compiled programs
        there, and out of fused stages here)."""
        return True

    @property
    def jittable(self) -> bool:
        """True when no node of the subtree makes a host roundtrip: the
        expression-level CPU islands stay out of fused stages
        (plan/fusion.py)."""
        return self.self_jittable and all(c.jittable for c in self.children)


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


def expand_scalar_host(s: Scalar, n: int) -> HostColumn:
    """Broadcast a scalar into an ``n``-row host column (both string
    layouts filled)."""
    validity = all_valid(n) if not s.is_null \
        else np.zeros(n, dtype=np.bool_)
    if s.dtype.is_string:
        b = b"" if s.is_null else s.as_bytes()
        data = np.empty(n, dtype=object)
        data[:] = b
        lens = np.zeros(n, np.int32) if s.is_null else \
            np.full(n, len(b), np.int32)
        m = np.zeros((n, max(len(b), 1)), np.uint8)
        if b and not s.is_null:
            m[:] = np.frombuffer(b, dtype=np.uint8)[None, :]
        return HostColumn(s.dtype, data, validity,
                          str_matrix=m, str_lengths=lens)
    data = np.full(n, 0 if s.is_null else s.value, dtype=s.dtype.np_dtype)
    return HostColumn(s.dtype, data, validity)


def as_device_column(v: ColumnLike, batch: DeviceBatch,
                     string_width: Optional[int] = None) -> DeviceColumn:
    if isinstance(v, Scalar):
        return expand_scalar(v, batch.capacity, batch.row_mask(),
                             string_width)
    return v


def as_host_column(v: HostColumnLike, batch: HostBatch) -> HostColumn:
    if isinstance(v, Scalar):
        return expand_scalar_host(v, batch.num_rows)
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


def make_host_column(dtype: DataType, data, validity) -> HostColumn:
    """Build a host column, zeroing data (empty bytes for strings) under
    null rows."""
    validity = np.asarray(validity, dtype=np.bool_)
    if not dtype.is_string:
        data = np.asarray(data).astype(dtype.np_dtype, copy=True)
        data[~validity] = np.zeros(1, dtype.np_dtype)
    else:
        out = np.empty(len(data), dtype=object)
        out[:] = data
        if not validity.all():
            out[~validity] = b""
        data = out
    return HostColumn(dtype, data, validity)


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

    def eval_host(self, batch: HostBatch) -> HostColumn:
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

    def eval_host(self, batch: HostBatch) -> Scalar:
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

    def do_host(self, data, validity, col: HostColumn):
        """Return (data, validity) given raw numpy arrays."""
        raise NotImplementedError

    def eval(self, batch: DeviceBatch) -> ColumnLike:
        col = as_device_column(self.child.eval(batch), batch)
        data, validity = self.do_columnar(col.data, col.validity, col)
        return make_column(self.data_type(), data, validity)

    def eval_host(self, batch: HostBatch) -> HostColumnLike:
        col = as_host_column(self.child.eval_host(batch), batch)
        data, validity = self.do_host(col.data, col.validity, col)
        return make_host_column(self.data_type(), data, validity)


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

    def do_host(self, l_data, l_valid, r_data, r_valid):
        """Return (data, validity) from raw numpy operand arrays."""
        raise NotImplementedError

    def eval(self, batch: DeviceBatch) -> ColumnLike:
        lc = as_device_column(self.left.eval(batch), batch)
        rc = as_device_column(self.right.eval(batch), batch)
        data, validity = self.do_columnar(lc.data, lc.validity,
                                          rc.data, rc.validity)
        return make_column(self.data_type(), data, validity)

    def eval_host(self, batch: HostBatch) -> HostColumnLike:
        lc = as_host_column(self.left.eval_host(batch), batch)
        rc = as_host_column(self.right.eval_host(batch), batch)
        data, validity = self.do_host(lc.data, lc.validity,
                                      rc.data, rc.validity)
        return make_host_column(self.data_type(), data, validity)


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


def eval_exprs_host(exprs: Sequence[Expression], batch: HostBatch,
                    names: Optional[Sequence[str]] = None) -> HostBatch:
    """Project on the host: evaluate expressions into a new host batch."""
    cols = [as_host_column(e.eval_host(batch), batch) for e in exprs]
    if names is None:
        names = tuple(f"c{i}" for i in range(len(cols)))
    return HostBatch(tuple(names), cols)


# ---------------------------------------------------------------------------
# Host roundtrips inside a device plan
# ---------------------------------------------------------------------------

# The metrics (``ops.base.Metrics``) of the operator step that is running,
# or None: host roundtrips count their rows and bytes there.
island_sink: contextvars.ContextVar = contextvars.ContextVar(
    "island_sink", default=None)


def host_column_bytes(hc: HostColumn) -> int:
    """The bytes a host column hands to an upload: its values (a string
    column's byte matrix and lengths) and its validity."""
    if hc.dtype.is_string:
        m, lens = strings_to_matrix(hc)
        return int(m.nbytes + lens.nbytes + hc.num_rows)
    return int(np.asarray(hc.data).nbytes + hc.num_rows)


def host_roundtrip(kind: str, col: DeviceColumn, batch: DeviceBatch,
                   fn) -> DeviceColumn:
    """``fn(host column) -> host column`` over the first ``num_rows`` rows
    of ``col`` (the reference's island: the selection vector is not
    applied, as in the reference), uploaded back at the batch's capacity
    and device."""
    moved: dict = {}
    hcol = download_batches([DeviceBatch((col,), batch.num_rows)],
                            moved=moved)[0].columns[0]
    out = fn(hcol)
    dev = host_to_device(HostBatch(("c",), [out]), capacity=batch.capacity,
                         device=batch.device, mode="plain")
    sink = island_sink.get()
    if sink is not None:
        sink.add(f"island.{kind}.rows", moved.get("rows", 0))
        sink.add(f"island.{kind}.bytesDown", moved.get("bytes", 0))
        sink.add(f"island.{kind}.bytesUp", host_column_bytes(out))
    return dev.columns[0]
