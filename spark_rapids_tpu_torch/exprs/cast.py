"""Cast between fixed-width types (port of the JAX package's
``exprs/cast.py``: ``Cast`` and ``_cast_fixed``).

Spark's cast matrix over the fixed-width types, ANSI off:

- numeric widening and narrowing wrap like the JVM; int <-> float
  convert; any type -> bool is ``x != 0``; bool -> numeric is 0 or 1;
- float -> integral truncates toward zero, NaN gives 0, and the value
  saturates at Int's range (Long's for a long target), then narrows by
  wrapping for byte and short (Scala's ``x.toInt.toByte``);
- timestamp -> date floors to days, date -> timestamp is midnight UTC;
  timestamp -> integral is whole seconds (floored), -> float the exact
  seconds; numeric -> timestamp is seconds (NaN and infinities give
  NULL), numeric -> date keeps the day number.

Casts to and from strings (the reference's host-side parse and format)
are not ported: ``resolve`` and the planner refuse them.

The device half runs torch, the host half numpy. The JAX package's
device engine (XLA:CPU) reads a subnormal float operand as a zero of its
sign; the device half here flushes float inputs the same way, the host
half (numpy, as the reference's host engine) does not.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import flush_subnormal, torch_dtype
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exprs.base import (
    Expression, UnaryExpression, as_device_column, as_host_column,
    make_column, make_host_column)

_LONG_MIN = -(2 ** 63)
_LONG_MAX = 2 ** 63 - 1
MICROS_PER_DAY = 86400 * 1000 * 1000


class Cast(UnaryExpression):
    """``cast(child as to)`` between fixed-width types (``plan/logical.py``
    ``resolve`` refuses a string on either side)."""

    def __init__(self, child: Expression, to: DataType):
        super().__init__(child)
        self.to = to

    def data_type(self) -> DataType:
        return self.to

    def eval(self, batch):
        col = as_device_column(self.child.eval(batch), batch)
        src = self.child.data_type()
        if src == self.to:
            return col
        data = col.data
        if src.is_floating:
            data = flush_subnormal(data)
        data, validity = _cast_fixed(_TORCH, data, col.validity, src,
                                     self.to)
        return make_column(self.to, data, validity)

    def eval_host(self, batch):
        col = as_host_column(self.child.eval_host(batch), batch)
        src = self.child.data_type()
        if src == self.to:
            return col
        with np.errstate(all="ignore"):
            data, validity = _cast_fixed(_NUMPY, np.asarray(col.data),
                                         np.asarray(col.validity, np.bool_),
                                         src, self.to)
        return make_host_column(self.to, data, validity)


class _Ops:
    """The few array operations ``_cast_fixed`` needs, for torch (the
    device half) or numpy (the host half)."""

    def __init__(self, lib):
        self.lib = lib

    def astype(self, x, t: DataType):
        if self.lib is torch:
            return x.to(torch_dtype(t))
        return x.astype(t.np_dtype)

    def f64(self, x):
        return x.to(torch.float64) if self.lib is torch \
            else x.astype(np.float64)

    def i64(self, x):
        return x.to(torch.int64) if self.lib is torch \
            else x.astype(np.int64)

    def float_to_int(self, x, t: DataType):
        """Float -> integer conversion as each engine of the reference
        converts: XLA's on the device (NaN gives 0, out-of-range values
        saturate), numpy's on the host."""
        if self.lib is not torch:
            return x.astype(t.np_dtype)
        info = torch.iinfo(torch_dtype(t))
        x = x.to(torch.float64)
        out = torch.clamp(x, min=float(info.min)).nan_to_num(0.0) \
            .to(torch_dtype(t))
        return torch.where(x >= float(info.max),
                           torch.full_like(out, info.max), out)

    def true_div(self, x, d: float):
        """``x / d`` rounded once: torch's CUDA division by a python
        scalar multiplies by its reciprocal, so the divisor goes as a 0-d
        tensor."""
        if self.lib is torch:
            return x / torch.full((), d, dtype=x.dtype, device=x.device)
        return x / d

    def full_like(self, x, value):
        if self.lib is torch:
            return torch.full_like(x, value)
        return np.full_like(x, value)

    def where(self, c, a, b):
        return self.lib.where(c, a, b)

    def floor_divide(self, a, b: int):
        return self.lib.floor_divide(a, b)

    def isnan(self, x):
        return self.lib.isnan(x)

    def isfinite(self, x):
        return self.lib.isfinite(x)

    def trunc(self, x):
        return self.lib.trunc(x)


_TORCH = _Ops(torch)
_NUMPY = _Ops(np)


def _cast_fixed(ops: _Ops, data, validity, src: DataType, to: DataType):
    """Fixed-width -> fixed-width cast on raw arrays."""
    if to.is_boolean:
        return data != 0, validity
    if src.is_boolean:
        return ops.astype(data, to), validity
    if src.name == "timestamp" and to.name == "date":
        return ops.astype(ops.floor_divide(data, MICROS_PER_DAY), to), \
            validity
    if src.name == "date" and to.name == "timestamp":
        return ops.i64(data) * MICROS_PER_DAY, validity
    if src.is_datetime and to.is_numeric:
        if src.name == "timestamp":
            # timestamp->long = seconds; ->int/short/byte narrows from that.
            if to.is_floating:
                return ops.astype(ops.true_div(ops.f64(data), 1e6), to), \
                    validity
            return ops.astype(ops.floor_divide(data, 1000 * 1000), to), \
                validity
        return ops.astype(data, to), validity
    if src.is_numeric and to.name == "timestamp":
        if src.is_floating:
            x = ops.f64(data)
            finite = ops.isfinite(x)
            safe = ops.where(finite, x, ops.full_like(x, 0.0))
            # Spark returns NULL for NaN/Infinity -> timestamp.
            return ops.float_to_int(safe * 1e6, to), validity & finite
        return ops.i64(data) * 1000 * 1000, validity
    if src.is_numeric and to.name == "date":
        if src.is_floating:
            return ops.float_to_int(data, to), validity
        return ops.astype(data, to), validity
    if src.is_floating and to.is_integral:
        # JVM d2i/d2l: truncate toward zero, NaN -> 0, saturate at the
        # intermediate type's range, then wrap-narrow.
        x = ops.f64(data)
        x = ops.where(ops.isnan(x), ops.full_like(x, 0.0), x)
        if to.name == "int64":
            lo, hi = float(_LONG_MIN), float(_LONG_MAX)
            lo_i, hi_i = _LONG_MIN, _LONG_MAX
        else:
            lo_i, hi_i = -(2 ** 31), 2 ** 31 - 1
            lo, hi = float(lo_i), float(hi_i)
        too_big = x >= hi
        too_small = x <= lo
        safe = ops.where(too_big | too_small, ops.full_like(x, 0.0), x)
        longs = ops.i64(ops.trunc(safe))
        longs = ops.where(too_big, ops.full_like(longs, hi_i), longs)
        longs = ops.where(too_small, ops.full_like(longs, lo_i), longs)
        return ops.astype(longs, to), validity
    # numeric widening/narrowing (wrap-around like the JVM) & int<->float.
    return ops.astype(data, to), validity
