"""Arithmetic expressions (port of the JAX package's
``exprs/arithmetic.py``: ``Add``, ``Subtract``, ``Multiply``, ``Divide``,
``IntegralDivide``, ``Remainder``, ``Pmod``, ``UnaryMinus``,
``UnaryPositive``, ``Abs``, ``Least``, ``Greatest``, the bitwise
operations and the three shifts).

Spark semantics: operands widen to the common numeric type; integer
overflow wraps (ANSI off); a null operand gives a null result. ``Divide``
is always FLOAT64 (Spark casts both operands to double) and a divisor of
0.0 or -0.0 gives NULL, not an infinity; NaN propagates. The device half
runs torch, the host half numpy (whose arrays wrap on overflow too).

Subnormals in ``Divide``: the JAX package's device engine (XLA:CPU) reads
a subnormal operand as a zero of its sign and flushes a subnormal
quotient, so there a subnormal divisor gives NULL; its host engine
(numpy) does neither. Each half here follows its engine.

``Remainder`` (Spark ``%``) truncates as Java does, so the result takes
the dividend's sign; ``Pmod`` is ``((a % b) + b) % b`` with the
reference's sign fix. Both give NULL for a zero divisor and run ``fmod``
on floats (a subnormal divisor gives NULL on the device half, as
``Divide``'s does). A divisor of -1 is computed as 1 (both give 0 for every
dividend): ``INT_MIN % -1`` overflows the hardware division, which traps
on the CPU. ``IntegralDivide`` (Spark ``div``) does the same and negates
with wrapping.

``Least`` / ``Greatest`` skip NULLs and order NaN above everything (Spark's
ordering); on the device half their comparisons read subnormals as zeros,
as the reference's engine compares them, while the values picked pass
through unflushed. ``UnaryMinus``, ``Abs`` and the bitwise operations
never flush (they are bit operations there too). The shifts mask the
count to the left operand's width as Java does; ``ShiftRightUnsigned``
is a logical shift, done in the signed type with a mask.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import flush_subnormal, torch_dtype
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exprs.base import (
    BinaryExpression, Expression, UnaryExpression, as_device_column,
    as_host_column, make_column, make_host_column)
from spark_rapids_tpu_torch.exprs.cast import _TORCH


class _Arith(BinaryExpression):
    """Common-type widening binary arithmetic."""

    def data_type(self) -> DataType:
        return dt.common_numeric_type(self.left.data_type(),
                                      self.right.data_type())

    def _prep(self, l_data, r_data):
        t = torch_dtype(self.data_type())
        return l_data.to(t), r_data.to(t)

    def _prep_host(self, l_data, r_data):
        t = self.data_type().np_dtype
        return l_data.astype(t), r_data.astype(t)


class Add(_Arith):
    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        a, b = self._prep(l_data, r_data)
        return a + b, l_valid & r_valid

    def do_host(self, l_data, l_valid, r_data, r_valid):
        a, b = self._prep_host(l_data, r_data)
        return a + b, l_valid & r_valid


class Subtract(_Arith):
    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        a, b = self._prep(l_data, r_data)
        return a - b, l_valid & r_valid

    def do_host(self, l_data, l_valid, r_data, r_valid):
        a, b = self._prep_host(l_data, r_data)
        return a - b, l_valid & r_valid


class Multiply(_Arith):
    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        a, b = self._prep(l_data, r_data)
        return a * b, l_valid & r_valid

    def do_host(self, l_data, l_valid, r_data, r_valid):
        a, b = self._prep_host(l_data, r_data)
        return a * b, l_valid & r_valid


class Divide(BinaryExpression):
    """Spark Divide: operands cast to double; x / 0.0 -> NULL."""

    def data_type(self) -> DataType:
        return dt.FLOAT64

    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        a = flush_subnormal(l_data.to(torch.float64))
        b = flush_subnormal(r_data.to(torch.float64))
        zero = b == 0.0
        safe = torch.where(zero, torch.ones((), dtype=torch.float64,
                                            device=b.device), b)
        return flush_subnormal(a / safe), l_valid & r_valid & ~zero

    def do_host(self, l_data, l_valid, r_data, r_valid):
        a = l_data.astype(np.float64)
        b = r_data.astype(np.float64)
        zero = b == 0.0
        safe = np.where(zero, np.float64(1.0), b)
        with np.errstate(all="ignore"):
            q = a / safe
        return q, l_valid & r_valid & ~zero


def _safe_divisor(b, floating: bool, xp):
    """(divisor with 0 and, for integers, -1 replaced by 1, zero mask).
    On the device half a subnormal divisor counts as zero, as the JAX
    package's device engine compares it."""
    zero = (flush_subnormal(b) if xp is torch and floating else b) == 0
    swap = zero if floating else (zero | (b == -1))
    one = (torch.ones((), dtype=b.dtype, device=b.device) if xp is torch
           else b.dtype.type(1))
    return xp.where(swap, one, b), zero


def _fmod(xp, a, b):
    return torch.fmod(a, b) if xp is torch else np.fmod(a, b)


class Remainder(_Arith):
    """Spark ``%``: the result takes the dividend's sign (Java
    semantics)."""

    def _kernel(self, xp, a, l_valid, b, r_valid):
        floating = self.data_type().is_floating
        safe, zero = _safe_divisor(b, floating, xp)
        if floating:
            r = _fmod(xp, a, safe)
        else:
            # remainder floors; convert to truncated (Java) semantics.
            r = xp.remainder(a, safe)
            fix = (r != 0) & ((r < 0) != (a < 0))
            r = xp.where(fix, r - safe, r)
        return r, l_valid & r_valid & ~zero

    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        a, b = self._prep(l_data, r_data)
        return self._kernel(torch, a, l_valid, b, r_valid)

    def do_host(self, l_data, l_valid, r_data, r_valid):
        a, b = self._prep_host(l_data, r_data)
        with np.errstate(all="ignore"):
            return self._kernel(np, a, l_valid, b, r_valid)


class Pmod(_Arith):
    """Spark ``pmod(a, b)``: ``((a % b) + b) % b``."""

    def _kernel(self, xp, a, l_valid, b, r_valid):
        floating = self.data_type().is_floating
        safe, zero = _safe_divisor(b, floating, xp)
        if floating:
            r = _fmod(xp, _fmod(xp, a, safe) + safe, safe)
        else:
            r = xp.remainder(xp.remainder(a, safe) + safe, safe)
            fix = (r != 0) & ((r < 0) != (safe < 0))
            r = xp.where(fix, r - safe, r)
        return r, l_valid & r_valid & ~zero

    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        a, b = self._prep(l_data, r_data)
        return self._kernel(torch, a, l_valid, b, r_valid)

    def do_host(self, l_data, l_valid, r_data, r_valid):
        a, b = self._prep_host(l_data, r_data)
        with np.errstate(all="ignore"):
            return self._kernel(np, a, l_valid, b, r_valid)


def _to_long(x: torch.Tensor) -> torch.Tensor:
    """A device operand as LONG: floats convert as the reference's engine
    converts them (NaN gives 0, out-of-range values saturate)."""
    if x.is_floating_point():
        return _TORCH.float_to_int(x, dt.INT64)
    return x.to(torch.int64)


def convert(x: torch.Tensor, t: torch.dtype) -> torch.Tensor:
    """``x`` as ``t``; a float32 subnormal widening to double becomes a
    zero of its sign, as the reference's engine converts it."""
    if x.dtype == torch.float32 and t == torch.float64:
        x = flush_subnormal(x)
    return x.to(t)


class IntegralDivide(BinaryExpression):
    """Spark ``div``: LONG quotient, truncated toward zero; a zero divisor
    gives NULL and ``LONG_MIN div -1`` wraps to ``LONG_MIN``."""

    def data_type(self) -> DataType:
        return dt.INT64

    def _kernel(self, xp, a, l_valid, b, r_valid):
        safe, zero = _safe_divisor(b, False, xp)
        # Floor division, then the truncation fix of the reference.
        if xp is torch:
            q = torch.div(a, safe, rounding_mode="floor")
        else:
            q = np.floor_divide(a, safe)
        rem = a - q * safe
        q = xp.where((rem != 0) & ((a < 0) != (safe < 0)), q + 1, q)
        # A -1 divisor ran as 1: negate (wrapping at LONG_MIN).
        return xp.where(b == -1, -q, q), l_valid & r_valid & ~zero

    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        return self._kernel(torch, _to_long(l_data), l_valid,
                            _to_long(r_data), r_valid)

    def do_host(self, l_data, l_valid, r_data, r_valid):
        with np.errstate(all="ignore"):
            return self._kernel(np, l_data.astype(np.int64), l_valid,
                                r_data.astype(np.int64), r_valid)


class _SameType(UnaryExpression):
    def data_type(self) -> DataType:
        return self.child.data_type()


class UnaryMinus(_SameType):
    def do_columnar(self, data, validity, col):
        return -data, validity

    def do_host(self, data, validity, col):
        with np.errstate(all="ignore"):
            return -data, validity


class UnaryPositive(_SameType):
    def do_columnar(self, data, validity, col):
        return data, validity

    def do_host(self, data, validity, col):
        return data, validity


class Abs(_SameType):
    def do_columnar(self, data, validity, col):
        return data.abs(), validity

    def do_host(self, data, validity, col):
        with np.errstate(all="ignore"):
            return np.abs(data), validity


class Least(Expression):
    """least(...): NULLs skipped, NULL only where every input is NULL;
    NaN equals NaN and is greater than everything."""

    _want_smaller = True

    def __init__(self, *children: Expression):
        self._children = tuple(children)

    @property
    def children(self):
        return self._children

    def data_type(self) -> DataType:
        t = self._children[0].data_type()
        for c in self._children[1:]:
            t = dt.common_numeric_type(t, c.data_type())
        return t

    def _lt(self, xp, a, b):
        if not self.data_type().is_floating:
            return a < b
        if xp is torch:
            a, b = flush_subnormal(a), flush_subnormal(b)
        na, nb = xp.isnan(a), xp.isnan(b)
        return (~na & nb) | ((a < b) & ~na & ~nb)

    def _fold(self, xp, cols):
        data = validity = None
        for d, v in cols:
            if data is None:
                data, validity = d, v
                continue
            better = self._lt(xp, d, data) if self._want_smaller \
                else self._lt(xp, data, d)
            # An invalid accumulator always loses to a valid operand.
            take_new = v & (~validity | better)
            data = xp.where(take_new, d, data)
            validity = validity | v
        return data, validity

    def eval(self, batch):
        t = torch_dtype(self.data_type())
        cols = [as_device_column(c.eval(batch), batch)
                for c in self._children]
        data, validity = self._fold(torch, [(convert(c.data, t), c.validity)
                                            for c in cols])
        return make_column(self.data_type(), data, validity)

    def eval_host(self, batch):
        t = self.data_type().np_dtype
        cols = [as_host_column(c.eval_host(batch), batch)
                for c in self._children]
        data, validity = self._fold(np, [(c.data.astype(t), c.validity)
                                         for c in cols])
        return make_host_column(self.data_type(), data, validity)


class Greatest(Least):
    _want_smaller = False


class _Bitwise(_Arith):
    _op = None

    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        a, b = self._prep(l_data, r_data)
        return type(self)._op(a, b), l_valid & r_valid

    def do_host(self, l_data, l_valid, r_data, r_valid):
        a, b = self._prep_host(l_data, r_data)
        return type(self)._op(a, b), l_valid & r_valid


class BitwiseAnd(_Bitwise):
    _op = staticmethod(lambda a, b: a & b)


class BitwiseOr(_Bitwise):
    _op = staticmethod(lambda a, b: a | b)


class BitwiseXor(_Bitwise):
    _op = staticmethod(lambda a, b: a ^ b)


class BitwiseNot(_SameType):
    def do_columnar(self, data, validity, col):
        return ~data, validity

    def do_host(self, data, validity, col):
        return ~data, validity


class ShiftLeft(BinaryExpression):
    """Java ``<<``: the count masked to the left operand's width."""

    def data_type(self) -> DataType:
        return self.left.data_type()

    @property
    def _bits(self) -> int:
        return self.data_type().itemsize * 8

    def _shift(self, a, k):
        return a << k

    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        k = (r_data.to(torch.int32) & (self._bits - 1)).to(l_data.dtype)
        return self._shift(l_data, k), l_valid & r_valid

    def do_host(self, l_data, l_valid, r_data, r_valid):
        k = (r_data.astype(np.int32) & (self._bits - 1)).astype(l_data.dtype)
        return self._shift(l_data, k), l_valid & r_valid


class ShiftRight(ShiftLeft):
    """Java ``>>``: arithmetic."""

    def _shift(self, a, k):
        return a >> k


class ShiftRightUnsigned(ShiftLeft):
    """Java ``>>>``: logical, ``(x >> k) & ((1 << (bits - k)) - 1)`` in the
    signed type (torch has no unsigned shifts on the card); a count of 0
    keeps every bit."""

    def _shift(self, a, k):
        one = torch.ones_like(k) if isinstance(k, torch.Tensor) \
            else np.ones_like(k)
        # (1 << (bits - k)) - 1 overflows at k == 0; ~0 there.
        mask = (one << (self._bits - k)) - one
        mask = torch.where(k == 0, ~torch.zeros_like(k), mask) \
            if isinstance(k, torch.Tensor) \
            else np.where(k == 0, ~np.zeros_like(k), mask)
        return (a >> k) & mask
