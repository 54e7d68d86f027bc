"""Arithmetic expressions (port of the JAX package's
``exprs/arithmetic.py``: ``Add``, ``Subtract``, ``Multiply``, ``Divide``,
``Remainder`` and ``Pmod``).

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
on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import flush_subnormal, torch_dtype
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exprs.base import BinaryExpression


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
