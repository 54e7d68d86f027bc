"""Arithmetic expressions (port of the JAX package's
``exprs/arithmetic.py``: ``Add``, ``Subtract``, ``Multiply``, ``Divide``).

Spark semantics: operands widen to the common numeric type; integer
overflow wraps (ANSI off); a null operand gives a null result. ``Divide``
is always FLOAT64 (Spark casts both operands to double) and a divisor of
0.0 or -0.0 gives NULL, not an infinity; NaN propagates. The device half
runs torch, the host half numpy (whose arrays wrap on overflow too).

Subnormals in ``Divide``: the JAX package's device engine (XLA:CPU) reads
a subnormal operand as a zero of its sign and flushes a subnormal
quotient, so there a subnormal divisor gives NULL; its host engine
(numpy) does neither. Each half here follows its engine.
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
