"""Arithmetic expressions (port of the JAX package's
``exprs/arithmetic.py``: ``Add``, ``Subtract``, ``Multiply``).

Spark semantics: operands widen to the common numeric type; integer
overflow wraps (ANSI off); a null operand gives a null result.
"""

from __future__ import annotations

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import torch_dtype
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


class Add(_Arith):
    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        a, b = self._prep(l_data, r_data)
        return a + b, l_valid & r_valid


class Subtract(_Arith):
    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        a, b = self._prep(l_data, r_data)
        return a - b, l_valid & r_valid


class Multiply(_Arith):
    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        a, b = self._prep(l_data, r_data)
        return a * b, l_valid & r_valid
