"""Expressions of the port (see each module for its JAX counterpart)."""

from spark_rapids_tpu_torch.exprs.arithmetic import Add, Multiply, Subtract
from spark_rapids_tpu_torch.exprs.base import (
    BoundReference, Expression, Literal, Scalar, lit)
from spark_rapids_tpu_torch.exprs.predicates import (
    And, EqualNullSafe, EqualTo, GreaterThan, GreaterThanOrEqual, IsNotNull,
    IsNull, LessThan, LessThanOrEqual, Not, Or)
from spark_rapids_tpu_torch.exprs.strings import (
    Contains, EndsWith, StartsWith)

__all__ = [
    "Add", "And", "BoundReference", "Contains", "EndsWith", "EqualNullSafe",
    "EqualTo", "Expression", "GreaterThan", "GreaterThanOrEqual",
    "IsNotNull", "IsNull", "LessThan", "LessThanOrEqual", "Literal",
    "Multiply", "Not", "Or", "Scalar", "StartsWith", "Subtract", "lit",
]
