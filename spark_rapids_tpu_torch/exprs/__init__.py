"""Expressions of the port (see each module for its JAX counterpart)."""

from spark_rapids_tpu_torch.exprs.arithmetic import (
    Add, Divide, Multiply, Pmod, Remainder, Subtract)
from spark_rapids_tpu_torch.exprs.base import (
    BoundReference, Expression, Literal, Scalar, lit)
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.conditional import (
    CaseWhen, Coalesce, If, Nvl)
from spark_rapids_tpu_torch.exprs.datetime import (
    DayOfMonth, Month, Quarter, Year)
from spark_rapids_tpu_torch.exprs.hash import Murmur3Hash
from spark_rapids_tpu_torch.exprs.predicates import (
    And, EqualNullSafe, EqualTo, GreaterThan, GreaterThanOrEqual, InSet,
    IsNotNull, IsNull, LessThan, LessThanOrEqual, Not, Or)
from spark_rapids_tpu_torch.exprs.strings import (
    Contains, EndsWith, Like, StartsWith, Substring)

__all__ = [
    "Add", "And", "BoundReference", "CaseWhen", "Cast", "Coalesce",
    "Contains", "DayOfMonth", "Divide", "EndsWith", "EqualNullSafe",
    "EqualTo", "Expression", "GreaterThan", "GreaterThanOrEqual", "If",
    "InSet", "IsNotNull", "IsNull", "LessThan", "LessThanOrEqual",
    "Like", "Literal", "Month", "Multiply", "Murmur3Hash", "Not", "Nvl",
    "Or", "Pmod", "Quarter", "Remainder", "Scalar", "StartsWith",
    "Substring", "Subtract", "Year", "lit",
]
