"""Expressions of the port (see each module for its JAX counterpart)."""

from spark_rapids_tpu_torch.exprs.arithmetic import (
    Add, Divide, Multiply, Subtract)
from spark_rapids_tpu_torch.exprs.base import (
    BoundReference, Expression, Literal, Scalar, lit)
from spark_rapids_tpu_torch.exprs.conditional import (
    CaseWhen, Coalesce, If, Nvl)
from spark_rapids_tpu_torch.exprs.datetime import (
    DayOfMonth, Month, Quarter, Year)
from spark_rapids_tpu_torch.exprs.predicates import (
    And, EqualNullSafe, EqualTo, GreaterThan, GreaterThanOrEqual, InSet,
    IsNotNull, IsNull, LessThan, LessThanOrEqual, Not, Or)
from spark_rapids_tpu_torch.exprs.strings import (
    Contains, EndsWith, Like, StartsWith)

__all__ = [
    "Add", "And", "BoundReference", "CaseWhen", "Coalesce", "Contains",
    "DayOfMonth", "Divide", "EndsWith", "EqualNullSafe",
    "EqualTo", "Expression", "GreaterThan", "GreaterThanOrEqual", "If",
    "InSet", "IsNotNull", "IsNull", "LessThan", "LessThanOrEqual",
    "Like", "Literal", "Month", "Multiply", "Not", "Nvl", "Or", "Quarter", "Scalar",
    "StartsWith", "Subtract", "Year", "lit",
]
