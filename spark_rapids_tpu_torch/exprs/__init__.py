"""Expressions of the port (see each module for its JAX counterpart)."""

from spark_rapids_tpu_torch.exprs.arithmetic import (
    Abs, Add, BitwiseAnd, BitwiseNot, BitwiseOr, BitwiseXor, Divide,
    Greatest, IntegralDivide, Least, Multiply, Pmod, Remainder, ShiftLeft,
    ShiftRight, ShiftRightUnsigned, Subtract, UnaryMinus, UnaryPositive)
from spark_rapids_tpu_torch.exprs.base import (
    BoundReference, Expression, Literal, Scalar, lit)
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.conditional import (
    CaseWhen, Coalesce, If, KnownFloatingPointNormalized, NaNvl,
    NormalizeNaNAndZero, Nvl)
from spark_rapids_tpu_torch.exprs.datetime import (
    AddMonths, DateAdd, DateDiff, DateSub, DayOfMonth, DayOfWeek, DayOfYear,
    FromUnixTime, Hour, LastDay, Minute, Month, Quarter, Second, TimeAdd,
    TimeSub, ToUnixTimestamp, TruncDate, UnixTimestamp, WeekDay, Year)
from spark_rapids_tpu_torch.exprs.hash import Murmur3Hash
from spark_rapids_tpu_torch.exprs.math import (
    Acos, Acosh, Asin, Asinh, Atan, Atan2, Atanh, BRound, Cbrt, Ceil, Cos,
    Cosh, Exp, Expm1, Floor, Log, Log10, Log1p, Log2, Logarithm, Pow, Rint,
    Round, Signum, Sin, Sinh, Sqrt, Tan, Tanh, ToDegrees, ToRadians)
from spark_rapids_tpu_torch.exprs.nondeterministic import (
    EvalContext, InputFileName, MonotonicallyIncreasingID, Rand,
    SparkPartitionID, eval_context)
from spark_rapids_tpu_torch.exprs.predicates import (
    And, AtLeastNNonNulls, EqualNullSafe, EqualTo, GreaterThan,
    GreaterThanOrEqual, InSet, IsNan, IsNotNull, IsNull, LessThan,
    LessThanOrEqual, Not, Or)
from spark_rapids_tpu_torch.exprs.strings import (
    Contains, EndsWith, Like, StartsWith, Substring)

__all__ = [
    "Abs", "Acos", "Acosh", "Add", "AddMonths", "And", "Asin", "Asinh",
    "AtLeastNNonNulls", "Atan", "Atan2", "Atanh", "BRound", "BitwiseAnd",
    "BitwiseNot", "BitwiseOr", "BitwiseXor", "BoundReference", "CaseWhen",
    "Cast", "Cbrt", "Ceil", "Coalesce", "Contains", "Cos", "Cosh",
    "DateAdd", "DateDiff", "DateSub", "DayOfMonth", "DayOfWeek",
    "DayOfYear", "Divide", "EndsWith", "EqualNullSafe", "EqualTo",
    "EvalContext", "Exp", "Expm1", "Expression", "Floor", "FromUnixTime",
    "GreaterThan", "GreaterThanOrEqual", "Greatest", "Hour", "If", "InSet",
    "InputFileName", "IntegralDivide", "IsNan", "IsNotNull", "IsNull",
    "KnownFloatingPointNormalized", "LastDay", "Least", "LessThan",
    "LessThanOrEqual", "Like", "Literal", "Log", "Log10", "Log1p", "Log2",
    "Logarithm", "Minute", "MonotonicallyIncreasingID", "Month",
    "Multiply", "Murmur3Hash", "NaNvl", "NormalizeNaNAndZero", "Not",
    "Nvl", "Or", "Pmod", "Pow", "Quarter", "Rand", "Remainder", "Rint",
    "Round", "Scalar", "Second", "ShiftLeft", "ShiftRight",
    "ShiftRightUnsigned", "Signum", "Sin", "Sinh", "SparkPartitionID",
    "Sqrt", "StartsWith", "Substring", "Subtract", "Tan", "Tanh",
    "TimeAdd", "TimeSub", "ToDegrees", "ToRadians", "ToUnixTimestamp",
    "TruncDate", "UnaryMinus", "UnaryPositive", "UnixTimestamp", "WeekDay",
    "Year", "eval_context", "lit",
]
