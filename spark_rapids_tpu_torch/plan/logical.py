"""Logical plans and the untyped column DSL (port of the JAX package's
``plan/logical.py``, cut to the DSL and nodes the 22 TPC-H queries,
TPCxBB q5 and q12, ``repart`` and the TPC-DS-like q67, q3, q42, q55, q89
and q98 use, plus the numeric, date-time and row-source surface: the
math, date-time and nondeterministic functions, ``least`` / ``greatest``,
``agg_first`` / ``agg_last``, ``LogicalRange`` and ``LogicalUnion``).

The DataFrame API (api/dataframe.py) builds this logical plan with
unresolved, name-based expressions. ``resolve`` binds names to ordinals
and picks the port's typed expression classes (exprs/*), the analog of
Catalyst analysis feeding GpuOverrides.

``resolve`` maps the kinds the port has an expression for; any other kind
raises ``NotPortedError`` (a ``ResolutionError``) naming it. Window
expressions (``Column.over`` a ``Window`` spec) never resolve: the
DataFrame layer extracts them into ``LogicalWindow`` nodes, as the
reference does. A cast to or from a string raises ``NotPortedError`` too.
The reference's other DSL functions and nodes (the string functions,
generate, file scans, pandas) come with the slices that port their
operators.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

from spark_rapids_tpu_torch import exprs as E
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exprs.base import BoundReference, Expression

Schema = Tuple[Tuple[str, DataType], ...]


# ---------------------------------------------------------------------------
# Untyped column AST (the DataFrame DSL)
# ---------------------------------------------------------------------------

class Column:
    """Unresolved expression node; operators build the AST lazily."""

    def __init__(self, node: Tuple):
        self.node = node

    # -- operators -----------------------------------------------------------
    def _bin(self, op: str, other) -> "Column":
        return Column((op, self, _as_col(other)))

    def __add__(self, o):
        return self._bin("add", o)

    def __radd__(self, o):
        return _as_col(o)._bin("add", self)

    def __sub__(self, o):
        return self._bin("sub", o)

    def __rsub__(self, o):
        return _as_col(o)._bin("sub", self)

    def __mul__(self, o):
        return self._bin("mul", o)

    def __rmul__(self, o):
        return _as_col(o)._bin("mul", self)

    def __truediv__(self, o):
        return self._bin("div", o)

    def __mod__(self, o):
        return self._bin("mod", o)

    def __neg__(self):
        return Column(("neg", self))

    def __eq__(self, o):  # type: ignore[override]
        return self._bin("eq", o)

    def __ne__(self, o):  # type: ignore[override]
        return Column(("not", self._bin("eq", o)))

    def __lt__(self, o):
        return self._bin("lt", o)

    def __le__(self, o):
        return self._bin("le", o)

    def __gt__(self, o):
        return self._bin("gt", o)

    def __ge__(self, o):
        return self._bin("ge", o)

    def __and__(self, o):
        return self._bin("and", o)

    def __or__(self, o):
        return self._bin("or", o)

    def __invert__(self):
        return Column(("not", self))

    def __hash__(self):
        return id(self)

    # -- named helpers --------------------------------------------------------
    def alias(self, name: str) -> "Column":
        return Column(("alias", self, name))

    def cast(self, to: Union[str, DataType]) -> "Column":
        t = dt.type_named(to) if isinstance(to, str) else to
        return Column(("cast", self, t))

    def isNull(self) -> "Column":
        return Column(("isnull", self))

    def isNotNull(self) -> "Column":
        return Column(("isnotnull", self))

    def isin(self, *values) -> "Column":
        vals = values[0] if len(values) == 1 and \
            isinstance(values[0], (list, tuple)) else values
        return Column(("isin", self, tuple(vals)))

    def startswith(self, s: str) -> "Column":
        return Column(("startswith", self, s))

    def endswith(self, s: str) -> "Column":
        return Column(("endswith", self, s))

    def contains(self, s: str) -> "Column":
        return Column(("contains", self, s))

    def like(self, pattern: str) -> "Column":
        return Column(("like", self, pattern))

    def substr(self, pos, length) -> "Column":
        return Column(("substr", self, _as_col(pos), _as_col(length)))

    def asc(self) -> "Column":
        return Column(("sortorder", self, True, True))

    def desc(self) -> "Column":
        return Column(("sortorder", self, False, False))

    def over(self, window: "WindowDef") -> "Column":
        """Evaluate this aggregate or window function over a window
        (pyspark ``Column.over``)."""
        assert isinstance(window, WindowDef), "over() takes a Window spec"
        return Column(("window", self, window))

    @property
    def name_hint(self) -> str:
        n = self.node
        if n[0] == "ref":
            return n[1]
        if n[0] == "alias":
            return n[2]
        return n[0]


def col(name: str) -> Column:
    return Column(("ref", name))


def lit_col(value) -> Column:
    return Column(("lit", value))


def canonical_node(c):
    """Hashable structural key for a Column AST (every non-child
    constructor argument kept), for deciding whether two unresolved
    expressions are the same expression."""
    if isinstance(c, Column):
        return ("col",) + tuple(canonical_node(p) for p in c.node)
    if isinstance(c, tuple):
        return tuple(canonical_node(p) for p in c)
    if isinstance(c, (list, dict, set)):
        return repr(c)
    return c


def _as_col(v) -> Column:
    if isinstance(v, Column):
        return v
    return lit_col(v)


def coalesce_cols(*cs) -> Column:
    return Column(("coalesce", tuple(_as_col(c) for c in cs)))


def when(cond: Column, value) -> "WhenBuilder":
    return WhenBuilder([(cond, _as_col(value))])


class WhenBuilder(Column):
    def __init__(self, branches):
        self.branches = branches
        super().__init__(("when", tuple(branches), None))

    def when(self, cond: Column, value) -> "WhenBuilder":
        return WhenBuilder(self.branches + [(cond, _as_col(value))])

    def otherwise(self, value) -> Column:
        return Column(("when", tuple(self.branches), _as_col(value)))


def murmur3_hash(*cs):
    return Column(("hash", tuple(_as_col(c) for c in cs)))


def pmod(c, d) -> Column:
    return Column(("pmod", _as_col(c), _as_col(d)))


def year(c):
    return Column(("year", _as_col(c)))


def month(c):
    return Column(("month", _as_col(c)))


def dayofmonth(c):
    return Column(("dayofmonth", _as_col(c)))


def sqrt_col(c):
    return Column(("sqrt", _as_col(c)))


def abs_col(c):
    return Column(("abs", _as_col(c)))


def round_col(c, scale=0):
    return Column(("round", _as_col(c), scale))


def bround_col(c, scale: int = 0) -> Column:
    return Column(("bround", _as_col(c), scale))


def floor_col(c) -> Column:
    return Column(("floor", _as_col(c)))


def ceil_col(c) -> Column:
    return Column(("ceil", _as_col(c)))


def exp_col(c) -> Column:
    return Column(("exp", _as_col(c)))


def log_col(c) -> Column:
    return Column(("log", _as_col(c)))


def log10_col(c) -> Column:
    return Column(("log10", _as_col(c)))


def log2_col(c) -> Column:
    return Column(("log2", _as_col(c)))


def logb(base, c) -> Column:
    """log(base, x), Spark's two-argument log; the base is a column or a
    literal."""
    return Column(("logb", _as_col(base), _as_col(c)))


def at_least_n_non_nulls(n: int, *cs) -> Column:
    """True where at least n of the columns are non-null (NaN counts as
    null for floats): the df.na.drop(thresh=n) predicate."""
    return Column(("at_least_n_non_nulls", int(n),
                   tuple(_as_col(c) for c in cs)))


def pow_col(c, p) -> Column:
    return Column(("pow", _as_col(c), _as_col(p)))


def signum_col(c) -> Column:
    return Column(("signum", _as_col(c)))


def isnan_col(c) -> Column:
    return Column(("isnan", _as_col(c)))


def nanvl(c, fallback) -> Column:
    return Column(("nanvl", _as_col(c), _as_col(fallback)))


def least(*cs) -> Column:
    return Column(("least", tuple(_as_col(c) for c in cs)))


def greatest(*cs) -> Column:
    return Column(("greatest", tuple(_as_col(c) for c in cs)))


def _unary_fn(kind):
    def f(c):
        return Column((kind, _as_col(c)))
    f.__name__ = kind
    return f


sin_col = _unary_fn("sin")
cos_col = _unary_fn("cos")
tan_col = _unary_fn("tan")
asin_col = _unary_fn("asin")
acos_col = _unary_fn("acos")
atan_col = _unary_fn("atan")
sinh_col = _unary_fn("sinh")
cosh_col = _unary_fn("cosh")
tanh_col = _unary_fn("tanh")
asinh_col = _unary_fn("asinh")
acosh_col = _unary_fn("acosh")
atanh_col = _unary_fn("atanh")
cbrt_col = _unary_fn("cbrt")
expm1_col = _unary_fn("expm1")
log1p_col = _unary_fn("log1p")
degrees_col = _unary_fn("degrees")
radians_col = _unary_fn("radians")
rint_col = _unary_fn("rint")

quarter = _unary_fn("quarter")
dayofweek = _unary_fn("dayofweek")
weekday = _unary_fn("weekday")
dayofyear = _unary_fn("dayofyear")
last_day = _unary_fn("last_day")
hour = _unary_fn("hour")
minute = _unary_fn("minute")
second = _unary_fn("second")
to_unix_timestamp = _unary_fn("to_unix_timestamp")
from_unixtime = _unary_fn("from_unixtime")


def date_add(c, n) -> Column:
    return Column(("date_add", _as_col(c), _as_col(n)))


def date_sub(c, n) -> Column:
    return Column(("date_sub", _as_col(c), _as_col(n)))


def datediff(end, start) -> Column:
    return Column(("datediff", _as_col(end), _as_col(start)))


def add_months(c, n) -> Column:
    return Column(("add_months", _as_col(c), _as_col(n)))


def trunc(c, fmt: str) -> Column:
    return Column(("trunc", _as_col(c), fmt))


def rand(seed: int = 0) -> Column:
    """Uniform [0, 1) per row (nondeterministic; seeded per partition)."""
    return Column(("rand", int(seed)))


def spark_partition_id() -> Column:
    return Column(("spark_partition_id",))


def monotonically_increasing_id() -> Column:
    return Column(("monotonically_increasing_id",))


def input_file_name() -> Column:
    return Column(("input_file_name",))


# Aggregate builders.
def agg_sum(c) -> Column:
    return Column(("agg", "sum", _as_col(c)))


def agg_count(c=None) -> Column:
    return Column(("agg", "count", None if c is None else _as_col(c)))


def agg_min(c) -> Column:
    return Column(("agg", "min", _as_col(c)))


def agg_max(c) -> Column:
    return Column(("agg", "max", _as_col(c)))


def agg_avg(c) -> Column:
    return Column(("agg", "avg", _as_col(c)))


def agg_count_distinct(c) -> Column:
    """count(DISTINCT c): the planner lowers it through the partial /
    merge / mixed_final pipeline (dedup by (keys, c), then count)."""
    return Column(("aggd", "count", _as_col(c)))


def agg_sum_distinct(c) -> Column:
    return Column(("aggd", "sum", _as_col(c)))


def agg_avg_distinct(c) -> Column:
    return Column(("aggd", "avg", _as_col(c)))


def agg_first(c, ignore_nulls=True) -> Column:
    return Column(("agg", "first", _as_col(c), ignore_nulls))


def agg_last(c, ignore_nulls=True) -> Column:
    return Column(("agg", "last", _as_col(c), ignore_nulls))


# ---------------------------------------------------------------------------
# Window DSL (the pyspark Window analog)
# ---------------------------------------------------------------------------

class WindowDef:
    """A window specification: partitioning, ordering, and an optional
    ROWS frame. Built via the ``Window`` builder, consumed by
    ``Column.over``."""

    def __init__(self, partition_cols=(), order_cols=(), frame=None):
        self.partition_cols = tuple(partition_cols)
        self.order_cols = tuple(order_cols)
        self.frame = frame          # None | ("rows", start, end)

    def partition_by(self, *cols) -> "WindowDef":
        return WindowDef(tuple(_name_or_col(c) for c in cols),
                         self.order_cols, self.frame)

    partitionBy = partition_by

    def order_by(self, *cols) -> "WindowDef":
        return WindowDef(self.partition_cols,
                         tuple(_name_or_col(c) for c in cols), self.frame)

    orderBy = order_by

    def rows_between(self, start, end) -> "WindowDef":
        """ROWS frame: ``start``/``end`` are row offsets relative to the
        current row (negative = preceding); ``Window.unboundedPreceding``
        / ``unboundedFollowing`` for unbounded ends."""
        return WindowDef(self.partition_cols, self.order_cols,
                         ("rows", start, end))

    rowsBetween = rows_between


def _name_or_col(c) -> Column:
    """Strings name COLUMNS here (pyspark Window semantics), unlike the
    value-literal convention of expression operands."""
    return col(c) if isinstance(c, str) else c


class _WindowBuilder:
    """Entry point mirroring ``pyspark.sql.Window``."""

    unboundedPreceding = None
    unboundedFollowing = None
    currentRow = 0

    @staticmethod
    def partition_by(*cols) -> WindowDef:
        return WindowDef().partition_by(*cols)

    partitionBy = partition_by

    @staticmethod
    def order_by(*cols) -> WindowDef:
        return WindowDef().order_by(*cols)

    orderBy = order_by


Window = _WindowBuilder


def row_number() -> Column:
    return Column(("winfn", "row_number", None, 0))


def rank() -> Column:
    return Column(("winfn", "rank", None, 0))


def dense_rank() -> Column:
    return Column(("winfn", "dense_rank", None, 0))


def lead(c, offset: int = 1) -> Column:
    return Column(("winfn", "lead", _as_col(c), offset))


def lag(c, offset: int = 1) -> Column:
    return Column(("winfn", "lag", _as_col(c), offset))


def is_window_column(c: Column) -> bool:
    """True when ``c`` is a window expression (possibly aliased)."""
    node = c.node
    while node[0] == "alias":
        node = node[1].node
    return node[0] == "window"


# ---------------------------------------------------------------------------
# Expression resolution (name -> ordinal, untyped -> typed)
# ---------------------------------------------------------------------------

class ResolutionError(ValueError):
    pass


class NotPortedError(ResolutionError):
    """A kind the reference resolves and the port has no expression for
    yet. The planner's tagging turns it into an "is not ported" reason."""


_BINARY = {
    "add": E.Add, "sub": E.Subtract, "mul": E.Multiply, "div": E.Divide,
    "mod": E.Remainder, "eq": E.EqualTo, "lt": E.LessThan,
    "le": E.LessThanOrEqual, "gt": E.GreaterThan,
    "ge": E.GreaterThanOrEqual, "and": E.And, "or": E.Or,
}
_UNARY = {"not": E.Not, "isnull": E.IsNull, "isnotnull": E.IsNotNull}
_NEEDLE = {"startswith": E.StartsWith, "endswith": E.EndsWith,
           "contains": E.Contains}
_DATE_PART = {"year": E.Year, "month": E.Month, "dayofmonth": E.DayOfMonth}
# One-column functions, as the reference's ``_UNARY_TABLE``.
_UNARY_FNS = {
    "neg": E.UnaryMinus, "abs": E.Abs, "sqrt": E.Sqrt, "isnan": E.IsNan,
    "floor": E.Floor, "ceil": E.Ceil, "exp": E.Exp, "log": E.Log,
    "log10": E.Log10, "log2": E.Log2, "log1p": E.Log1p,
    "expm1": E.Expm1, "cbrt": E.Cbrt, "sin": E.Sin, "cos": E.Cos,
    "tan": E.Tan, "asin": E.Asin, "acos": E.Acos, "atan": E.Atan,
    "sinh": E.Sinh, "cosh": E.Cosh, "tanh": E.Tanh,
    "asinh": E.Asinh, "acosh": E.Acosh, "atanh": E.Atanh,
    "degrees": E.ToDegrees, "radians": E.ToRadians, "rint": E.Rint,
    "signum": E.Signum,
    "quarter": E.Quarter, "dayofweek": E.DayOfWeek,
    "weekday": E.WeekDay, "dayofyear": E.DayOfYear,
    "last_day": E.LastDay, "hour": E.Hour, "minute": E.Minute,
    "second": E.Second, "to_unix_timestamp": E.ToUnixTimestamp,
    "from_unixtime": E.FromUnixTime,
}
# Two-column functions (no literal coercion, as in the reference).
_BINARY_FNS = {
    "nanvl": E.NaNvl, "pow": E.Pow, "logb": E.Logarithm,
    "date_add": E.DateAdd, "date_sub": E.DateSub, "datediff": E.DateDiff,
    "add_months": E.AddMonths,
}
# Task-context functions of no argument but the seed.
_CONTEXT_FNS = {"spark_partition_id": E.SparkPartitionID,
                "monotonically_increasing_id": E.MonotonicallyIncreasingID,
                "input_file_name": E.InputFileName}
# Every kind ``resolve`` maps onto a port expression.
PORTED_KINDS = frozenset({"ref", "lit", "alias", "isin", "when", "coalesce",
                          "like", "cast", "substr", "hash", "pmod", "round",
                          "bround", "least", "greatest",
                          "at_least_n_non_nulls", "trunc", "rand"}
                         | set(_BINARY) | set(_UNARY) | set(_NEEDLE)
                         | set(_DATE_PART) | set(_UNARY_FNS)
                         | set(_BINARY_FNS) | set(_CONTEXT_FNS))
# The window kinds: ported, but never resolved as expressions (the
# DataFrame layer extracts them into ``LogicalWindow`` nodes).
WINDOW_KINDS = frozenset({"window", "winfn"})


def resolve(c: Column, schema: Schema) -> Expression:
    """Bind an untyped Column AST against a schema."""
    node = c.node
    kind = node[0]
    names = [n for n, _ in schema]

    def rec(x):
        return resolve(x, schema)

    if kind == "ref":
        name = node[1]
        if name not in names:
            raise ResolutionError(
                f"column {name!r} not in {names}")
        i = names.index(name)
        return BoundReference(i, schema[i][1], name)
    if kind == "lit":
        v = node[1]
        if v is None:
            raise ResolutionError("untyped NULL literal; use typed lit")
        return E.lit(v)
    if kind == "alias":
        return rec(node[1])
    if kind == "cast":
        child = rec(node[1])
        src, to = child.data_type(), node[2]
        if src != to and (src.is_string or to.is_string):
            side = "to" if to.is_string else "from"
            raise NotPortedError(f"cast {side} string is not ported")
        return E.Cast(child, to)
    if kind in _UNARY:
        return _UNARY[kind](rec(node[1]))
    if kind in _BINARY:
        l, r = rec(node[1]), rec(node[2])
        l, r = _coerce_pair(l, r)
        return _BINARY[kind](l, r)
    if kind in _NEEDLE:
        return _NEEDLE[kind](rec(node[1]), E.lit(node[2]))
    if kind == "isin":
        return E.InSet(rec(node[1]), node[2])
    if kind == "like":
        return E.Like(rec(node[1]), node[2])
    if kind == "substr":
        return E.Substring(rec(node[1]), rec(node[2]), rec(node[3]))
    if kind == "hash":
        return E.Murmur3Hash([rec(x) for x in node[1]])
    if kind == "pmod":
        return E.Pmod(rec(node[1]), rec(node[2]))
    if kind == "coalesce":
        return E.Coalesce(*[rec(x) for x in node[1]])
    if kind == "when":
        branches = [(rec(cond), rec(val)) for cond, val in node[1]]
        else_e = rec(node[2]) if node[2] is not None else None
        return E.CaseWhen(branches, else_e)
    if kind in _DATE_PART:
        return _DATE_PART[kind](rec(node[1]))
    if kind in _UNARY_FNS:
        return _UNARY_FNS[kind](rec(node[1]))
    if kind in _BINARY_FNS:
        return _BINARY_FNS[kind](rec(node[1]), rec(node[2]))
    if kind == "round":
        return E.Round(rec(node[1]), node[2])
    if kind == "bround":
        return E.BRound(rec(node[1]), node[2])
    if kind == "least":
        return E.Least(*[rec(x) for x in node[1]])
    if kind == "greatest":
        return E.Greatest(*[rec(x) for x in node[1]])
    if kind == "at_least_n_non_nulls":
        return E.AtLeastNNonNulls(node[1], *[rec(x) for x in node[2]])
    if kind == "trunc":
        return E.TruncDate(rec(node[1]), node[2])
    if kind == "rand":
        return E.Rand(node[1])
    if kind in _CONTEXT_FNS:
        return _CONTEXT_FNS[kind]()
    if kind == "sortorder":
        raise ResolutionError("sort order only valid in orderBy")
    if kind in WINDOW_KINDS:
        raise ResolutionError("window functions are only valid in "
                              "select/with_column")
    raise NotPortedError(f"expression {kind} is not ported")


def _coerce_pair(l: Expression, r: Expression):
    """Numeric literal widening so col(int32) == lit(5) type-checks."""
    lt, rt = l.data_type(), r.data_type()
    if lt == rt:
        return l, r
    if lt.is_numeric and rt.is_numeric:
        return l, r   # binary templates widen internally
    if lt.is_datetime and rt.is_integral:
        return l, r
    if rt.is_datetime and lt.is_integral:
        return l, r
    if lt.is_string != rt.is_string:
        # Spark casts literals; keep strict here: casts must be explicit.
        raise ResolutionError(f"type mismatch: {lt} vs {rt}")
    return l, r


# ---------------------------------------------------------------------------
# Logical plan nodes
# ---------------------------------------------------------------------------

class LogicalPlan:
    children: Tuple["LogicalPlan", ...] = ()

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__


def _cached_schema(fn):
    """Memoize a node's schema keyed on the IDENTITY of its children
    tuple. Plan rewrites (pruning) never mutate a node in place: they
    build new nodes with a NEW children tuple, so tuple identity is a
    sound validity token, and holding the tuple in the memo keeps it
    alive (no id-reuse hazard)."""
    def get(self):
        memo = self.__dict__.get("_schema_memo")
        if memo is not None and memo[0] is self.children:
            return memo[1]
        s = fn(self)
        self.__dict__["_schema_memo"] = (self.children, s)
        return s
    return property(get)


@dataclasses.dataclass
class InMemoryScan(LogicalPlan):
    source_schema: Schema
    partitions: list            # List[List[HostBatch]]
    children = ()

    @property
    def schema(self) -> Schema:
        return self.source_schema


@dataclasses.dataclass
class LogicalRange(LogicalPlan):
    """range(start, end, step) in ``num_partitions`` row ranges: one
    INT64 column ``id``."""

    start: int
    end: int
    step: int
    num_partitions: int
    children = ()

    @property
    def schema(self) -> Schema:
        return (("id", dt.INT64),)


class _Unary(LogicalPlan):
    def __init__(self, child: LogicalPlan):
        self.children = (child,)

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]


class LogicalFilter(_Unary):
    def __init__(self, child, condition: Column):
        super().__init__(child)
        self.condition = condition

    @_cached_schema
    def schema(self) -> Schema:
        return self.child.schema


class LogicalProject(_Unary):
    def __init__(self, child, projections: Sequence[Tuple[str, Column]]):
        super().__init__(child)
        self.projections = list(projections)

    @_cached_schema
    def schema(self) -> Schema:
        out = []
        for name, c in self.projections:
            e = resolve(c, self.child.schema)
            out.append((name, e.data_type()))
        return tuple(out)


class LogicalAggregate(_Unary):
    def __init__(self, child, group_by: Sequence[Tuple[str, Column]],
                 aggregates: Sequence[Tuple[str, Column]],
                 grouping: Optional[str] = None):
        super().__init__(child)
        self.group_by = list(group_by)
        self.aggregates = list(aggregates)
        # None = plain GROUP BY; "rollup"/"cube" lower through ExpandExec
        # (GROUPING SETS).
        assert grouping in (None, "rollup", "cube")
        self.grouping = grouping

    @_cached_schema
    def schema(self) -> Schema:
        from spark_rapids_tpu_torch.plan.planner import resolve_agg
        out = []
        for name, c in self.group_by:
            out.append((name, resolve(c, self.child.schema).data_type()))
        for name, c in self.aggregates:
            fn = resolve_agg(c, self.child.schema)
            out.append((name, fn.result_type))
        return tuple(out)


class LogicalWindow(_Unary):
    """Appends window-expression columns sharing ONE window spec: the
    DataFrame layer extracts window columns out of select/with_column into
    a chain of these nodes; the planner merges adjacent nodes with the
    same spec and puts the co-locating exchange underneath."""

    def __init__(self, child, exprs, window: WindowDef):
        super().__init__(child)
        self.exprs = list(exprs)        # [(out_name, fn_col Column)]
        self.window = window

    def spec_key(self):
        """Hashable structural identity of the window spec, for merging
        adjacent nodes that partition and sort identically."""
        return (tuple(canonical_node(c) for c in self.window.partition_cols),
                tuple(canonical_node(c) for c in self.window.order_cols),
                self.window.frame)

    def result_type(self, fn_col: Column) -> DataType:
        node = fn_col.node
        if node[0] == "winfn":
            kind = node[1]
            if kind in ("row_number", "rank", "dense_rank"):
                return dt.INT32
            return resolve(node[2], self.child.schema).data_type()
        if node[0] == "agg":
            kind = node[1]
            if kind == "count":
                return dt.INT64
            if kind == "avg":
                return dt.FLOAT64
            t = resolve(node[2], self.child.schema).data_type()
            if kind == "sum":
                return dt.FLOAT64 if t.is_floating else dt.INT64
            return t
        raise ResolutionError(
            f"unsupported window function {node[0]!r}")

    @_cached_schema
    def schema(self) -> Schema:
        return tuple(self.child.schema) + tuple(
            (n, self.result_type(c)) for n, c in self.exprs)


class LogicalSort(_Unary):
    def __init__(self, child, orders: Sequence[Column]):
        super().__init__(child)
        self.orders = list(orders)

    @_cached_schema
    def schema(self) -> Schema:
        return self.child.schema


class LogicalLimit(_Unary):
    def __init__(self, child, n: int):
        super().__init__(child)
        self.n = n

    @_cached_schema
    def schema(self) -> Schema:
        return self.child.schema


class LogicalRepartition(_Unary):
    def __init__(self, child, num_partitions: int,
                 keys: Optional[Sequence[Column]] = None):
        super().__init__(child)
        self.num_partitions = num_partitions
        self.keys = list(keys) if keys else None

    @_cached_schema
    def schema(self) -> Schema:
        return self.child.schema


class LogicalJoin(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_keys: Sequence[Column], right_keys: Sequence[Column],
                 join_type: str = "inner",
                 condition: Optional[Column] = None,
                 strategy: str = "auto"):
        self.children = (left, right)
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.join_type = join_type
        self.condition = condition
        self.strategy = strategy    # auto | broadcast | shuffle

    @_cached_schema
    def schema(self) -> Schema:
        if self.join_type in ("semi", "anti"):
            return self.children[0].schema
        return tuple(self.children[0].schema) + \
            tuple(self.children[1].schema)


class LogicalUnion(LogicalPlan):
    """UNION ALL of children whose schemas line up by position; the first
    child's names are the result's."""

    def __init__(self, *children: LogicalPlan):
        self.children = tuple(children)

    @_cached_schema
    def schema(self) -> Schema:
        return self.children[0].schema
