"""Plan rewrite: wrap -> tag -> convert (port of the JAX package's
``plan/planner.py``; ref: GpuOverrides.scala:1991, RapidsMeta.scala:189).

- Every logical node and expression is wrapped in a ``NodeMeta`` carrying
  fallback ``reasons`` (RapidsMeta.willNotWorkOnGpu analog). The
  per-node kill switches (``spark.rapids.sql.exec.<Node>`` /
  ``spark.rapids.sql.expression.<kind>``), ``spark.rapids.sql.enabled``,
  the order-dependent float aggregation gate and the incompat-expression
  gates give the reference's reasons: they place the node on the host
  engine, as the reference does.
- The port's own reasons (``NodeMeta.port_reasons``, also listed among
  the reasons) name what it cannot run on either engine: a kind or node
  it has no class for ("... is not ported"), a cast to or from a string,
  a window function it has no class for, join keys that are not column
  references. ``Planner.plan`` refuses such a plan with
  ``NotImplementedError`` listing every such node.
- Conversion emits the port's execs, each on its node's engine, with
  ``DeviceToHostExec`` / ``HostToDeviceExec`` bridging a child on the
  other engine where the reference bridges (``_bridge``). Every exchange
  the reference plans is a ``ShuffleExchangeExec`` above the bridge, on
  its parent's engine: ``SinglePartitioning`` under a limit, a zero-key
  aggregate and an unpartitioned window; ``HashPartitioning`` between
  partial and final aggregates, under a partitioned window and under each
  side of a shuffled join; ``RangePartitioning`` under a sort; hash or
  round robin for ``repartition``. Each plans
  ``spark.rapids.sql.shuffle.partitions`` partitions when the conf sets
  it and one otherwise (the reference's rule on one device); aggregate,
  window and sort exchanges on the device may coalesce their partitions
  once materialized (AQE-lite). A keyed join whose strategy comes out
  ``shuffle`` is a ``ShuffledHashJoinExec`` over two hash exchanges, a
  ``broadcast`` one a ``BroadcastHashJoinExec``, and a join without keys
  a ``BroadcastNestedLoopJoinExec``.
- ``range`` is a ``RangeExec`` source (batches of ``batchSizeRows``
  built on the card), ``union`` a ``UnionExec`` over its children, each
  bridged to the union's engine.
- Task-context expressions (``rand``, ``spark_partition_id``,
  ``monotonically_increasing_id``, ``input_file_name``) are an analysis
  error anywhere but in a projection or a filter, whose operators thread
  the partition and row base (``_forbid_contextual``).
- ROLLUP and CUBE lower to ``ExpandExec`` under the two-stage aggregate
  keyed by the grouping id; DISTINCT aggregates lower to the partial /
  merge / mixed_final pipeline (``_convert_distinct_aggregate``);
  adjacent windows of one spec merge before conversion
  (``merge_windows``).
- The host engine runs only the nodes tagged for the reference's
  reasons: a failing device operator raises, and is never rerun there
  (an exhausted OOM ladder tries the grace join on the device first,
  ``Exec.execute_device_recovering``).
- ``PhysicalPlan.explain`` renders the will/will-not-run report
  (RapidsMeta.explain:291); ``collect`` runs the root on its engine (the
  reference's scheduler, QoS, transient retry, re-plan and fault layers
  are not ported).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Tuple

from spark_rapids_tpu_torch import DeviceLike, config as C, resolve_device
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.exprs.base import BoundReference, Literal
from spark_rapids_tpu_torch.ops import (
    AggSpec, Average, BroadcastHashJoinExec, BroadcastNestedLoopJoinExec,
    Count, CountStar, DeviceToHostExec, Exec, ExecContext, ExpandExec,
    FilterExec, First, GlobalLimitExec, HashAggregateExec, HostToDeviceExec,
    InMemorySourceExec, Last, LocalLimitExec, Max, Min, ProjectExec,
    RangeExec, ShuffledHashJoinExec, SortExec, SortOrder, Sum, UnionExec,
    WindowExec)
from spark_rapids_tpu_torch.ops import window as W
from spark_rapids_tpu_torch.ops.join import JOIN_TYPES
from spark_rapids_tpu_torch.parallel.exchange import ShuffleExchangeExec
from spark_rapids_tpu_torch.parallel.partitioning import (
    HashPartitioning, RangePartitioning, RoundRobinPartitioning,
    SinglePartitioning)
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.logical import (
    Column, LogicalPlan, NotPortedError, ResolutionError, resolve)
from spark_rapids_tpu_torch.plan.pruning import (
    estimate_bytes, prune_columns, pushdown_filters, refs_of)


# ---------------------------------------------------------------------------
# Expression tagging rules (GpuOverrides expr registry analog)
# ---------------------------------------------------------------------------

# Kinds whose device implementation can differ from the JVM in corner
# cases, and transcendentals whose rounding can differ from
# java.lang.Math: the reference's gates, kept so an AST holding one is
# tagged with the reference's reasons (none of these kinds is ported).
_INCOMPAT_EXPRS = {
    "upper": "locale-sensitive case mapping is ASCII-only on TPU",
    "lower": "locale-sensitive case mapping is ASCII-only on TPU",
    "initcap": "locale-sensitive case mapping is ASCII-only on TPU",
}
_IMPROVED_FLOAT_EXPRS = {
    "exp", "expm1", "log", "log10", "log2", "log1p", "sin", "cos", "tan",
    "asin", "acos", "atan", "sinh", "cosh", "tanh", "cbrt", "pow", "atan2",
}
# The aggregate kinds ``resolve_agg`` maps onto the port's functions
# (count of no column is CountStar).
_AGGS = {"count": Count, "sum": Sum, "min": Min, "max": Max,
         "avg": Average, "first": First, "last": Last}
# The aggregates a window frame computes (ops/window.py).
_WINDOW_AGGS = {"count", "sum", "min", "max", "avg"}
# Kinds whose value depends on the task context; only Project and Filter
# thread an EvalContext, so anywhere else they would evaluate with
# partition 0 and row base 0 (Spark's CheckAnalysis draws the same line
# for nondeterministic expressions).
_CONTEXTUAL_KINDS = {"rand", "spark_partition_id",
                     "monotonically_increasing_id", "input_file_name"}
# The window functions ``_convert_window`` maps onto ops/window.py.
_WINDOW_FNS = {"row_number", "rank", "dense_rank", "lead", "lag"}


def _expr_conf_key(kind: str) -> str:
    return f"spark.rapids.sql.expression.{kind}"


def _exec_conf_key(name: str) -> str:
    return f"spark.rapids.sql.exec.{name}"


def tag_column(c: Column, conf: C.TpuConf, reasons: List[str],
               port_reasons: List[str], schema=None):
    """Walk an untyped Column AST, collecting fallback reasons (the port's
    own also into ``port_reasons``). ``schema`` (when known) types a
    cast's input: a cast to or from a string is not ported (the
    reference's float/string cast gates serve those casts only). The
    reference's host-roundtrip notes serve kinds the port has not ported;
    their "not ported" reason refuses them here."""
    kind = c.node[0]
    if kind == "cast":
        src = None
        if schema is not None:
            try:
                src = resolve(c.node[1], schema).data_type()
            except Exception:
                pass
        if c.node[2].is_string and src != c.node[2]:
            _port_reason(reasons, port_reasons,
                         "cast to string is not ported")
        elif src is not None and src.is_string and src != c.node[2]:
            _port_reason(reasons, port_reasons,
                         "cast from string is not ported")
    if not conf.is_op_enabled(_expr_conf_key(kind)):
        reasons.append(f"expression {kind} disabled by "
                       f"{_expr_conf_key(kind)}")
    if kind in _INCOMPAT_EXPRS and not conf.incompatible_ops:
        reasons.append(
            f"expression {kind} is incompatible ({_INCOMPAT_EXPRS[kind]}); "
            "enable spark.rapids.sql.incompatibleOps.enabled to allow")
    if kind in _IMPROVED_FLOAT_EXPRS and not conf.incompatible_ops and \
            not conf.get(C.IMPROVED_FLOAT_OPS):
        reasons.append(
            f"expression {kind} can round differently from java.lang.Math "
            "on TPU; enable spark.rapids.sql.improvedFloatOps.enabled")
    if kind not in L.PORTED_KINDS and kind not in L.WINDOW_KINDS and \
            kind != "sortorder":
        _port_reason(reasons, port_reasons,
                     f"expression {kind} is not ported")
    for x in c.node[1:]:
        if isinstance(x, Column):
            tag_column(x, conf, reasons, port_reasons, schema)
        elif isinstance(x, tuple):
            for y in x:
                if isinstance(y, Column):
                    tag_column(y, conf, reasons, port_reasons, schema)
                elif isinstance(y, tuple):
                    for z in y:
                        if isinstance(z, Column):
                            tag_column(z, conf, reasons, port_reasons,
                                       schema)


def _column_kinds(c: Column, out: set) -> set:
    out.add(c.node[0])
    for x in c.node[1:]:
        if isinstance(x, Column):
            _column_kinds(x, out)
        elif isinstance(x, tuple):
            for y in x:
                if isinstance(y, Column):
                    _column_kinds(y, out)
                elif isinstance(y, tuple):
                    for z in y:
                        if isinstance(z, Column):
                            _column_kinds(z, out)
    return out


def _forbid_contextual(c: Column, where: str):
    """Analysis-time guard: task-context expressions are valid only where
    the evaluating operator threads an EvalContext (select / filter)."""
    bad = _column_kinds(c, set()) & _CONTEXTUAL_KINDS
    if bad:
        raise ResolutionError(
            f"nondeterministic/task-context expression(s) {sorted(bad)} are "
            f"only supported in select/filter/with_column, not in {where} "
            "(evaluate them into a column first)")


def _port_reason(reasons: List[str], port_reasons: List[str], why: str):
    """A reason of the port's own: it tags the node as the reference's
    reasons do and also refuses the plan."""
    reasons.append(why)
    port_reasons.append(why)


def _float_agg_reasons(agg_col: Column, schema, conf: C.TpuConf,
                       reasons: List[str]):
    """Order-dependent float aggregation gate (GpuOverrides checks on
    variableFloatAgg, RapidsConf.scala:149 analog in config.py)."""
    kind = agg_col.node[1]
    child = agg_col.node[2]
    if kind in ("sum", "avg") and child is not None:
        try:
            t = resolve(child, schema).data_type()
        except Exception:
            return
        if t.is_floating and not conf.get(C.VARIABLE_FLOAT_AGG):
            reasons.append(
                f"{kind} over {t.name} can vary with evaluation order on "
                "TPU; enable spark.rapids.sql.variableFloatAgg.enabled")


def _schema_or_none(plan: LogicalPlan):
    """A node's schema, or None when it holds a kind the port cannot
    resolve (that node carries the "not ported" reason itself)."""
    try:
        return plan.schema
    except NotPortedError:
        return None


# ---------------------------------------------------------------------------
# Node meta (RapidsMeta analog)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NodeMeta:
    """A tagged logical node. ``reasons`` are all of its fallback
    reasons, the reference's and the port's own; ``port_reasons`` are
    the port's own, which refuse the plan."""

    plan: LogicalPlan
    children: List["NodeMeta"]
    reasons: List[str] = dataclasses.field(default_factory=list)
    notes: List[str] = dataclasses.field(default_factory=list)
    port_reasons: List[str] = dataclasses.field(default_factory=list)

    @property
    def on_device(self) -> bool:
        return not self.reasons

    def explain_lines(self, depth: int = 0, not_on_device_only=False):
        mark = "*" if self.on_device else "!"
        line = "  " * depth + f"{mark}Exec <{self.plan.name}>"
        if self.reasons:
            line += " cannot run on TPU because " + "; ".join(self.reasons)
        elif self.notes:
            line += " (" + "; ".join(self.notes) + ")"
        out = [] if (not_on_device_only and self.on_device and
                     not self.notes) else [line]
        for ch in self.children:
            out.extend(ch.explain_lines(depth + 1, not_on_device_only))
        return out


_NODES = (L.InMemoryScan, L.LogicalRange, L.LogicalFilter,
          L.LogicalProject, L.LogicalAggregate, L.LogicalSort,
          L.LogicalLimit, L.LogicalJoin, L.LogicalWindow,
          L.LogicalRepartition, L.LogicalUnion)


def wrap_and_tag(plan: LogicalPlan, conf: C.TpuConf) -> NodeMeta:
    meta = NodeMeta(plan, [wrap_and_tag(c, conf) for c in plan.children])
    reasons, ours = meta.reasons, meta.port_reasons
    if not conf.sql_enabled:
        reasons.append("spark.rapids.sql.enabled is false")
    if not conf.is_op_enabled(_exec_conf_key(plan.name)):
        reasons.append(f"disabled by {_exec_conf_key(plan.name)}")
    if not isinstance(plan, _NODES):
        _port_reason(reasons, ours, f"{plan.name} is not ported")

    child_schema = _schema_or_none(plan.children[0]) \
        if plan.children else None
    if isinstance(plan, L.LogicalFilter):
        tag_column(plan.condition, conf, reasons, ours, child_schema)
    elif isinstance(plan, L.LogicalProject):
        for _, c in plan.projections:
            tag_column(c, conf, reasons, ours, child_schema)
    elif isinstance(plan, L.LogicalAggregate):
        for _, c in plan.group_by:
            _forbid_contextual(c, "group_by")
            tag_column(c, conf, reasons, ours, child_schema)
        for _, c in plan.aggregates:
            _forbid_contextual(c, "aggregates")
            ac = _unalias(c)
            if ac.node[0] not in ("agg", "aggd"):
                continue
            if ac.node[2] is not None:
                tag_column(ac.node[2], conf, reasons, ours, child_schema)
            _float_agg_reasons(ac, child_schema, conf, reasons)
            if ac.node[0] == "aggd" and ac.node[1] in ("first", "last"):
                # The reference's conversion error, before any refusal.
                raise ResolutionError(
                    f"{ac.node[1]}(DISTINCT) is not meaningful")
            if ac.node[1] not in _AGGS:
                _port_reason(reasons, ours,
                             f"aggregate {ac.node[1]} is not ported")
    elif isinstance(plan, L.LogicalSort):
        for o in plan.orders:
            inner = o.node[1] if o.node[0] == "sortorder" else o
            _forbid_contextual(inner, "order_by")
            tag_column(inner, conf, reasons, ours, child_schema)
    elif isinstance(plan, L.LogicalJoin):
        if plan.strategy == "shuffle" and plan.left_keys and \
                not conf.get(C.REPLACE_SORT_MERGE_JOIN):
            reasons.append(
                "co-partitioned (sort-merge-shaped) join replacement "
                "disabled by spark.rapids.sql.replaceSortMergeJoin.enabled")
        ls = child_schema
        rs = _schema_or_none(plan.children[1])
        for k in plan.left_keys:
            _forbid_contextual(k, "join keys")
            tag_column(k, conf, reasons, ours, ls)
        for k in plan.right_keys:
            _forbid_contextual(k, "join keys")
            tag_column(k, conf, reasons, ours, rs)
        if plan.condition is not None:
            _forbid_contextual(plan.condition, "join condition")
            tag_column(plan.condition, conf, reasons, ours,
                       None if ls is None or rs is None
                       else tuple(ls) + tuple(rs))
        if plan.join_type not in JOIN_TYPES:
            _port_reason(reasons, ours,
                         f"join type {plan.join_type} is not ported")
        if any(_unalias(k).node[0] != "ref"
               for k in plan.left_keys + plan.right_keys):
            _port_reason(reasons, ours, "join keys that are not column "
                         "references are not ported")
    elif isinstance(plan, L.LogicalRepartition):
        for k in (plan.keys or []):
            _forbid_contextual(k, "repartition keys")
            tag_column(k, conf, reasons, ours, child_schema)
    elif isinstance(plan, L.LogicalWindow):
        for c in plan.window.partition_cols:
            _forbid_contextual(c, "window partition keys")
            tag_column(c, conf, reasons, ours, child_schema)
        for o in plan.window.order_cols:
            inner = o.node[1] if o.node[0] == "sortorder" else o
            _forbid_contextual(inner, "window order keys")
            tag_column(inner, conf, reasons, ours, child_schema)
        for _, fn_col in plan.exprs:
            node = fn_col.node
            if len(node) > 2 and isinstance(node[2], Column):
                tag_column(node[2], conf, reasons, ours, child_schema)
            known = _WINDOW_FNS if node[0] == "winfn" else \
                _WINDOW_AGGS if node[0] == "agg" else set()
            if node[1] not in known:
                _port_reason(reasons, ours, f"window function {node[0]} "
                             f"{node[1]} is not ported")
    return meta


def merge_windows(plan: LogicalPlan) -> LogicalPlan:
    """Collapse chains of LogicalWindow nodes with the SAME window spec
    into one multi-expression node: each node plans an exchange and a
    partition sort, so N window columns over one spec would otherwise
    sort N times (Spark's ExtractWindowExpressions groups the same way
    before planning one Window operator)."""
    kids = [merge_windows(c) for c in plan.children]
    if not all(a is b for a, b in zip(kids, plan.children)):
        plan = copy.copy(plan)
        plan.children = tuple(kids)
    if isinstance(plan, L.LogicalWindow) and \
            isinstance(plan.child, L.LogicalWindow) and \
            plan.spec_key() == plan.child.spec_key():
        inner = plan.child
        # Only merge when the outer expressions don't read the inner
        # node's outputs (a window fn over another window's result must
        # stay a separate pass).
        refs: set = set()
        for _, fn_col in plan.exprs:
            refs_of(fn_col, refs)
        if not refs & {n for n, _ in inner.exprs}:
            return merge_windows(L.LogicalWindow(
                inner.child, list(inner.exprs) + list(plan.exprs),
                inner.window))
    return plan


# ---------------------------------------------------------------------------
# Aggregate resolution
# ---------------------------------------------------------------------------

def _unalias(c: Column) -> Column:
    while c.node[0] == "alias":
        c = c.node[1]
    return c


def resolve_agg(c: Column, schema):
    """The port's aggregate function for an ``agg`` (or ``aggd``) Column.
    A DISTINCT one carries ``is_distinct`` and ``distinct_key`` (the
    structural key of its unresolved input, for the single-distinct-input
    check); min/max DISTINCT are plain min/max."""
    c = _unalias(c)
    if c.node[0] not in ("agg", "aggd"):
        raise ResolutionError(f"not an aggregate: {c.node[0]}")
    distinct = c.node[0] == "aggd"
    kind = c.node[1]
    child_col = c.node[2]
    child = None if child_col is None else resolve(child_col, schema)
    if distinct and kind in ("first", "last"):
        raise ResolutionError(f"{kind}(DISTINCT) is not meaningful")
    if kind == "count" and child is None:
        fn = CountStar(None)
    elif kind in ("first", "last"):
        fn = _AGGS[kind](child, c.node[3] if len(c.node) > 3 else True)
    elif kind in _AGGS:
        fn = _AGGS[kind](child)
    else:
        raise NotPortedError(f"aggregate {kind} is not ported")
    fn.is_distinct = distinct and kind not in ("min", "max")
    if fn.is_distinct:
        fn.distinct_key = L.canonical_node(child_col)
    return fn


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PhysicalPlan:
    """Planner output: the root exec, which engine the root runs on, the
    tagged meta tree for explain and test mode, and the conf the query
    was planned with (runtime-read configs see the same values)."""

    root: Exec
    root_on_device: bool
    meta: NodeMeta
    conf: C.TpuConf = dataclasses.field(default_factory=C.TpuConf)

    def explain(self, mode: str = "ALL") -> str:
        return "\n".join(self.meta.explain_lines(
            not_on_device_only=(mode.upper() == "NOT_ON_GPU")))

    def collect(self, ctx: Optional[ExecContext] = None) -> List[tuple]:
        """Run the root's partitions on the root's engine and return the
        rows (downloaded once, when the root is on the device)."""
        return self.root.collect(ctx or ExecContext(self.conf),
                                 device=self.root_on_device)

    def collect_batches(self, ctx: Optional[ExecContext] = None) -> list:
        """``collect`` as host batches (numpy columns)."""
        return self.root.collect_batches(ctx or ExecContext(self.conf),
                                         device=self.root_on_device)

    def host_fallback_nodes(self) -> List[str]:
        """The logical nodes tagged for the host engine, in tree order."""
        return [m.plan.name for m in _walk(self.meta) if not m.on_device]

    def tree(self) -> str:
        """The exec tree, one operator a line, with its join type,
        aggregate mode or source columns."""
        return "\n".join(_exec_lines(self.root, 0))


def _exec_lines(e: Exec, depth: int) -> List[str]:
    detail = ""
    if isinstance(e, (ShuffledHashJoinExec, BroadcastNestedLoopJoinExec)):
        detail = f" {e.join_type}"
    elif isinstance(e, ShuffleExchangeExec):
        part = e.partitioning
        detail = f" {type(part).__name__}({part.num_partitions})"
    elif isinstance(e, HashAggregateExec):
        detail = f" {e.mode} by {list(e.group_names)}"
    elif isinstance(e, InMemorySourceExec):
        detail = f" [{', '.join(n for n, _ in e.schema)}]"
    elif isinstance(e, (LocalLimitExec, GlobalLimitExec)):
        detail = f" {e.limit}"
    out = ["  " * depth + type(e).__name__ + detail]
    for c in e.children:
        out.extend(_exec_lines(c, depth + 1))
    return out


def _refusal(refused: List[NodeMeta]) -> str:
    lines = ["the port cannot plan this query; refused nodes:"]
    for m in refused:
        lines.append(f"  {m.plan.name}: " + "; ".join(m.reasons))
    return "\n".join(lines)


class Planner:
    """Converts a tagged logical plan into the port's exec tree, each node
    on its engine, with every source uploading to ``device`` (``None`` =
    the CUDA card)."""

    def __init__(self, conf: Optional[C.TpuConf] = None,
                 device: DeviceLike = None):
        self.conf = conf or C.TpuConf()
        self.device = resolve_device(device)

    # -- public --------------------------------------------------------------
    def plan(self, logical: LogicalPlan) -> PhysicalPlan:
        try:
            logical = pushdown_filters(prune_columns(merge_windows(logical)))
        except NotPortedError:
            # Pruning reads join sides' schemas; a plan holding a kind the
            # port cannot resolve is refused by the tagging below.
            pass
        meta = wrap_and_tag(logical, self.conf)
        if self.conf.explain in ("ALL", "NOT_ON_GPU"):
            print("\n".join(meta.explain_lines(
                not_on_device_only=self.conf.explain == "NOT_ON_GPU")))
        refused = [m for m in _walk(meta) if m.port_reasons]
        if refused:
            raise NotImplementedError(_refusal(refused))
        root, on_device = self._convert(meta)
        phys = PhysicalPlan(root, on_device, meta, self.conf)
        if self.conf.test_enabled:
            allowed = {s for s in str(self.conf.get(
                C.TEST_ALLOWED_NONTPU)).split(",") if s}
            bad = [n for n in phys.host_fallback_nodes()
                   if n not in allowed]
            if bad:
                raise AssertionError(
                    f"Query would execute on host: {bad} "
                    "(spark.rapids.sql.test.enabled)")
        return phys

    # -- helpers -------------------------------------------------------------
    def _bridge(self, child: Exec, child_dev: bool, want_dev: bool) -> Exec:
        """``child`` as its parent's engine reads it: a transition where
        the two engines differ."""
        if child_dev == want_dev:
            return child
        return HostToDeviceExec(child, self.device) if want_dev \
            else DeviceToHostExec(child)

    def _shuffle_partitions(self) -> int:
        """One partition on one device unless the conf sets the count (the
        reference's single-device rule; its mesh is not ported)."""
        if self.conf.raw.get(C.SHUFFLE_PARTITIONS.key) is None:
            return 1
        return int(self.conf.get(C.SHUFFLE_PARTITIONS))

    def _hash_exchange(self, child: Exec, keys, n: int,
                       allow_coalesce: bool = False) -> Exec:
        """A hash shuffle; ``allow_coalesce`` opts into AQE-lite partition
        merging, safe for aggregate and window exchanges, never for
        co-partitioned join inputs."""
        return ShuffleExchangeExec(child, HashPartitioning(keys, n),
                                   allow_coalesce=allow_coalesce)

    def _join_strategy(self, plan: L.LogicalJoin):
        """(strategy, build estimate, threshold); the estimate and
        threshold are None unless the strategy was ``auto``."""
        strategy = plan.strategy
        if strategy != "auto":
            return strategy, None, None
        if plan.join_type == "full":
            return "shuffle", None, None
        threshold = int(self.conf.get(C.AUTO_BROADCAST_THRESHOLD))
        build_plan = plan.children[1] \
            if plan.join_type != "right" else plan.children[0]
        est = estimate_bytes(build_plan)
        # Spark semantics: -1 disables auto-broadcast.
        strategy = "broadcast" if threshold >= 0 and est is not None \
            and est <= threshold else "shuffle"
        return strategy, est, threshold

    def _convert(self, meta: NodeMeta) -> Tuple[Exec, bool]:
        """(exec, runs on the device) for one tagged node; each child is
        bridged to this node's engine where the reference bridges."""
        plan = meta.plan
        want_dev = meta.on_device
        kids = [self._convert(c) for c in meta.children]
        if isinstance(plan, L.InMemoryScan):
            return InMemorySourceExec(plan.schema, plan.partitions,
                                      device=self.device), want_dev
        if isinstance(plan, L.LogicalRange):
            return RangeExec(plan.start, plan.end, plan.step,
                             plan.num_partitions,
                             batch_rows=int(self.conf.get(
                                 C.BATCH_SIZE_ROWS)),
                             device=self.device), want_dev
        if isinstance(plan, L.LogicalJoin):
            return self._convert_join(plan, meta, kids, want_dev), want_dev
        if isinstance(plan, L.LogicalUnion):
            return UnionExec(*[self._bridge(ch, cdev, want_dev)
                               for ch, cdev in kids]), want_dev
        child = self._bridge(*kids[0], want_dev)
        if isinstance(plan, L.LogicalFilter):
            return FilterExec(child, resolve(plan.condition,
                                             plan.child.schema)), want_dev
        if isinstance(plan, L.LogicalProject):
            return ProjectExec(child, [
                (n, resolve(c, plan.child.schema))
                for n, c in plan.projections]), want_dev
        if isinstance(plan, L.LogicalLimit):
            local = LocalLimitExec(child, plan.n)
            single = ShuffleExchangeExec(local, SinglePartitioning())
            return GlobalLimitExec(single, plan.n), want_dev
        if isinstance(plan, L.LogicalRepartition):
            if plan.keys:
                part = HashPartitioning(
                    [resolve(k, plan.child.schema) for k in plan.keys],
                    plan.num_partitions)
            else:
                part = RoundRobinPartitioning(plan.num_partitions)
            return ShuffleExchangeExec(child, part), want_dev
        if isinstance(plan, L.LogicalSort):
            # Global order: range-exchange into sorted partition ranges
            # first (Spark's requiredChildDistribution for a global sort).
            orders = _orders(plan.orders, plan.child.schema)
            ex = ShuffleExchangeExec(
                child, RangePartitioning(orders, self._shuffle_partitions()),
                allow_coalesce=want_dev)
            return SortExec(ex, orders), want_dev
        if isinstance(plan, L.LogicalAggregate):
            return self._convert_aggregate(plan, child, want_dev), want_dev
        if isinstance(plan, L.LogicalWindow):
            return self._convert_window(plan, child, want_dev), want_dev
        raise NotImplementedError(f"cannot convert {plan.name}")

    def _convert_window(self, plan: L.LogicalWindow, child: Exec,
                        want_dev: bool) -> Exec:
        """``WindowExec`` over its required distribution (GpuWindowExec:
        a hash exchange on the PARTITION BY keys, or a single partition
        for none); ordering happens inside the window's frame sort."""
        schema = plan.child.schema
        win = plan.window
        pcols = [resolve(c, schema) for c in win.partition_cols]
        orders = _orders(win.order_cols, schema)
        spec = W.WindowSpec(pcols, orders)
        wx_specs = []
        for out_name, fn_col in plan.exprs:
            node = fn_col.node
            if node[0] == "winfn":
                kind, child_col, offset = node[1], node[2], node[3]
                if kind in ("rank", "dense_rank", "row_number") \
                        and not orders:
                    raise ResolutionError(f"{kind}() requires ORDER BY")
                if kind == "row_number":
                    fn = W.RowNumber()
                elif kind == "rank":
                    fn = W.Rank()
                elif kind == "dense_rank":
                    fn = W.DenseRank()
                elif kind == "lead":
                    fn = W.Lead(resolve(child_col, schema), offset)
                else:
                    fn = W.Lag(resolve(child_col, schema), offset)
            else:   # ("agg", kind, child)
                kind, child_col = node[1], node[2]
                agg_child = None if child_col is None \
                    else resolve(child_col, schema)
                if win.frame is not None:
                    _, start, end = win.frame
                    if (start is not None and start > 0) or \
                            (end is not None and end < 0):
                        raise ResolutionError(
                            "rows_between bounds must straddle the "
                            "current row")
                    frame = W.WindowFrame(
                        None if start is None else -start, end)
                elif orders:
                    # Spark's default: RANGE UNBOUNDED..CURRENT ROW.
                    frame = W.WindowFrame(None, 0, running_with_peers=True)
                else:
                    frame = W.WindowFrame(None, None)   # whole partition
                fn = W.WindowAgg(kind, agg_child, frame)
            wx_specs.append(W.WindowExprSpec(out_name, fn, spec))
        if pcols:
            ex = self._hash_exchange(child, pcols,
                                     self._shuffle_partitions(),
                                     allow_coalesce=want_dev)
        else:
            ex = ShuffleExchangeExec(child, SinglePartitioning())
        return WindowExec(ex, wx_specs)

    def _exchange_on_keys(self, child: Exec, group_by,
                          want_dev: bool) -> Exec:
        """The exchange between two aggregate stages: hash on the group
        keys (the leading columns of the stage below), or a single
        partition for a zero-key aggregate."""
        if not group_by:
            return ShuffleExchangeExec(child, SinglePartitioning())
        keys = [BoundReference(i, e.data_type())
                for i, (_, e) in enumerate(group_by)]
        return self._hash_exchange(child, keys, self._shuffle_partitions(),
                                   allow_coalesce=want_dev)

    def _convert_aggregate(self, plan: L.LogicalAggregate, child: Exec,
                           want_dev: bool) -> Exec:
        schema = plan.child.schema
        group_by = [(n, resolve(c, schema)) for n, c in plan.group_by]
        aggs = [AggSpec(n, fn, distinct=fn.is_distinct)
                for n, fn in ((n, resolve_agg(c, schema))
                              for n, c in plan.aggregates)]
        if plan.grouping is not None:
            if any(s.distinct for s in aggs):
                raise ResolutionError(
                    "DISTINCT aggregates under rollup/cube are unsupported")
            return self._convert_grouping_sets(plan.grouping, group_by,
                                               aggs, child, want_dev)
        if any(s.distinct for s in aggs):
            return self._convert_distinct_aggregate(group_by, aggs, child,
                                                    want_dev)
        return self._two_stage(group_by, aggs, child, want_dev)

    def _convert_grouping_sets(self, kind: str, group_by, aggs,
                               child: Exec, want_dev: bool) -> Exec:
        """ROLLUP/CUBE via ExpandExec (Spark lowers grouping sets to
        Expand + Aggregate keyed by (keys..., grouping id)): each input
        row is emitted once per grouping set, with aggregated-out keys
        NULLed and a grouping-id literal so a data NULL never merges with
        a subtotal NULL. A final projection drops the grouping id."""
        nk = len(group_by)
        if kind == "rollup":
            # Set i keeps the first nk-i keys; gid bit per dropped key.
            masks = [(1 << i) - 1 for i in range(nk + 1)]
        else:
            masks = list(range(1 << nk))
        agg_children = [s.fn.child for s in aggs]
        names = [n for n, _ in group_by] + \
            [f"__agg_in{i}" for i in range(len(agg_children))] + \
            ["__grouping_id"]
        projections = []
        for mask in masks:
            proj = []
            for i, (_, e) in enumerate(group_by):
                dropped = mask & (1 << (nk - 1 - i)) if kind == "cube" \
                    else (i >= nk - bin(mask).count("1"))
                proj.append(Literal(e.data_type(), None) if dropped else e)
            for ce in agg_children:
                proj.append(ce if ce is not None
                            else Literal(dt.INT32, 1))
            proj.append(Literal(dt.INT64, mask))
            projections.append(proj)
        expand = ExpandExec(child, projections, names)
        # Re-key everything by ordinal over the expand output.
        ex_group = [(n, BoundReference(i, e.data_type()))
                    for i, (n, e) in enumerate(group_by)]
        ex_group.append(("__grouping_id", BoundReference(
            nk + len(agg_children), dt.INT64)))
        ex_aggs = []
        for i, s in enumerate(aggs):
            if s.fn.child is None:
                ex_aggs.append(s)
                continue
            ref = BoundReference(nk + i, s.fn.child.data_type())
            ex_aggs.append(AggSpec(s.name, type(s.fn)(ref)))
        final = self._two_stage(ex_group, ex_aggs, expand, want_dev)
        # Drop the grouping id from the output.
        out = [(n, BoundReference(i, e.data_type()))
               for i, (n, e) in enumerate(ex_group[:nk])]
        out += [(s.name, BoundReference(nk + 1 + i, s.fn.result_type))
                for i, s in enumerate(ex_aggs)]
        return ProjectExec(final, out)

    def _two_stage(self, group_by, aggs, child: Exec,
                   want_dev: bool) -> Exec:
        """partial -> exchange (hash on the keys, or a single partition
        for a zero-key aggregate) -> final."""
        partial = HashAggregateExec(child, group_by, aggs, mode="partial")
        final_groups = [
            (n, BoundReference(i, e.data_type()))
            for i, (n, e) in enumerate(group_by)]
        return HashAggregateExec(
            self._exchange_on_keys(partial, group_by, want_dev),
            final_groups, aggs, mode="final")

    def _convert_distinct_aggregate(self, group_by, aggs, child: Exec,
                                    want_dev: bool) -> Exec:
        """DISTINCT aggregates through the partial-merge mode combos
        (aggregate.scala:305 distinct handling):

          partial keyed by (keys..., x), with the partial non-distinct
          aggregates
          -> the exchange on the keys (x rides along: co-location by the
             keys suffices, as the merge completes the dedup; a zero-key
             aggregate goes to a single partition)
          -> merge keyed by (keys..., x): deduplicated, buffers merged
          -> mixed_final keyed by the keys: the distinct aggregates
             UPDATE over the now unique x, the others MERGE their buffers

        Every distinct aggregate must share one input expression (Spark's
        planner has the same single-distinct-column restriction)."""
        d_specs = [s for s in aggs if s.distinct]
        nd_specs = [s for s in aggs if not s.distinct]
        x_exprs = {s.fn.distinct_key for s in d_specs}
        if len(x_exprs) > 1:
            raise ResolutionError(
                "multiple DISTINCT aggregates must share the same input "
                f"expression; got {len(x_exprs)} different ones")
        x = d_specs[0].fn.child
        xt = x.data_type()
        nkeys = len(group_by)
        stage_a = HashAggregateExec(
            child, list(group_by) + [("__distinct_x", x)], nd_specs,
            mode="partial")
        gb_b = [(n, BoundReference(i, e.data_type()))
                for i, (n, e) in enumerate(group_by)]
        gb_b.append(("__distinct_x", BoundReference(nkeys, xt)))
        stage_b = HashAggregateExec(
            self._exchange_on_keys(stage_a, group_by, want_dev), gb_b,
            nd_specs, mode="merge")
        final_groups = gb_b[:nkeys]
        specs_c = [AggSpec(s.name, type(s.fn)(BoundReference(nkeys, xt)),
                           distinct=True) if s.distinct else s
                   for s in aggs]
        return HashAggregateExec(stage_b, final_groups, specs_c,
                                 mode="mixed_final")

    def _convert_join(self, plan: L.LogicalJoin, meta: NodeMeta, kids,
                      want_dev: bool) -> Exec:
        lch, rch = (self._bridge(k, kdev, want_dev) for k, kdev in kids)
        ls, rs = plan.children[0].schema, plan.children[1].schema
        lkeys = [resolve(k, ls) for k in plan.left_keys]
        rkeys = [resolve(k, rs) for k in plan.right_keys]
        cond = None
        if plan.condition is not None:
            cond = resolve(plan.condition, tuple(ls) + tuple(rs))
        if not lkeys:
            return BroadcastNestedLoopJoinExec(lch, rch, plan.join_type, cond)
        strategy, est, threshold = self._join_strategy(plan)
        if plan.strategy == "auto":
            meta.notes.append(
                f"auto join strategy -> {strategy} (build side "
                f"~{est if est is not None else '?'} bytes, "
                f"threshold {threshold})")
        if strategy == "broadcast":
            return BroadcastHashJoinExec(lch, rch, lkeys, rkeys,
                                         plan.join_type, cond)
        n = self._shuffle_partitions()
        return ShuffledHashJoinExec(self._hash_exchange(lch, lkeys, n),
                                    self._hash_exchange(rch, rkeys, n),
                                    lkeys, rkeys, plan.join_type, cond)


def _orders(orders, schema) -> List[SortOrder]:
    """Resolved sort orders of ``sortorder`` (or bare, ascending nulls
    first) Columns."""
    out = []
    for o in orders:
        if o.node[0] == "sortorder":
            inner, asc, nf = o.node[1], o.node[2], o.node[3]
        else:
            inner, asc, nf = o, True, True
        out.append(SortOrder(resolve(inner, schema), asc, nf))
    return out


def _walk(meta: NodeMeta):
    yield meta
    for ch in meta.children:
        yield from _walk(ch)
