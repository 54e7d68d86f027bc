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
  it has no class for ("... is not ported"), an exchange into more than
  one partition (``spark.rapids.sql.shuffle.partitions`` > 1), a full
  outer join, a join without keys, a window function it has no class
  for, join keys that are not column references. ``Planner.plan``
  refuses such a plan with ``NotImplementedError`` listing every such
  node.
- Conversion emits the port's execs at one partition, each on its node's
  engine, with ``DeviceToHostExec`` / ``HostToDeviceExec`` bridging a
  child on the other engine where the reference bridges (``_bridge``).
  Every exchange the reference plans (SinglePartitioning under a limit or
  a zero-key aggregate or an unpartitioned window, HashPartitioning
  between partial and final aggregates and under a partitioned window,
  RangePartitioning under a sort) becomes ``CoalescePartitionsExec(child,
  1)`` above the bridge, so it runs on its parent's engine. A join whose
  auto strategy comes out ``shuffle`` becomes a ``BroadcastHashJoinExec``
  over both sides coalesced to one partition: a shuffled hash join of one
  partition a side is a hash join of the two whole sides.
- ROLLUP and CUBE lower to ``ExpandExec`` under the two-stage aggregate
  keyed by the grouping id; DISTINCT aggregates lower to the partial /
  merge / mixed_final pipeline (``_convert_distinct_aggregate``);
  adjacent windows of one spec merge before conversion
  (``merge_windows``).
- The host engine runs only the nodes tagged for the reference's
  reasons: a failing device operator raises, and is never rerun there.
- ``PhysicalPlan.explain`` renders the will/will-not-run report
  (RapidsMeta.explain:291); ``collect`` runs the root on its engine (the
  reference's scheduler, QoS, retry and fault layers are not ported).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Tuple

from spark_rapids_tpu_torch import DeviceLike, config as C, resolve_device
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.exprs.base import BoundReference, Literal
from spark_rapids_tpu_torch.ops import (
    AggSpec, Average, BroadcastHashJoinExec, CoalescePartitionsExec, Count,
    CountStar, DeviceToHostExec, Exec, ExecContext, ExpandExec, FilterExec,
    GlobalLimitExec, HashAggregateExec, HostToDeviceExec,
    InMemorySourceExec, LocalLimitExec, Max, Min, ProjectExec, SortExec,
    SortOrder, Sum, WindowExec)
from spark_rapids_tpu_torch.ops import window as W
from spark_rapids_tpu_torch.ops.join import JOIN_TYPES
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
         "avg": Average}
# The window functions ``_convert_window`` maps onto ops/window.py.
_WINDOW_FNS = {"row_number", "rank", "dense_rank", "lead", "lag"}


def _expr_conf_key(kind: str) -> str:
    return f"spark.rapids.sql.expression.{kind}"


def _exec_conf_key(name: str) -> str:
    return f"spark.rapids.sql.exec.{name}"


def tag_column(c: Column, conf: C.TpuConf, reasons: List[str],
               port_reasons: List[str]):
    """Walk an untyped Column AST, collecting fallback reasons (the port's
    own also into ``port_reasons``). The reference's type-directed cast
    gates and host-roundtrip notes serve kinds the port has not ported;
    their "not ported" reason refuses them here."""
    kind = c.node[0]
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
            tag_column(x, conf, reasons, port_reasons)
        elif isinstance(x, tuple):
            for y in x:
                if isinstance(y, Column):
                    tag_column(y, conf, reasons, port_reasons)
                elif isinstance(y, tuple):
                    for z in y:
                        if isinstance(z, Column):
                            tag_column(z, conf, reasons, port_reasons)


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


_NODES = (L.InMemoryScan, L.LogicalFilter, L.LogicalProject,
          L.LogicalAggregate, L.LogicalSort, L.LogicalLimit, L.LogicalJoin,
          L.LogicalWindow)


def wrap_and_tag(plan: LogicalPlan, conf: C.TpuConf) -> NodeMeta:
    meta = NodeMeta(plan, [wrap_and_tag(c, conf) for c in plan.children])
    reasons, ours = meta.reasons, meta.port_reasons
    if not conf.sql_enabled:
        reasons.append("spark.rapids.sql.enabled is false")
    if not conf.is_op_enabled(_exec_conf_key(plan.name)):
        reasons.append(f"disabled by {_exec_conf_key(plan.name)}")
    if not isinstance(plan, _NODES):
        _port_reason(reasons, ours, f"{plan.name} is not ported")

    if isinstance(plan, L.LogicalFilter):
        tag_column(plan.condition, conf, reasons, ours)
    elif isinstance(plan, L.LogicalProject):
        for _, c in plan.projections:
            tag_column(c, conf, reasons, ours)
    elif isinstance(plan, L.LogicalAggregate):
        schema = _schema_or_none(plan.child)
        for _, c in plan.group_by:
            tag_column(c, conf, reasons, ours)
        for _, c in plan.aggregates:
            ac = _unalias(c)
            if ac.node[0] not in ("agg", "aggd"):
                continue
            if ac.node[2] is not None:
                tag_column(ac.node[2], conf, reasons, ours)
            _float_agg_reasons(ac, schema, conf, reasons)
            if ac.node[0] == "aggd" and ac.node[1] in ("first", "last"):
                # The reference's conversion error, before any refusal.
                raise ResolutionError(
                    f"{ac.node[1]}(DISTINCT) is not meaningful")
            if ac.node[1] not in _AGGS:
                _port_reason(reasons, ours,
                             f"aggregate {ac.node[1]} is not ported")
    elif isinstance(plan, L.LogicalSort):
        for o in plan.orders:
            tag_column(o.node[1] if o.node[0] == "sortorder" else o, conf,
                       reasons, ours)
    elif isinstance(plan, L.LogicalJoin):
        if plan.strategy == "shuffle" and plan.left_keys and \
                not conf.get(C.REPLACE_SORT_MERGE_JOIN):
            reasons.append(
                "co-partitioned (sort-merge-shaped) join replacement "
                "disabled by spark.rapids.sql.replaceSortMergeJoin.enabled")
        for k in plan.left_keys + plan.right_keys:
            tag_column(k, conf, reasons, ours)
        if plan.condition is not None:
            tag_column(plan.condition, conf, reasons, ours)
        if plan.join_type == "full":
            _port_reason(reasons, ours, "full outer join is not ported (it "
                         "needs a shuffled, co-partitioned plan)")
        elif plan.join_type not in JOIN_TYPES:
            _port_reason(reasons, ours,
                         f"join type {plan.join_type} is not ported")
        if not plan.left_keys:
            _port_reason(reasons, ours, "join without keys (nested loop "
                         "join) is not ported")
        if any(_unalias(k).node[0] != "ref"
               for k in plan.left_keys + plan.right_keys):
            _port_reason(reasons, ours, "join keys that are not column "
                         "references are not ported")
    elif isinstance(plan, L.LogicalWindow):
        for c in plan.window.partition_cols:
            tag_column(c, conf, reasons, ours)
        for o in plan.window.order_cols:
            inner = o.node[1] if o.node[0] == "sortorder" else o
            tag_column(inner, conf, reasons, ours)
        for _, fn_col in plan.exprs:
            node = fn_col.node
            if len(node) > 2 and isinstance(node[2], Column):
                tag_column(node[2], conf, reasons, ours)
            known = _WINDOW_FNS if node[0] == "winfn" else \
                set(_AGGS) if node[0] == "agg" else set()
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

    def host_fallback_nodes(self) -> List[str]:
        """The logical nodes tagged for the host engine, in tree order."""
        return [m.plan.name for m in _walk(self.meta) if not m.on_device]

    def tree(self) -> str:
        """The exec tree, one operator a line, with its join type,
        aggregate mode or source columns."""
        return "\n".join(_exec_lines(self.root, 0))


def _exec_lines(e: Exec, depth: int) -> List[str]:
    detail = ""
    if isinstance(e, BroadcastHashJoinExec):
        detail = f" {e.join_type}"
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
        self._tag_exchanges(meta)
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
        """One partition on one device unless the conf asks for more (the
        reference's single-device rule)."""
        if self.conf.raw.get(C.SHUFFLE_PARTITIONS.key) is None:
            return 1
        return int(self.conf.get(C.SHUFFLE_PARTITIONS))

    def _tag_exchanges(self, meta: NodeMeta):
        """Refuse every node that would plan an exchange into more than
        one partition: keyed aggregates, sorts, partitioned windows and
        shuffled joins."""
        n = self._shuffle_partitions()
        if n > 1:
            for m in _walk(meta):
                plan = m.plan
                if (isinstance(plan, L.LogicalAggregate) and plan.group_by) \
                        or isinstance(plan, L.LogicalSort) or \
                        (isinstance(plan, L.LogicalWindow)
                         and plan.window.partition_cols) or \
                        (isinstance(plan, L.LogicalJoin) and plan.left_keys
                         and self._join_strategy(plan)[0] == "shuffle"):
                    _port_reason(m.reasons, m.port_reasons,
                                 f"an exchange into {n} partitions "
                                 f"({C.SHUFFLE_PARTITIONS.key}) is not "
                                 "ported")

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
        if isinstance(plan, L.LogicalJoin):
            return self._convert_join(plan, meta, kids, want_dev), want_dev
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
            return GlobalLimitExec(CoalescePartitionsExec(local, 1),
                                   plan.n), want_dev
        if isinstance(plan, L.LogicalSort):
            # The reference's range exchange under a global sort, at one
            # partition.
            return SortExec(CoalescePartitionsExec(child, 1),
                            _orders(plan.orders, plan.child.schema)), want_dev
        if isinstance(plan, L.LogicalAggregate):
            return self._convert_aggregate(plan, child), want_dev
        if isinstance(plan, L.LogicalWindow):
            return self._convert_window(plan, child), want_dev
        raise NotImplementedError(f"cannot convert {plan.name}")

    def _convert_window(self, plan: L.LogicalWindow, child: Exec) -> Exec:
        """``WindowExec`` over its required distribution (the reference's
        hash exchange on the PARTITION BY keys, or a single partition for
        none), which is one partition here; ordering happens inside the
        window's frame sort."""
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
        return WindowExec(CoalescePartitionsExec(child, 1), wx_specs)

    def _convert_aggregate(self, plan: L.LogicalAggregate,
                           child: Exec) -> Exec:
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
                                               aggs, child)
        if any(s.distinct for s in aggs):
            return self._convert_distinct_aggregate(group_by, aggs, child)
        return self._two_stage(group_by, aggs, child)

    def _convert_grouping_sets(self, kind: str, group_by, aggs,
                               child: Exec) -> Exec:
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
        final = self._two_stage(ex_group, ex_aggs, expand)
        # Drop the grouping id from the output.
        out = [(n, BoundReference(i, e.data_type()))
               for i, (n, e) in enumerate(ex_group[:nk])]
        out += [(s.name, BoundReference(nk + 1 + i, s.fn.result_type))
                for i, s in enumerate(ex_aggs)]
        return ProjectExec(final, out)

    def _two_stage(self, group_by, aggs, child: Exec) -> Exec:
        """partial -> exchange -> final; the exchange (hash on the keys,
        or a single partition for a zero-key aggregate) is one partition
        here."""
        partial = HashAggregateExec(child, group_by, aggs, mode="partial")
        final_groups = [
            (n, BoundReference(i, e.data_type()))
            for i, (n, e) in enumerate(group_by)]
        return HashAggregateExec(CoalescePartitionsExec(partial, 1),
                                 final_groups, aggs, mode="final")

    def _convert_distinct_aggregate(self, group_by, aggs,
                                    child: Exec) -> Exec:
        """DISTINCT aggregates through the partial-merge mode combos
        (aggregate.scala:305 distinct handling):

          partial keyed by (keys..., x), with the partial non-distinct
          aggregates
          -> the exchange on the keys (one partition here; a zero-key
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
        stage_b = HashAggregateExec(CoalescePartitionsExec(stage_a, 1),
                                    gb_b, nd_specs, mode="merge")
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
        strategy, est, threshold = self._join_strategy(plan)
        if plan.strategy == "auto":
            meta.notes.append(
                f"auto join strategy -> {strategy} (build side "
                f"~{est if est is not None else '?'} bytes, "
                f"threshold {threshold})")
        if strategy != "broadcast":
            # A shuffled hash join of one partition a side.
            lch = CoalescePartitionsExec(lch, 1)
            rch = CoalescePartitionsExec(rch, 1)
        return BroadcastHashJoinExec(lch, rch, lkeys, rkeys, plan.join_type,
                                     cond)


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
