"""Plan rewrite: wrap -> tag -> convert (port of the JAX package's
``plan/planner.py``; ref: GpuOverrides.scala:1991, RapidsMeta.scala:189).

- Every logical node and expression is wrapped in a ``NodeMeta`` carrying
  fallback ``reasons`` (RapidsMeta.willNotWorkOnGpu analog). The
  per-node kill switches (``spark.rapids.sql.exec.<Node>`` /
  ``spark.rapids.sql.expression.<kind>``), the order-dependent float
  aggregation gate and the incompat-expression gates give the
  reference's reasons; a kind or node the port has no class for adds
  "... is not ported".
- The port has no host engine yet. A node the reference would run on the
  host is refused: ``Planner.plan`` raises ``NotImplementedError`` listing
  every such node with its reasons. So are the plans the port cannot
  shape yet: an exchange into more than one partition
  (``spark.rapids.sql.shuffle.partitions`` > 1), a full outer join, a
  join without keys, DISTINCT and grouping-set aggregates, join keys that
  are not column references. Nothing falls back quietly.
- Conversion emits the port's execs at one partition: every exchange the
  reference plans (SinglePartitioning under a limit or a zero-key
  aggregate, HashPartitioning between partial and final aggregates,
  RangePartitioning under a sort) becomes ``CoalescePartitionsExec(child,
  1)``. A join whose auto strategy comes out ``shuffle`` becomes a
  ``BroadcastHashJoinExec`` over both sides coalesced to one partition: a
  shuffled hash join of one partition a side is a hash join of the two
  whole sides.
- ``PhysicalPlan.explain`` renders the will/will-not-run report
  (RapidsMeta.explain:291); ``collect`` runs the root and downloads (the
  reference's scheduler, QoS, retry and fault layers are not ported).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from spark_rapids_tpu_torch import DeviceLike, config as C, resolve_device
from spark_rapids_tpu_torch.exprs.base import BoundReference
from spark_rapids_tpu_torch.ops import (
    AggSpec, Average, BroadcastHashJoinExec, CoalescePartitionsExec, Count,
    CountStar, Exec, ExecContext, FilterExec, GlobalLimitExec,
    HashAggregateExec, InMemorySourceExec, LocalLimitExec, Max, Min,
    ProjectExec, SortExec, SortOrder, Sum)
from spark_rapids_tpu_torch.ops.join import JOIN_TYPES
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.logical import (
    Column, LogicalPlan, NotPortedError, ResolutionError, resolve)
from spark_rapids_tpu_torch.plan.pruning import (
    estimate_bytes, prune_columns, pushdown_filters)


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


def _expr_conf_key(kind: str) -> str:
    return f"spark.rapids.sql.expression.{kind}"


def _exec_conf_key(name: str) -> str:
    return f"spark.rapids.sql.exec.{name}"


def tag_column(c: Column, conf: C.TpuConf, reasons: List[str]):
    """Walk an untyped Column AST, collecting fallback reasons. The
    reference's type-directed cast gates and host-roundtrip notes serve
    kinds the port has not ported; their "not ported" reason refuses
    them here."""
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
    if kind not in L.PORTED_KINDS and kind != "sortorder":
        reasons.append(f"expression {kind} is not ported")
    for x in c.node[1:]:
        if isinstance(x, Column):
            tag_column(x, conf, reasons)
        elif isinstance(x, tuple):
            for y in x:
                if isinstance(y, Column):
                    tag_column(y, conf, reasons)
                elif isinstance(y, tuple):
                    for z in y:
                        if isinstance(z, Column):
                            tag_column(z, conf, reasons)


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
    plan: LogicalPlan
    children: List["NodeMeta"]
    reasons: List[str] = dataclasses.field(default_factory=list)
    notes: List[str] = dataclasses.field(default_factory=list)

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
          L.LogicalAggregate, L.LogicalSort, L.LogicalLimit, L.LogicalJoin)


def wrap_and_tag(plan: LogicalPlan, conf: C.TpuConf) -> NodeMeta:
    meta = NodeMeta(plan, [wrap_and_tag(c, conf) for c in plan.children])
    reasons = meta.reasons
    if not conf.sql_enabled:
        reasons.append("spark.rapids.sql.enabled is false")
    if not conf.is_op_enabled(_exec_conf_key(plan.name)):
        reasons.append(f"disabled by {_exec_conf_key(plan.name)}")
    if not isinstance(plan, _NODES):
        reasons.append(f"{plan.name} is not ported")

    if isinstance(plan, L.LogicalFilter):
        tag_column(plan.condition, conf, reasons)
    elif isinstance(plan, L.LogicalProject):
        for _, c in plan.projections:
            tag_column(c, conf, reasons)
    elif isinstance(plan, L.LogicalAggregate):
        schema = _schema_or_none(plan.child)
        for _, c in plan.group_by:
            tag_column(c, conf, reasons)
        for _, c in plan.aggregates:
            ac = _unalias(c)
            if ac.node[0] not in ("agg", "aggd"):
                continue
            if ac.node[2] is not None:
                tag_column(ac.node[2], conf, reasons)
            _float_agg_reasons(ac, schema, conf, reasons)
            if ac.node[0] == "aggd":
                reasons.append(f"DISTINCT aggregate {ac.node[1]} is not "
                               "ported")
            elif ac.node[1] not in _AGGS:
                reasons.append(f"aggregate {ac.node[1]} is not ported")
        if plan.grouping is not None:
            reasons.append(f"grouping sets ({plan.grouping}) are not "
                           "ported")
    elif isinstance(plan, L.LogicalSort):
        for o in plan.orders:
            tag_column(o.node[1] if o.node[0] == "sortorder" else o, conf,
                       reasons)
    elif isinstance(plan, L.LogicalJoin):
        if plan.strategy == "shuffle" and plan.left_keys and \
                not conf.get(C.REPLACE_SORT_MERGE_JOIN):
            reasons.append(
                "co-partitioned (sort-merge-shaped) join replacement "
                "disabled by spark.rapids.sql.replaceSortMergeJoin.enabled")
        for k in plan.left_keys + plan.right_keys:
            tag_column(k, conf, reasons)
        if plan.condition is not None:
            tag_column(plan.condition, conf, reasons)
        if plan.join_type == "full":
            reasons.append("full outer join is not ported (it needs a "
                           "shuffled, co-partitioned plan)")
        elif plan.join_type not in JOIN_TYPES:
            reasons.append(f"join type {plan.join_type} is not ported")
        if not plan.left_keys:
            reasons.append("join without keys (nested loop join) is not "
                           "ported")
        if any(_unalias(k).node[0] != "ref"
               for k in plan.left_keys + plan.right_keys):
            reasons.append("join keys that are not column references are "
                           "not ported")
    return meta


# ---------------------------------------------------------------------------
# Aggregate resolution
# ---------------------------------------------------------------------------

def _unalias(c: Column) -> Column:
    while c.node[0] == "alias":
        c = c.node[1]
    return c


def resolve_agg(c: Column, schema):
    """The port's aggregate function for an ``agg`` (or ``aggd``) Column.
    DISTINCT types as its plain function: the planner refuses it."""
    c = _unalias(c)
    if c.node[0] not in ("agg", "aggd"):
        raise ResolutionError(f"not an aggregate: {c.node[0]}")
    kind = c.node[1]
    child_col = c.node[2]
    child = None if child_col is None else resolve(child_col, schema)
    if kind == "count" and child is None:
        return CountStar(None)
    if kind in _AGGS:
        return _AGGS[kind](child)
    raise NotPortedError(f"aggregate {kind} is not ported")


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PhysicalPlan:
    """Planner output: the root exec, the tagged meta tree for explain,
    and the conf the query was planned with (runtime-read configs see the
    same values)."""

    root: Exec
    meta: NodeMeta
    conf: C.TpuConf = dataclasses.field(default_factory=C.TpuConf)

    def explain(self, mode: str = "ALL") -> str:
        return "\n".join(self.meta.explain_lines(
            not_on_device_only=(mode.upper() == "NOT_ON_GPU")))

    def collect(self, ctx: Optional[ExecContext] = None) -> List[tuple]:
        """Run the root's partitions on the plan's device and download
        the rows."""
        return self.root.collect(ctx or ExecContext(self.conf))

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
    lines = ["the port cannot plan this query (it has no host engine "
             "yet); refused nodes:"]
    for m in refused:
        lines.append(f"  {m.plan.name}: " + "; ".join(m.reasons))
    return "\n".join(lines)


class Planner:
    """Converts a tagged logical plan into the port's exec tree, with
    every source uploading to ``device`` (``None`` = the CUDA card)."""

    def __init__(self, conf: Optional[C.TpuConf] = None,
                 device: DeviceLike = None):
        self.conf = conf or C.TpuConf()
        self.device = resolve_device(device)

    # -- public --------------------------------------------------------------
    def plan(self, logical: LogicalPlan) -> PhysicalPlan:
        try:
            logical = pushdown_filters(prune_columns(logical))
        except NotPortedError:
            # Pruning reads join sides' schemas; a plan holding a kind the
            # port cannot resolve is refused by the tagging below.
            pass
        meta = wrap_and_tag(logical, self.conf)
        self._tag_exchanges(meta)
        if self.conf.explain in ("ALL", "NOT_ON_GPU"):
            print("\n".join(meta.explain_lines(
                not_on_device_only=self.conf.explain == "NOT_ON_GPU")))
        refused = [m for m in _walk(meta) if m.reasons]
        if refused:
            if self.conf.test_enabled:
                allowed = {s for s in str(self.conf.get(
                    C.TEST_ALLOWED_NONTPU)).split(",") if s}
                bad = [m.plan.name for m in refused
                       if m.plan.name not in allowed]
                if bad:
                    raise AssertionError(
                        f"Query would execute on host: {bad} "
                        "(spark.rapids.sql.test.enabled)")
            raise NotImplementedError(_refusal(refused))
        return PhysicalPlan(self._convert(meta), meta, self.conf)

    # -- helpers -------------------------------------------------------------
    def _shuffle_partitions(self) -> int:
        """One partition on one device unless the conf asks for more (the
        reference's single-device rule)."""
        if self.conf.raw.get(C.SHUFFLE_PARTITIONS.key) is None:
            return 1
        return int(self.conf.get(C.SHUFFLE_PARTITIONS))

    def _tag_exchanges(self, meta: NodeMeta):
        """Refuse every node that would plan an exchange into more than
        one partition: keyed aggregates, sorts and shuffled joins."""
        n = self._shuffle_partitions()
        if n > 1:
            for m in _walk(meta):
                plan = m.plan
                if (isinstance(plan, L.LogicalAggregate) and plan.group_by) \
                        or isinstance(plan, L.LogicalSort) or \
                        (isinstance(plan, L.LogicalJoin) and plan.left_keys
                         and self._join_strategy(plan)[0] == "shuffle"):
                    m.reasons.append(
                        f"an exchange into {n} partitions "
                        f"({C.SHUFFLE_PARTITIONS.key}) is not ported")

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

    def _convert(self, meta: NodeMeta) -> Exec:
        plan = meta.plan
        kids = [self._convert(c) for c in meta.children]
        if isinstance(plan, L.InMemoryScan):
            return InMemorySourceExec(plan.schema, plan.partitions,
                                      device=self.device)
        if isinstance(plan, L.LogicalFilter):
            return FilterExec(kids[0], resolve(plan.condition,
                                               plan.child.schema))
        if isinstance(plan, L.LogicalProject):
            return ProjectExec(kids[0], [
                (n, resolve(c, plan.child.schema))
                for n, c in plan.projections])
        if isinstance(plan, L.LogicalLimit):
            local = LocalLimitExec(kids[0], plan.n)
            return GlobalLimitExec(CoalescePartitionsExec(local, 1), plan.n)
        if isinstance(plan, L.LogicalSort):
            # The reference's range exchange under a global sort, at one
            # partition.
            return SortExec(CoalescePartitionsExec(kids[0], 1),
                            self._sort_orders(plan))
        if isinstance(plan, L.LogicalAggregate):
            return self._convert_aggregate(plan, kids[0])
        if isinstance(plan, L.LogicalJoin):
            return self._convert_join(plan, meta, kids)
        raise NotImplementedError(f"cannot convert {plan.name}")

    def _sort_orders(self, plan: L.LogicalSort) -> List[SortOrder]:
        orders = []
        for o in plan.orders:
            if o.node[0] == "sortorder":
                inner, asc, nf = o.node[1], o.node[2], o.node[3]
            else:
                inner, asc, nf = o, True, True
            orders.append(SortOrder(resolve(inner, plan.child.schema),
                                    asc, nf))
        return orders

    def _convert_aggregate(self, plan: L.LogicalAggregate,
                           child: Exec) -> Exec:
        schema = plan.child.schema
        group_by = [(n, resolve(c, schema)) for n, c in plan.group_by]
        aggs = [AggSpec(n, resolve_agg(c, schema))
                for n, c in plan.aggregates]
        return self._two_stage(group_by, aggs, child)

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

    def _convert_join(self, plan: L.LogicalJoin, meta: NodeMeta,
                      kids) -> Exec:
        lch, rch = kids
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


def _walk(meta: NodeMeta):
    yield meta
    for ch in meta.children:
        yield from _walk(ch)
