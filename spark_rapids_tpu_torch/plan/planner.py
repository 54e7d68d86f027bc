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
  it has no class for ("... is not ported"), a window function it has
  no class for, join keys that are not column references.
  ``Planner.plan`` refuses such a plan with ``NotImplementedError``
  listing every such node.
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
- The six kinds the reference computes on the host inside a device plan
  (``_HOST_ROUNDTRIP_EXPRS``) carry its note "expression {kind} runs via
  a host roundtrip"; casts to and from strings make the same roundtrip,
  behind the reference's float gates (``castFloatToString``,
  ``castStringToFloat``), which place a float <-> string cast on the
  host engine.
- ``explode`` / ``posexplode`` / ``explode_outer`` is a ``GenerateExec``
  (``ops/generate.py``) over its child, bridged to its engine.
- A ``pyudf`` (a ``udf`` that did not compile) carries the reference's
  note naming the compile error; it runs on its node's engine, the
  device half a roundtrip through the host (``exprs/pyudf.py``). The
  four pandas-UDF nodes convert to ``ops/pandas_exec.py``'s execs over
  their bridged children; a grouped or cogrouped one on the device sits
  over a hash exchange on its keys (``_pandas_group_exchange``).
- A file scan (``read.parquet`` / ``orc`` / ``csv``) is an
  ``io/scan.py`` ``FileScanExec`` on the plan's device; a format gate
  that is off (``spark.rapids.sql.format.<fmt>.enabled`` /
  ``.read.enabled``) tags it for the host engine. A plan that reads
  ``input_file_name()`` scans file by file (``force_perfile``).
- ``range`` is a ``RangeExec`` source (batches of ``batchSizeRows``
  built on the card), ``union`` a ``UnionExec`` over its children, each
  bridged to the union's engine.
- Task-context expressions (``rand``, ``spark_partition_id``,
  ``monotonically_increasing_id``, ``input_file_name``) are an analysis
  error anywhere but in a projection or a filter, whose operators thread
  the partition and row base (``_forbid_contextual``; explode elements
  included).
- ROLLUP and CUBE lower to ``ExpandExec`` under the two-stage aggregate
  keyed by the grouping id; DISTINCT aggregates lower to the partial /
  merge / mixed_final pipeline (``_convert_distinct_aggregate``);
  adjacent windows of one spec merge before conversion
  (``merge_windows``).
- After tagging, cost-based placement (``plan/cost.py``
  ``apply_placement``) flips each maximal subtree whose footer-stats
  estimate is cheaper on the host to the host engine
  (``NodeMeta.cost_host``); ``PhysicalPlan.cost_report`` keeps the
  decision, ``explain`` prints its estimates, and its device + host
  estimate prices the query's admission (``cost_ms``).
- The host engine runs only the nodes tagged for the reference's
  reasons or placed there by the cost model: a failing device operator
  raises, and is never rerun there (an exhausted OOM ladder tries the
  grace join on the device first, ``Exec.execute_device_recovering``).
- After conversion, ``Planner.plan``, under
  ``spark.rapids.sql.stageFusion.enabled``, collapses each maximal run of
  fusible device operators into a ``FusedStageExec`` (``plan/fusion.py``).
- ``PhysicalPlan.explain`` renders the will/will-not-run report
  (RapidsMeta.explain:291) and the fused stages; ``collect`` runs the root
  on its engine through the recovery ladder (stage recompute, transient
  retry on the same context, whole-query retry on a fresh one;
  ``PhysicalPlan._execute``), with a plan-cache binding vector installed
  in every context it makes, and closes the context at the end, under
  the multi-query scheduler's admission (``parallel/scheduler.py``).
- A shuffled hash join keeps its planning-time build estimate
  (``est_build_bytes``) for the runtime re-plan's error metric; a
  grouping-set plan's partial aggregate never skips its grouping
  (``allow_partial_skip``).
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import time
from typing import List, Optional, Tuple

import torch

from spark_rapids_tpu_torch import DeviceLike, config as C, resolve_device
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.exprs.base import BoundReference, Literal
from spark_rapids_tpu_torch.io.scan import FileScanExec, make_scan_exec
from spark_rapids_tpu_torch.ops import (
    AggSpec, Average, BroadcastHashJoinExec, BroadcastNestedLoopJoinExec,
    Count, CountStar, DeviceToHostExec, Exec, ExecContext, ExpandExec,
    FilterExec, First, GenerateExec, GlobalLimitExec, HashAggregateExec,
    HostToDeviceExec, InMemorySourceExec, Last, LocalLimitExec, Max, Min,
    ProjectExec, RangeExec, ShuffledHashJoinExec, SortExec, SortOrder, Sum,
    UnionExec, WindowExec)
from spark_rapids_tpu_torch.ops import window as W
from spark_rapids_tpu_torch.ops.fused import FusedStageExec
from spark_rapids_tpu_torch.ops.pandas_exec import (
    AggregateInPandasExec, CoGroupedMapInPandasExec,
    FlatMapGroupsInPandasExec, MapInPandasExec)
from spark_rapids_tpu_torch.ops.join import JOIN_TYPES
from spark_rapids_tpu_torch.parallel.exchange import ShuffleExchangeExec
from spark_rapids_tpu_torch.parallel.mesh_exchange import (
    MeshExchangeExec, mesh_size)
from spark_rapids_tpu_torch.parallel.partitioning import (
    HashPartitioning, RangePartitioning, RoundRobinPartitioning,
    SinglePartitioning)
from spark_rapids_tpu_torch.plan import cost as COST, logical as L
from spark_rapids_tpu_torch.plan.fusion import collect_fused, fuse_stages
from spark_rapids_tpu_torch.plan.logical import (
    Column, LogicalPlan, NotPortedError, ResolutionError, resolve)
from spark_rapids_tpu_torch.plan.pruning import (
    estimate_bytes, prune_columns, pushdown_filters, refs_of)

_LOG = logging.getLogger("spark_rapids_tpu_torch")


# ---------------------------------------------------------------------------
# Expression tagging rules (GpuOverrides expr registry analog)
# ---------------------------------------------------------------------------

# Kinds whose device implementation can differ from the JVM in corner
# cases (ASCII-only case mapping), and transcendentals whose rounding can
# differ from java.lang.Math: the reference's gates and reasons, which
# place such a node on the host engine unless the conf allows them.
_INCOMPAT_EXPRS = {
    "upper": "locale-sensitive case mapping is ASCII-only on TPU",
    "lower": "locale-sensitive case mapping is ASCII-only on TPU",
    "initcap": "locale-sensitive case mapping is ASCII-only on TPU",
}
# Kinds that execute on the host even inside the device plan (regular
# expressions and friends), as in the reference: a note, not a reason.
_HOST_ROUNDTRIP_EXPRS = {"regexp_replace", "regexp_extract", "translate",
                         "lpad", "rpad", "replace"}
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
               port_reasons: List[str], schema=None,
               notes: Optional[List[str]] = None):
    """Walk an untyped Column AST, collecting fallback reasons (the port's
    own also into ``port_reasons``) and notes (the host roundtrips).
    ``schema`` (when known) types a cast's input for the reference's
    float <-> string cast gates (GpuCast meta tagging)."""
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
    if kind == "cast" and schema is not None:
        try:
            src = resolve(c.node[1], schema).data_type()
        except Exception:
            src = None
        dst = c.node[2]
        if src is not None and src.is_floating and dst.is_string and \
                not conf.get(C.CAST_FLOAT_TO_STRING):
            reasons.append(
                "casting floats to string formats differently from Spark; "
                "enable spark.rapids.sql.castFloatToString.enabled")
        if src is not None and src.is_string and dst.is_floating and \
                not conf.get(C.CAST_STRING_TO_FLOAT):
            reasons.append(
                "casting strings to float differs in corner cases; "
                "enable spark.rapids.sql.castStringToFloat.enabled")
    if kind in _HOST_ROUNDTRIP_EXPRS and notes is not None:
        notes.append(f"expression {kind} runs via a host roundtrip")
    if kind == "pyudf" and notes is not None:
        fname = getattr(c.node[1], "__name__", "udf")
        notes.append(
            f"python UDF {fname!r} could not be compiled to native "
            f"expressions ({c.node[4]}); runs via host roundtrip "
            "(GpuArrowEvalPythonExec-style fallback)")
    if kind not in L.PORTED_KINDS and kind not in L.WINDOW_KINDS and \
            kind not in L.GENERATE_KINDS and kind != "sortorder":
        _port_reason(reasons, port_reasons,
                     f"expression {kind} is not ported")
    for x in c.node[1:]:
        if isinstance(x, Column):
            tag_column(x, conf, reasons, port_reasons, schema, notes)
        elif isinstance(x, tuple):
            for y in x:
                if isinstance(y, Column):
                    tag_column(y, conf, reasons, port_reasons, schema,
                               notes)
                elif isinstance(y, tuple):
                    for z in y:
                        if isinstance(z, Column):
                            tag_column(z, conf, reasons, port_reasons,
                                       schema, notes)


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


def _uses_input_file(plan: LogicalPlan) -> bool:
    """True when a projection or filter reads input_file_name(): scans
    must then stay per file (the reference's disableCoalesceUntilInput
    fence, GpuExpressions.scala:64-74), so the published path is
    exact."""
    cols: List[Column] = []
    if isinstance(plan, L.LogicalProject):
        cols = [c for _, c in plan.projections]
    elif isinstance(plan, L.LogicalFilter):
        cols = [plan.condition]
    for c in cols:
        if "input_file_name" in _column_kinds(c, set()):
            return True
    return any(_uses_input_file(ch) for ch in plan.children)


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
    # Cost-based placement (plan/cost.py): True puts this node on the
    # host engine as a PLACEMENT choice, not a capability fallback, so
    # it stays apart from ``reasons`` (explain reasons and test-mode
    # allowlists keep their capability meaning).
    cost_host: bool = False

    @property
    def on_device(self) -> bool:
        return not self.reasons and not self.cost_host

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


_NODES = (L.InMemoryScan, L.FileScan, L.LogicalRange, L.LogicalFilter,
          L.LogicalProject, L.LogicalAggregate, L.LogicalSort,
          L.LogicalLimit, L.LogicalJoin, L.LogicalWindow,
          L.LogicalRepartition, L.LogicalUnion, L.LogicalGenerate,
          L.LogicalMapInPandas, L.LogicalGroupedMapInPandas,
          L.LogicalCoGroupedMapInPandas, L.LogicalAggInPandas)


def wrap_and_tag(plan: LogicalPlan, conf: C.TpuConf) -> NodeMeta:
    meta = NodeMeta(plan, [wrap_and_tag(c, conf) for c in plan.children])
    reasons, ours, notes = meta.reasons, meta.port_reasons, meta.notes
    if not conf.sql_enabled:
        reasons.append("spark.rapids.sql.enabled is false")
    if not conf.is_op_enabled(_exec_conf_key(plan.name)):
        reasons.append(f"disabled by {_exec_conf_key(plan.name)}")
    if not isinstance(plan, _NODES):
        _port_reason(reasons, ours, f"{plan.name} is not ported")

    child_schema = _schema_or_none(plan.children[0]) \
        if plan.children else None
    if isinstance(plan, L.FileScan):
        fmt_gates = {
            "parquet": (C.ENABLE_PARQUET, C.ENABLE_PARQUET_READ),
            "orc": (C.ENABLE_ORC, C.ENABLE_ORC_READ),
            "csv": (C.ENABLE_CSV, C.ENABLE_CSV_READ),
        }
        for entry in fmt_gates.get(plan.fmt, ()):
            if not bool(conf.get(entry)):
                reasons.append(f"{plan.fmt} scan disabled by {entry.key}")
    elif isinstance(plan, L.LogicalFilter):
        tag_column(plan.condition, conf, reasons, ours, child_schema,
                   notes)
    elif isinstance(plan, L.LogicalProject):
        for _, c in plan.projections:
            tag_column(c, conf, reasons, ours, child_schema, notes)
    elif isinstance(plan, L.LogicalAggregate):
        for _, c in plan.group_by:
            _forbid_contextual(c, "group_by")
            tag_column(c, conf, reasons, ours, child_schema, notes)
        for _, c in plan.aggregates:
            _forbid_contextual(c, "aggregates")
            ac = _unalias(c)
            if ac.node[0] not in ("agg", "aggd"):
                continue
            if ac.node[2] is not None:
                tag_column(ac.node[2], conf, reasons, ours, child_schema,
                           notes)
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
            tag_column(inner, conf, reasons, ours, child_schema, notes)
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
            tag_column(k, conf, reasons, ours, ls, notes)
        for k in plan.right_keys:
            _forbid_contextual(k, "join keys")
            tag_column(k, conf, reasons, ours, rs, notes)
        if plan.condition is not None:
            _forbid_contextual(plan.condition, "join condition")
            tag_column(plan.condition, conf, reasons, ours,
                       None if ls is None or rs is None
                       else tuple(ls) + tuple(rs), notes)
        if plan.join_type not in JOIN_TYPES:
            _port_reason(reasons, ours,
                         f"join type {plan.join_type} is not ported")
        if any(_unalias(k).node[0] != "ref"
               for k in plan.left_keys + plan.right_keys):
            _port_reason(reasons, ours, "join keys that are not column "
                         "references are not ported")
    elif isinstance(plan, L.LogicalGenerate):
        for c in plan.elements:
            _forbid_contextual(c, "explode elements")
            tag_column(c, conf, reasons, ours, child_schema, notes)
    elif isinstance(plan, L.LogicalRepartition):
        for k in (plan.keys or []):
            _forbid_contextual(k, "repartition keys")
            tag_column(k, conf, reasons, ours, child_schema, notes)
    elif isinstance(plan, L.LogicalWindow):
        for c in plan.window.partition_cols:
            _forbid_contextual(c, "window partition keys")
            tag_column(c, conf, reasons, ours, child_schema, notes)
        for o in plan.window.order_cols:
            inner = o.node[1] if o.node[0] == "sortorder" else o
            _forbid_contextual(inner, "window order keys")
            tag_column(inner, conf, reasons, ours, child_schema, notes)
        for _, fn_col in plan.exprs:
            node = fn_col.node
            if len(node) > 2 and isinstance(node[2], Column):
                tag_column(node[2], conf, reasons, ours, child_schema,
                           notes)
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
    num_fused_stages: int = 0
    # The context of the last collect (its metrics and trace ring); a
    # plan-cache template shares it between every DataFrame bound to it.
    last_ctx: Optional[ExecContext] = dataclasses.field(
        default=None, repr=False, compare=False)
    # What the cost model decided (plan/cost.py), and the device the
    # plan was placed for (its estimates depend on it).
    cost_report: Optional[COST.CostReport] = None
    device: Optional[torch.device] = None

    def explain(self, mode: str = "ALL") -> str:
        lines = self.meta.explain_lines(
            not_on_device_only=(mode.upper() == "NOT_ON_GPU"))
        fused = collect_fused(self.root)
        if fused:
            # Each fused stage with its members, so the physical shape
            # (and each stage's metrics owner) reads beside the report.
            lines.append(f"Fused stages: {len(fused)}")
            for i, f in enumerate(fused):
                members = ", ".join(type(o).__name__ for o in f.ops)
                lines.append(f"  *Stage #{i} <{f.name}> fuses [{members}]")
        report = self.cost_report
        if report is not None and (report.placements or report.lines or
                                   bool(self.conf.get(C.COST_EXPLAIN))):
            lines.extend(report.explain_lines())
        return "\n".join(lines)

    def cost_ms(self) -> Optional[float]:
        """The admission cost estimate: the plan's device + host
        projection (plan/cost.py), or None when placement was skipped
        (an un-priced plan: no file scan, or a gate off)."""
        report = self.cost_report
        if report is None or report.skipped is not None:
            return None
        return float(report.est_device_ms) + float(report.est_host_ms)

    def _context(self, ctx: Optional[ExecContext], bindings,
                 ticket=None) -> ExecContext:
        """``ctx`` (or a new one on the plan's conf, for the admitted
        ``ticket``) with the plan cache's ``(values, dtypes)`` binding
        vector installed, where there is one."""
        ctx = ctx or ExecContext(self.conf, query=ticket)
        if bindings is not None:
            ctx.cache["plan_binds"] = tuple(bindings[0])
            ctx.cache["plan_bind_dtypes"] = tuple(bindings[1])
        return ctx

    def collect(self, ctx: Optional[ExecContext] = None,
                timeout_ms: Optional[float] = None,
                cancel_event=None, bindings=None,
                plan_cache_hit: Optional[bool] = None,
                priority: Optional[str] = None,
                tenant: Optional[str] = None) -> List[tuple]:
        """Run the root's partitions on the root's engine and return the
        rows (downloaded once, when the root is on the device).
        ``bindings`` is a bound plan's ``(values, dtypes)``;
        ``plan_cache_hit`` (not None) records the plan-cache outcome on
        the ``Scheduler@query`` entry. ``timeout_ms`` arms a deadline,
        ``cancel_event`` is a handle's cancel event, and ``priority`` /
        ``tenant`` feed the QoS scheduler (``parallel/qos/``); with QoS
        off the tenant is attribution only."""
        rows: List[tuple] = []
        for hb in self._execute(ctx, bindings, timeout_ms, cancel_event,
                                plan_cache_hit, priority, tenant):
            rows.extend(hb.to_pylist())
        return rows

    def collect_batches(self, ctx: Optional[ExecContext] = None,
                        bindings=None, timeout_ms: Optional[float] = None,
                        cancel_event=None,
                        plan_cache_hit: Optional[bool] = None,
                        priority: Optional[str] = None,
                        tenant: Optional[str] = None) -> list:
        """``collect`` as host batches (numpy columns)."""
        return self._execute(ctx, bindings, timeout_ms, cancel_event,
                             plan_cache_hit, priority, tenant)

    def _execute(self, ctx: Optional[ExecContext], bindings,
                 timeout_ms=None, cancel_event=None, plan_cache_hit=None,
                 priority=None, tenant=None) -> list:
        """One query: adopt the trace and telemetry configuration, admit
        an owned top-level collect (no caller context, no token on this
        thread) through the multi-query scheduler (``parallel/
        scheduler.py``: its ticket's token, deadline and context
        registration, and the ``Scheduler@query`` entry), arm the fault
        schedule and restore the batch target once, run the recovery
        ladder, and at the end count the cancel or deadline kill, release
        the run slot, count ``srt_queries`` / ``srt_query_latency_ms``,
        append the event-log record, keep the context as ``last_ctx``
        (its metrics survive for ``DataFrame.metrics()``) and close it. A
        nested collect rides the token already on its thread. A rejected
        admission raises ``QueryRejectedError`` before anything runs.

        The recovery ladder (the reference's ``PhysicalPlan.collect``),
        smallest scope first, on owned contexts only (a caller's context
        runs once: it may hold state the caller still needs). A cancelled
        or deadlined query unwinds through every rung, as
        ``QueryCancelledError``, and is never retried.

        0. preemption: the class-ranked device gate asked the query to
           yield (``QueryPreemptedError`` at a partition boundary). Its
           catalog spills through the OOM ladder's spill-all
           (``preemption.spill.enabled``), it waits for the preemptor to
           drain (``TpuSemaphore.wait_resume``) and re-collects on the
           SAME context, where materialized stages serve again; it counts
           ``preemptions``, ``preemptedMs`` and ``resumedStages``, at most
           ``preemption.maxPerQuery`` times, after which the query
           ignores further requests. A fault at the ``preempt.spill`` or
           ``preempt.resume`` site enters the rungs below;
        1. stage recompute: a failure attributable to one stage's lost
           output (a ``lostoutput`` injection, a kept piece that fails
           its checksum twice) invalidates that stage and re-runs on the
           SAME context, where every sibling stage serves its
           materialization; at most ``recovery.maxStageRecomputes``;
        2. the first transient error (``memory/oom.py``
           ``is_transient_error``) retries on the same context too, when
           the plan has a stage graph;
        3. a later transient error retries the whole query on a fresh
           context, with its bindings and ``trace_query`` installed again,
           at most ``retry.transientMaxRetries`` retries in all, each
           after ``backoff_delay_ms`` seeded by ``test.faults.seed``.

        Each retry counts ``retriesAttempted`` in ``Recovery@query``. A
        non-transient error is never retried. There is no host-fallback
        rung.

        Under ``spark.rapids.sql.cluster.enabled`` an owned collect first
        prepares a cluster run (``parallel/cluster/``: the plan pickled
        to the spool, its dispatchable stages submitted); every attempt
        then waits at its dispatch barrier before the local collect,
        rung 1 requeues the lost stage's task too, rung 3 resets every
        task and installs the run on the fresh context, and the run
        finishes (its spool removed) before the context closes."""
        from spark_rapids_tpu_torch import faults, monitoring
        from spark_rapids_tpu_torch.memory.oom import (
            backoff_delay_ms, is_transient_error, reset_degradation)
        from spark_rapids_tpu_torch.ops.base import query_metrics_entry
        from spark_rapids_tpu_torch.parallel import scheduler as SC
        from spark_rapids_tpu_torch.parallel import stages as S
        owned = ctx is None
        # The trace and telemetry configuration first, so the admission's
        # span and a rejection's counters record too.
        monitoring.maybe_configure(self.conf)
        monitoring.telemetry.maybe_configure(self.conf)
        # The fault schedule is armed once per query, not per attempt: a
        # retried attempt runs against the remaining schedule. It and the
        # ladder's settings are read before admission, so nothing between
        # the admission and the ladder's ``finally`` can raise and strand
        # the run slot.
        faults.maybe_configure(self.conf)
        max_retries = max(int(self.conf.get(C.RETRY_TRANSIENT_MAX)), 0)
        base_ms = int(self.conf.get(C.RETRY_BACKOFF_MS))
        max_ms = int(self.conf.get(C.RETRY_MAX_BACKOFF_MS))
        seed = int(self.conf.get(C.TEST_FAULTS_SEED))
        graph = None
        if owned and bool(self.conf.get(C.STAGE_RECOVERY_ENABLED)):
            graph = S.build_stage_graph(self.root)
        stage_budget = max(
            int(self.conf.get(C.RECOVERY_MAX_STAGE_RECOMPUTES)), 0)
        ticket = None
        mgr = None
        if owned and faults.get_query_token() is None:
            mgr = SC.get_query_manager(self.conf)
            # The admission cost estimate prices deadline admission and
            # the shortest-job-first order; a plan-cache hit reuses the
            # template's CostReport.
            ticket = mgr.admit(self.conf, cancel=cancel_event,
                               priority=priority, tenant=tenant,
                               cost_ms=self.cost_ms(),
                               deadline_ms=timeout_ms)
            ticket.arm_deadline(timeout_ms)
            faults.set_query_token(ticket.token)
        ctx = self._context(ctx, bindings, ticket)
        # The Cost@query audit entry: the static placement at admission;
        # the runtime re-plan (parallel/replan.py) adds its counters.
        report = self.cost_report
        if report is not None and report.skipped is None:
            cm = query_metrics_entry(ctx, "Cost")
            cm.add("placements", report.placements)
            cm.add("hostPlacedNodes", report.nodes_host_placed)
            cm.add("estDeviceMs", report.est_device_ms)
            cm.add("estHostMs", report.est_host_ms)
            cm.add("estSyncs", report.est_syncs)
        # The ring the flight recorder files this query's events under
        # (trace_export / explain_analyze read it off last_ctx).
        tok = faults.get_query_token()
        trace_qid = tok.query_id if tok is not None else 0
        ctx.cache["trace_query"] = trace_qid
        if ticket is not None:
            mgr.register_context(ticket, ctx)
            sched = SC.metrics_entry(ctx)
            sched.add("admitted", 1)
            sched.add("queuedMs", ticket.queued_ms)
            if ticket.qos_class is not None:
                sched.add(f"class.{ticket.qos_class}", 1)
            if ticket.tenant is not None:
                sched.add(f"tenant.{ticket.tenant}", 1)
            if plan_cache_hit is not None:
                SC.record_plan_cache(ctx, plan_cache_hit)
        # The batch target a previous query's OOM ladder degraded is
        # restored once a query: an attempt keeps the shrink an earlier
        # attempt's ladder made.
        reset_degradation()
        stage_recomputes = 0
        same_ctx_retry_used = False
        preempt_count = 0
        attempt = 0
        t0 = time.perf_counter()
        status, err_text = "ok", None
        qrun = None
        try:
            if owned and bool(self.conf.get(C.CLUSTER_ENABLED)):
                # The cluster runtime (parallel/cluster/): dispatch the
                # stage DAG to the registered workers; None (no
                # dispatchable stage, an unpicklable plan, host nodes, the
                # mesh transport) runs the query here as before.
                from spark_rapids_tpu_torch.parallel import cluster as CL
                qrun = CL.maybe_prepare(self, ctx, graph)
            while True:
                try:
                    if qrun is not None:
                        # The dispatch barrier: every remote stage is
                        # committed before the local collect fetches.
                        qrun.run(ctx)
                    return self.root.run_batches(
                        ctx, device=self.root_on_device)
                except Exception as e:
                    if not owned:
                        raise
                    # A cancelled or deadlined query is done, whatever
                    # error the cancel surfaced as (a killed stall, a torn
                    # stream): no rung may retry it.
                    if ticket is not None and ticket.token.cancelled():
                        if not isinstance(e, faults.QueryCancelledError):
                            raise ticket.token.error() from e
                        raise
                    # Rung 0: preemption, not a failure at all.
                    if isinstance(e, faults.QueryPreemptedError) \
                            and ticket is not None:
                        preempt_count += 1
                        budget = max(int(self.conf.get(
                            C.PREEMPTION_MAX_PER_QUERY)), 0)
                        if preempt_count > budget:
                            # Budget spent: the query never yields again.
                            ticket.token.preempt_enabled = False
                            ticket.token.clear_preempt()
                            continue
                        try:
                            self._preempt_and_resume(
                                ctx, ticket, graph, trace_qid,
                                preempt_count, budget)
                            continue
                        except faults.QueryCancelledError:
                            raise
                        except Exception as e2:
                            # A fault mid-spill or mid-resume: the flag is
                            # honored; the new error enters the rungs
                            # below like any execution fault.
                            ticket.token.clear_preempt()
                            e = e2
                    # Rung 1: lineage-scoped stage recompute.
                    st = S.stage_for_error(graph, e)
                    if st is not None and stage_recomputes < stage_budget:
                        S.invalidate_stage(ctx, st)
                        S.record_recompute(ctx, st)
                        if qrun is not None:
                            # A remote stage's spool: its task requeues,
                            # so a worker rewrites it before the barrier.
                            qrun.recompute(st.stage_id)
                        stage_recomputes += 1
                        _LOG.warning(
                            "lost stage output (%s, recompute %d/%d); "
                            "recomputing only that stage: %s", st.name,
                            stage_recomputes, stage_budget, e)
                        continue
                    if not is_transient_error(e) or attempt >= max_retries:
                        raise e
                    delay_ms = backoff_delay_ms(attempt, base_ms, max_ms,
                                                seed)
                    faults.record("retriesAttempted")
                    if graph is not None and not same_ctx_retry_used:
                        # Rung 2: retry on the same context; completed
                        # stages serve their outputs.
                        same_ctx_retry_used = True
                        _LOG.warning(
                            "transient error (attempt %d/%d), retrying on "
                            "the same context in %.0f ms: %s", attempt + 1,
                            max_retries, delay_ms, e)
                        time.sleep(delay_ms / 1000.0)
                    else:
                        # Rung 3: the whole query on a fresh context.
                        _LOG.warning(
                            "transient error (attempt %d/%d), retrying the "
                            "query on a fresh context in %.0f ms: %s",
                            attempt + 1, max_retries, delay_ms, e)
                        time.sleep(delay_ms / 1000.0)
                        if qrun is not None:
                            qrun.reset()
                        ctx.close()
                        ctx = self._context(None, bindings, ticket)
                        ctx.cache["trace_query"] = trace_qid
                        if ticket is not None:
                            mgr.register_context(ticket, ctx)
                        if qrun is not None:
                            qrun.install(ctx)
                    query_metrics_entry(ctx, "Recovery").add(
                        "retriesAttempted", 1)
                    attempt += 1
        except BaseException as e:
            status, err_text = "error", f"{type(e).__name__}: {e}"
            raise
        finally:
            if ticket is not None:
                # Teardown accounting before the context closes: a cancel
                # against a deadline kill.
                if ticket.token.cancelled():
                    sched = SC.metrics_entry(ctx)
                    if ticket.token.reason == "deadline exceeded":
                        status = "deadline"
                        sched.add("deadlineKills", 1)
                        SC._record("deadlineKills")
                        monitoring.instant(
                            "query-deadline-killed", "recovery",
                            qid=trace_qid)
                    else:
                        status = "cancelled"
                        sched.add("cancelled", 1)
                        SC._record("cancelled")
                        monitoring.instant(
                            "query-cancelled", "recovery",
                            args={"reason": ticket.token.reason},
                            qid=trace_qid)
                faults.set_query_token(None)
                mgr.finish(ticket)
            if qrun is not None:
                # The dispatch state and the query's spool go before the
                # context closes: its cluster sessions are keep_on_close.
                qrun.finish()
            qos_class = ticket.qos_class if ticket is not None else None
            q_tenant = ticket.tenant if ticket is not None else None
            dur_ms = (time.perf_counter() - t0) * 1e3
            lbls = {"class": str(qos_class or "-"),
                    "tenant": str(q_tenant or "-")}
            monitoring.telemetry.inc("srt_queries", status=status, **lbls)
            monitoring.telemetry.observe("srt_query_latency_ms", dur_ms,
                                         **lbls)
            monitoring.history.log_query(
                self, ctx, query_id=trace_qid, status=status,
                qos_class=qos_class, tenant=q_tenant, duration_ms=dur_ms,
                error=err_text)
            self.last_ctx = ctx
            ctx.close()

    def _preempt_and_resume(self, ctx: ExecContext, ticket, graph,
                            trace_qid: int, count: int,
                            budget: int) -> None:
        """Rung 0's work (see ``_execute``): spill the query's catalog,
        wait until the device gate would grant its class a permit again,
        and count the suspension; the caller then re-collects on the same
        context."""
        from spark_rapids_tpu_torch import faults, monitoring
        from spark_rapids_tpu_torch.memory.stores import get_tpu_semaphore
        from spark_rapids_tpu_torch.parallel import scheduler as SC
        from spark_rapids_tpu_torch.parallel import stages as S
        faults.fault_point("preempt.spill")
        freed = 0
        if bool(self.conf.get(C.PREEMPTION_SPILL_ENABLED)) \
                and ctx._catalog is not None:
            # The victim vacates the card for the preemptor through the
            # OOM ladder's spill-all; its handles stay owned and page back
            # in when it resumes.
            freed = ctx._catalog.handle_oom()
        sched = SC.metrics_entry(ctx)
        sched.add("preemptions", 1)
        SC._record("preemptions")
        preemptor = ticket.token.preemptor_class
        monitoring.instant(
            "query-preempted", "recovery", qid=trace_qid,
            args={"preemptor": preemptor or "-", "spilledBytes": freed,
                  "count": count})
        monitoring.telemetry.inc(
            "srt_preemptions", **{"class": str(ticket.qos_class or "-")})
        _LOG.warning("query %d preempted by a %s query (%d/%d, spilled %d "
                     "bytes); resuming after the preemptor drains",
                     trace_qid, preemptor or "higher-priority", count,
                     budget, freed)
        sem = get_tpu_semaphore(
            max(int(self.conf.get(C.CONCURRENT_TPU_TASKS)), 1))
        t0 = time.perf_counter()
        # Blocks in class order until a permit would be ours again; the
        # token's cancel aborts the wait.
        sem.wait_resume(ticket.token)
        ticket.token.clear_preempt()
        preempted_ms = (time.perf_counter() - t0) * 1e3
        resumed = S.materialized_stage_count(ctx, graph)
        sched.add("preemptedMs", preempted_ms)
        sched.add("resumedStages", resumed)
        SC._record("preemptedMs", preempted_ms)
        SC._record("resumedStages", resumed)
        monitoring.instant(
            "query-resumed", "recovery", qid=trace_qid,
            args={"preemptedMs": round(preempted_ms, 2),
                  "resumedStages": resumed})
        faults.fault_point("preempt.resume")

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
    elif isinstance(e, (ShuffleExchangeExec, MeshExchangeExec)):
        part = e.partitioning
        detail = f" {type(part).__name__}({part.num_partitions})"
    elif isinstance(e, HashAggregateExec):
        detail = f" {e.mode} by {list(e.group_names)}"
    elif isinstance(e, InMemorySourceExec):
        detail = f" [{', '.join(n for n, _ in e.schema)}]"
    elif isinstance(e, FileScanExec):
        detail = f" {e.fmt} [{', '.join(n for n, _ in e.schema)}]"
    elif isinstance(e, (LocalLimitExec, GlobalLimitExec)):
        detail = f" {e.limit}"
    elif isinstance(e, FusedStageExec):
        detail = " [" + ", ".join(type(o).__name__ for o in e.ops) + "]"
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
        self._force_perfile = _uses_input_file(logical)
        meta = wrap_and_tag(logical, self.conf)
        # Cost-based placement (plan/cost.py): flip whole maximal
        # subtrees to the host engine where the footer-stats estimate
        # says the device's round trips cannot pay off. After tagging, so
        # capability fallbacks already shaped ``on_device``.
        cost_report = COST.apply_placement(meta, self.conf, self.device)
        if self.conf.explain in ("ALL", "NOT_ON_GPU"):
            print("\n".join(meta.explain_lines(
                not_on_device_only=self.conf.explain == "NOT_ON_GPU")))
        refused = [m for m in _walk(meta) if m.port_reasons]
        if refused:
            raise NotImplementedError(_refusal(refused))
        root, on_device = self._convert(meta)
        num_fused = 0
        if bool(self.conf.get(C.STAGE_FUSION_ENABLED)):
            root, num_fused = fuse_stages(root, on_device)
        phys = PhysicalPlan(root, on_device, meta, self.conf, num_fused,
                            cost_report=cost_report, device=self.device)
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
        """The conf's count where it sets one. Unset: with the mesh
        transport, the mesh's slot count (``mesh_exchange.mesh_size``),
        else one partition (the reference's single-device rule: on one
        device extra partitions only add per-partition round trips)."""
        if self.conf.raw.get(C.SHUFFLE_PARTITIONS.key) is not None:
            return int(self.conf.get(C.SHUFFLE_PARTITIONS))
        if self._mesh_enabled():
            return mesh_size()
        return 1

    def _mesh_enabled(self) -> bool:
        """The 'mesh' transport lowers hash shuffles to
        ``MeshExchangeExec``; every other transport plans the materialized
        exchange, which spools through it at run time."""
        from spark_rapids_tpu_torch.parallel import transport as T
        return T.transport_name(self.conf) == "mesh"

    def _hash_exchange(self, child: Exec, keys, n: int,
                       allow_coalesce: bool = False) -> Exec:
        """A hash shuffle: the collective mesh exchange under the mesh
        transport, else the materialized exchange; ``allow_coalesce``
        opts the latter into AQE-lite partition merging, safe for
        aggregate and window exchanges, never for co-partitioned join
        inputs."""
        part = HashPartitioning(keys, n)
        if self._mesh_enabled():
            return MeshExchangeExec(child, part)
        return ShuffleExchangeExec(child, part,
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
        bridged to this node's engine where the reference bridges. The
        exec carries its logical node's identity (``_logical_id``), which
        ``explain_analyze`` joins to the cost model's estimates."""
        exec_, dev = self._convert_node(meta)
        exec_._logical_id = id(meta.plan)
        return exec_, dev

    def _convert_node(self, meta: NodeMeta) -> Tuple[Exec, bool]:
        plan = meta.plan
        want_dev = meta.on_device
        kids = [self._convert(c) for c in meta.children]
        if isinstance(plan, L.InMemoryScan):
            return InMemorySourceExec(plan.schema, plan.partitions,
                                      device=self.device), want_dev
        if isinstance(plan, L.FileScan):
            return make_scan_exec(
                plan, self.conf,
                force_perfile=getattr(self, "_force_perfile", False),
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
        if isinstance(plan, L.LogicalCoGroupedMapInPandas):
            lch, rch = (self._bridge(k, kdev, want_dev) for k, kdev in kids)
            lch = self._pandas_group_exchange(
                lch, plan.children[0].schema, plan.left_keys, want_dev)
            rch = self._pandas_group_exchange(
                rch, plan.children[1].schema, plan.right_keys, want_dev)
            return CoGroupedMapInPandasExec(
                lch, rch, plan.left_keys, plan.right_keys, plan.fn,
                plan.out_schema), want_dev
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
                if self._mesh_enabled():
                    # The mesh exchange folds the requested count onto
                    # the mesh, so the fan-out is honored as asked.
                    return MeshExchangeExec(child, part), want_dev
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
        if isinstance(plan, L.LogicalGenerate):
            return GenerateExec(
                child, [resolve(c, plan.child.schema)
                        for c in plan.elements],
                position=plan.position, outer=plan.outer,
                element_name=plan.out_name,
                skip_nulls=plan.outer), want_dev
        if isinstance(plan, L.LogicalMapInPandas):
            return MapInPandasExec(child, plan.fn, plan.out_schema), want_dev
        if isinstance(plan, L.LogicalGroupedMapInPandas):
            child = self._pandas_group_exchange(child, plan.child.schema,
                                                plan.key_names, want_dev)
            return FlatMapGroupsInPandasExec(
                child, plan.key_names, plan.fn, plan.out_schema), want_dev
        if isinstance(plan, L.LogicalAggInPandas):
            child = self._pandas_group_exchange(child, plan.child.schema,
                                                plan.key_names, want_dev)
            return AggregateInPandasExec(child, plan.key_names,
                                         plan.aggs), want_dev
        raise NotImplementedError(f"cannot convert {plan.name}")

    def _pandas_group_exchange(self, child: Exec, schema, key_names,
                               want_dev: bool) -> Exec:
        """Co-partition a pandas-UDF child by its grouping keys so each
        partition holds whole groups (requiredChildDistribution of the
        grouped python execs). Host-engine children skip the exchange:
        their host halves read every partition and emit from the first."""
        if not want_dev:
            return child
        names = [n for n, _ in schema]
        keys = []
        for k in key_names:
            if k not in names:
                raise ResolutionError(f"unknown grouping key {k!r}")
            i = names.index(k)
            keys.append(BoundReference(i, schema[i][1]))
        return self._hash_exchange(child, keys, self._shuffle_partitions())

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
        final = self._two_stage(ex_group, ex_aggs, expand, want_dev,
                                allow_partial_skip=False)
        # Drop the grouping id from the output.
        out = [(n, BoundReference(i, e.data_type()))
               for i, (n, e) in enumerate(ex_group[:nk])]
        out += [(s.name, BoundReference(nk + 1 + i, s.fn.result_type))
                for i, s in enumerate(ex_aggs)]
        return ProjectExec(final, out)

    def _two_stage(self, group_by, aggs, child: Exec, want_dev: bool,
                   allow_partial_skip: bool = True) -> Exec:
        """partial -> exchange (hash on the keys, or a single partition
        for a zero-key aggregate) -> final. Grouping-set plans keep the
        partial pass unconditionally: the expand multiplies the rows
        N-fold, and the coarse levels reduce massively even where the
        finest does not, so skipping would shuffle the whole expansion."""
        partial = HashAggregateExec(child, group_by, aggs, mode="partial")
        partial.allow_partial_skip = allow_partial_skip
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
        shj = ShuffledHashJoinExec(self._hash_exchange(lch, lkeys, n),
                                   self._hash_exchange(rch, rkeys, n),
                                   lkeys, rkeys, plan.join_type, cond)
        # The planning-time build estimate, for the runtime re-plan's
        # estimate-against-observed error (parallel/replan.py).
        shj.est_build_bytes = est
        return shj


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
