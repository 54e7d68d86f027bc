"""Column pruning, filter pushdown and the join-size estimate (port of the
JAX package's ``plan/pruning.py``, cut to the nodes of plan/logical.py).

The planner runs ``prune_columns`` before tagging: it walks the logical
tree computing which column names each subtree must produce, drops
projections nothing above reads, and narrows each file scan's
``source_schema`` to the fields read (file order kept), so the scan
decodes only those columns (GpuParquetScan.scala:84 ``readDataSchema``).
An in-memory scan keeps its whole width, as in the reference.

``pushdown_filters`` then copies the simple conjuncts of a filter
directly above a file scan onto the scan (``(column, op, literal)``,
op in eq / lt / le / gt / ge / isnotnull), where they skip row groups
and stripes whose statistics prove no row matches; the filter itself
stays. The reference also pushes plan-cache bind slots, which the port
does not have.

The four pandas-UDF nodes pass through unpruned, as in the reference: a
pandas function sees its child's whole frame, so nothing below one is
pruned, and its size is unknown (``estimate_bytes`` gives None).

``estimate_bytes`` is the size estimate behind ``autoBroadcastJoinThreshold``:
it picks every join's strategy, so it equals the reference's to the byte
(a parquet scan: the exact uncompressed bytes of its pruned columns from
the footers), except above a generate: the port counts K times its child
(K output rows a row) where the reference knows no size (and never
broadcasts).
"""

from __future__ import annotations

import copy
import os
from typing import Optional, Set

from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.logical import Column, LogicalPlan


def refs_of(c: Column, out: Set[str]) -> Set[str]:
    """Collect column names referenced by an untyped Column AST."""
    node = c.node
    if node[0] == "ref":
        out.add(node[1])
        return out
    for x in node[1:]:
        if isinstance(x, Column):
            refs_of(x, out)
        elif isinstance(x, tuple):
            for y in x:
                if isinstance(y, Column):
                    refs_of(y, out)
                elif isinstance(y, tuple):
                    for z in y:
                        if isinstance(z, Column):
                            refs_of(z, out)
    return out


def prune_columns(plan: LogicalPlan) -> LogicalPlan:
    """Entry point: rewrite ``plan`` with unread projections dropped."""
    return _prune(plan, None)


_PUSH_OPS = {"eq": "eq", "lt": "lt", "le": "le", "gt": "gt", "ge": "ge"}
_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}


def _conjuncts(c: Column, out: list):
    if c.node[0] == "and":
        _conjuncts(c.node[1], out)
        _conjuncts(c.node[2], out)
    else:
        out.append(c)
    return out


def _as_predicate(c: Column):
    """(name, op, value) for a supported conjunct, else None. A plan-cache
    bind slot pushes as a ``BindValue`` marker the scan resolves against
    the execution's binding vector: stats skipping must see this call's
    literal, never the one the template was planned with."""
    from spark_rapids_tpu_torch.exprs.bindslots import BindValue
    node = c.node
    kind = node[0]
    if kind == "isnotnull" and node[1].node[0] == "ref":
        return (node[1].node[1], "isnotnull", None)
    if kind in _PUSH_OPS:
        left, right = node[1], node[2]
        if left.node[0] == "ref" and right.node[0] == "lit":
            return (left.node[1], kind, right.node[1])
        if left.node[0] == "lit" and right.node[0] == "ref":
            return (right.node[1], _FLIP[kind], left.node[1])
        if left.node[0] == "ref" and right.node[0] == "bindslot":
            return (left.node[1], kind, BindValue(right.node[1]))
        if left.node[0] == "bindslot" and right.node[0] == "ref":
            return (right.node[1], _FLIP[kind], BindValue(left.node[1]))
    return None


def pushdown_filters(plan: LogicalPlan) -> LogicalPlan:
    """Entry point: copy filter conjuncts onto the file scans they sit
    directly above."""
    if isinstance(plan, L.LogicalFilter) and \
            isinstance(plan.child, L.FileScan):
        preds = []
        for cj in _conjuncts(plan.condition, []):
            p = _as_predicate(cj)
            if p is not None:
                preds.append(p)
        if preds:
            scan = plan.child
            new_scan = L.FileScan(scan.fmt, scan.paths, scan.source_schema,
                                  scan.options,
                                  tuple(scan.predicates) + tuple(preds))
            return L.LogicalFilter(new_scan, plan.condition)
        return plan
    rebuilt = [pushdown_filters(c) for c in plan.children]
    if all(a is b for a, b in zip(rebuilt, plan.children)):
        return plan
    cp = copy.copy(plan)
    cp.children = tuple(rebuilt)
    return cp


def _file_scan_bytes(plan: L.FileScan) -> Optional[int]:
    """A parquet scan: the exact uncompressed bytes of its pruned columns
    from the footers (memoized); ORC and CSV: the files' sizes, times 3
    for ORC's typical compression."""
    if plan.fmt == "parquet":
        from spark_rapids_tpu_torch.io.scan import _parquet_metadata
        names = {n for n, _ in plan.source_schema}
        total = 0
        try:
            for path in plan.paths:
                md = _parquet_metadata(path)
                for rg in range(md.num_row_groups):
                    g = md.row_group(rg)
                    for ci in range(g.num_columns):
                        c = g.column(ci)
                        if c.path_in_schema.split(".")[0] in names:
                            total += c.total_uncompressed_size
        except OSError:
            return None
        return total
    if plan.fmt in ("orc", "csv"):
        try:
            raw = sum(os.path.getsize(p) for p in plan.paths)
        except OSError:
            return None
        return raw * (3 if plan.fmt == "orc" else 1)
    return None


def estimate_bytes(plan: LogicalPlan) -> Optional[int]:
    """Size-in-bytes estimate for join-strategy planning (the
    SizeInBytesOnlyStatsPlanVisitor analog feeding
    autoBroadcastJoinThreshold). A file scan reads its footers
    (``_file_scan_bytes``); an in-memory scan counts every value of
    every column it holds: at least 8 bytes a fixed-width value, a
    string's bytes plus 4 a row. Other nodes propagate conservatively
    (filters/aggregates keep their child's size, matching Spark's non-CBO
    stats). None = unknown (never broadcast on unknown)."""
    if isinstance(plan, L.FileScan):
        return _file_scan_bytes(plan)
    if isinstance(plan, L.InMemoryScan):
        total = 0
        for part in plan.partitions:
            for hb in part:
                for c in hb.columns:
                    if c.dtype.is_string:
                        if c.str_lengths is not None:
                            total += int(c.str_lengths.sum()) + \
                                4 * c.num_rows
                        else:
                            total += sum(
                                len(b) if b is not None else 0
                                for b in c.data) + 4 * c.num_rows
                    else:
                        total += c.num_rows * max(c.dtype.itemsize, 8)
        return total
    if isinstance(plan, L.LogicalRange):
        rows = max(0, -(-(plan.end - plan.start) // plan.step)) \
            if plan.step else 0
        return 8 * rows
    if isinstance(plan, (L.LogicalFilter, L.LogicalSort, L.LogicalLimit,
                         L.LogicalRepartition, L.LogicalAggregate,
                         L.LogicalProject, L.LogicalWindow)):
        return estimate_bytes(plan.child)
    if isinstance(plan, L.LogicalGenerate):
        child = estimate_bytes(plan.child)
        return None if child is None else child * len(plan.elements)
    if isinstance(plan, (L.LogicalUnion, L.LogicalJoin)):
        sizes = [estimate_bytes(c) for c in plan.children]
        if any(s is None for s in sizes):
            return None
        return sum(sizes)
    return None


def _prune(plan: LogicalPlan, required: Optional[Set[str]]) -> LogicalPlan:
    # required == None means "every column of this subtree's schema".
    if isinstance(plan, L.FileScan):
        if required is None:
            return plan
        kept = tuple(f for f in plan.source_schema if f[0] in required)
        if not kept or len(kept) == len(plan.source_schema):
            return plan
        return L.FileScan(plan.fmt, plan.paths, kept, plan.options,
                          plan.predicates)
    if isinstance(plan, (L.InMemoryScan, L.LogicalRange)):
        return plan
    if isinstance(plan, L.LogicalUnion):
        # Union children line up by position: pruning them on their own
        # could leave siblings with different schemas. Keep every column.
        return L.LogicalUnion(*[_prune(c, None) for c in plan.children])
    if isinstance(plan, L.LogicalFilter):
        child_req = None if required is None else \
            refs_of(plan.condition, set(required))
        return L.LogicalFilter(_prune(plan.child, child_req),
                               plan.condition)
    if isinstance(plan, L.LogicalProject):
        # Drop projections nothing above references (a with_column chain
        # passes every source column through; keeping them would defeat
        # scan pruning below), then require only what the kept ones read.
        projections = plan.projections
        if required is not None:
            kept = [(n, c) for n, c in projections if n in required]
            if kept:
                projections = kept
        child_req: Set[str] = set()
        for _, c in projections:
            refs_of(c, child_req)
        return L.LogicalProject(_prune(plan.child, child_req),
                                projections)
    if isinstance(plan, L.LogicalAggregate):
        child_req = set()
        for _, c in plan.group_by:
            refs_of(c, child_req)
        for _, c in plan.aggregates:
            refs_of(c, child_req)
        return L.LogicalAggregate(_prune(plan.child, child_req),
                                  plan.group_by, plan.aggregates,
                                  grouping=plan.grouping)
    if isinstance(plan, L.LogicalWindow):
        child_req = None
        if required is not None:
            child_req = set(required) - {n for n, _ in plan.exprs}
            for c in plan.window.partition_cols:
                refs_of(c, child_req)
            for o in plan.window.order_cols:
                inner = o.node[1] if o.node[0] == "sortorder" else o
                refs_of(inner, child_req)
            for _, fn_col in plan.exprs:
                node = fn_col.node
                if len(node) > 2 and isinstance(node[2], Column):
                    refs_of(node[2], child_req)
        return L.LogicalWindow(_prune(plan.child, child_req),
                               plan.exprs, plan.window)
    if isinstance(plan, L.LogicalGenerate):
        child_req = None
        if required is not None:
            child_req = set(required) - {plan.out_name,
                                         f"{plan.out_name}__pos"}
            for c in plan.elements:
                refs_of(c, child_req)
        return L.LogicalGenerate(_prune(plan.child, child_req),
                                 plan.out_name, plan.elements,
                                 plan.position, plan.outer)
    if isinstance(plan, L.LogicalSort):
        child_req = None
        if required is not None:
            child_req = set(required)
            for o in plan.orders:
                inner = o.node[1] if o.node[0] == "sortorder" else o
                refs_of(inner, child_req)
        return L.LogicalSort(_prune(plan.child, child_req), plan.orders)
    if isinstance(plan, L.LogicalLimit):
        return L.LogicalLimit(_prune(plan.child, required), plan.n)
    if isinstance(plan, L.LogicalRepartition):
        child_req = None
        if required is not None:
            child_req = set(required)
            for k in (plan.keys or []):
                refs_of(k, child_req)
        return L.LogicalRepartition(_prune(plan.child, child_req),
                                    plan.num_partitions, plan.keys)
    if isinstance(plan, L.LogicalJoin):
        left, right = plan.children
        if required is None:
            lreq = rreq = None
        else:
            needed = set(required)
            for k in plan.left_keys + plan.right_keys:
                refs_of(k, needed)
            if plan.condition is not None:
                refs_of(plan.condition, needed)
            lnames = {n for n, _ in left.schema}
            rnames = {n for n, _ in right.schema}
            lreq = needed & lnames
            rreq = needed & rnames
        return L.LogicalJoin(_prune(left, lreq), _prune(right, rreq),
                             plan.left_keys, plan.right_keys,
                             plan.join_type, plan.condition,
                             plan.strategy)
    return plan
