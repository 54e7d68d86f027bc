"""Column pruning and the join-size estimate (port of the JAX package's
``plan/pruning.py``, cut to the nodes of plan/logical.py).

The planner runs ``prune_columns`` before tagging: it walks the logical
tree computing which column names each subtree must produce and drops
projections nothing above reads. In the reference it also narrows file
scans to the required fields; the port has no file scan yet, and an
in-memory scan keeps its whole width, as in the reference.
``pushdown_filters`` copies filter conjuncts onto file scans, so it is a
no-op here; it is kept so the pass order matches the reference's.

``estimate_bytes`` is the size estimate behind ``autoBroadcastJoinThreshold``:
it picks every join's strategy, so it equals the reference's to the byte.
"""

from __future__ import annotations

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


def pushdown_filters(plan: LogicalPlan) -> LogicalPlan:
    """Entry point: copy filter conjuncts onto the file scans they sit
    above. The port has no file scan, so every plan comes back as is."""
    return plan


def estimate_bytes(plan: LogicalPlan) -> Optional[int]:
    """Size-in-bytes estimate for join-strategy planning (the
    SizeInBytesOnlyStatsPlanVisitor analog feeding
    autoBroadcastJoinThreshold). An in-memory scan counts every value of
    every column it holds: at least 8 bytes a fixed-width value, a
    string's bytes plus 4 a row. Other nodes propagate conservatively
    (filters/aggregates keep their child's size, matching Spark's non-CBO
    stats). None = unknown (never broadcast on unknown)."""
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
                         L.LogicalAggregate, L.LogicalProject,
                         L.LogicalWindow)):
        return estimate_bytes(plan.child)
    if isinstance(plan, (L.LogicalUnion, L.LogicalJoin)):
        sizes = [estimate_bytes(c) for c in plan.children]
        if any(s is None for s in sizes):
            return None
        return sum(sizes)
    return None


def _prune(plan: LogicalPlan, required: Optional[Set[str]]) -> LogicalPlan:
    # required == None means "every column of this subtree's schema".
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
