"""Stage fusion over the physical plan (port of the JAX package's
``plan/fusion.py``; the planner side of ``ops/fused.py``).

Walks the converted exec tree tracking which engine each region runs on
(the host <-> device bridges flip it) and collapses every maximal run of
two or more contiguous fusible DEVICE operators into one
``FusedStageExec``.

Fusible: Project / Filter / LocalLimit / Expand whose expressions make no
host roundtrip (``jittable``: no regexp, string cast, LIKE with ``_``,
python UDF) and need no EvalContext (no rand / spark_partition_id /
monotonically_increasing_id / input_file_name, which rely on the
per-batch context the unfused operator threads). Everything else
(exchanges, aggregates, sorts, joins, windows, generate, scans, bridges)
breaks the stage.

The pass rewires only stage boundaries: member execs keep their original
child links, so the host path and the fusion-off plan shape stay exactly
as converted.
"""

from __future__ import annotations

from typing import List, Tuple

from spark_rapids_tpu_torch.exprs.nondeterministic import needs_eval_context
from spark_rapids_tpu_torch.ops.base import (
    DeviceToHostExec, Exec, HostToDeviceExec)
from spark_rapids_tpu_torch.ops.basic import (
    ExpandExec, FilterExec, LocalLimitExec, ProjectExec)
from spark_rapids_tpu_torch.ops.fused import FusedStageExec


def _member_exprs(op: Exec):
    if isinstance(op, ProjectExec):
        return list(op.exprs)
    if isinstance(op, FilterExec):
        return [op.condition]
    if isinstance(op, LocalLimitExec):
        return []
    if isinstance(op, ExpandExec):
        return [e for proj in op.projections for e in proj]
    return None


def fusible(op: Exec) -> bool:
    """True when ``op`` can join a fused device stage."""
    exprs = _member_exprs(op)
    if exprs is None or len(op.children) != 1:
        return False
    return all(e.jittable for e in exprs) and not needs_eval_context(exprs)


def fuse_stages(root: Exec, root_on_device: bool) -> Tuple[Exec, int]:
    """Rewrite ``root`` in place, returning (new root, stages fused)."""
    fused_count = [0]

    def rec(op: Exec, device: bool) -> Exec:
        if isinstance(op, DeviceToHostExec):
            child_device = [True]
        elif isinstance(op, HostToDeviceExec):
            child_device = [False]
        else:
            child_device = [device] * len(op.children)
        if device and fusible(op):
            run: List[Exec] = [op]          # outermost first
            while fusible(run[-1].children[0]):
                run.append(run[-1].children[0])
            if len(run) >= 2:
                below = rec(run[-1].children[0], device)
                run[-1].children = (below,)
                fused_count[0] += 1
                return FusedStageExec(list(reversed(run)), below)
        op.children = tuple(rec(c, d)
                            for c, d in zip(op.children, child_device))
        return op

    return rec(root, root_on_device), fused_count[0]


def collect_fused(root: Exec) -> List[FusedStageExec]:
    """Every fused stage of the plan, outermost first (for explain)."""
    out: List[FusedStageExec] = []

    def rec(op: Exec):
        if isinstance(op, FusedStageExec):
            out.append(op)
        for c in op.children:
            rec(c)

    rec(root)
    return out
