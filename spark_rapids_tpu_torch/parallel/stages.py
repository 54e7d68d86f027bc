"""Stage-graph recovery: lineage-scoped fault tolerance (port of the JAX
package's ``parallel/stages.py``).

Spark's resilience story is lineage: when a task's input shuffle data is
lost, only the stages that produced the lost partitions recompute, never
the whole job (Zaharia et al., RDDs, NSDI 2012). The port's per-query
materializations (an exchange's kept pieces, a broadcast's single) live
in the ``ExecContext``, so the same story falls out of two pieces:

1. A stage DAG over the physical plan. :func:`build_stage_graph` splits
   the exec tree at exchange boundaries (any exec with a
   ``stage_invalidate`` method is one). Each :class:`Stage` owns the
   operators between its boundary exchange and the next boundaries
   below; ``parents`` point at the stages whose durable outputs feed it,
   the lineage edges recovery walks.

2. Durable, invalidatable stage outputs. An exchange keeps its pieces as
   spillable catalog handles (``memory/stores.py``; CRC-framed once
   spilled to disk) and exposes ``stage_invalidate(ctx)`` to drop them.
   A re-run collect on the SAME context serves every still-cached
   materialization instead of recomputing it, so invalidate-one-stage +
   re-collect IS partition-scoped recovery: only the lost stage (and the
   never-materialized result stage above it) runs again; sibling stages'
   scans do not. A read that fails owner-tagged (``lostoutput`` with
   ``fault_owner``, a ``WireCorruptionError`` the exchange tagged) maps
   through :func:`stage_for_error` to the owning exchange's stage.

The same DAG drives the concurrent stage materialization
(``parallel/pipeline.py`` ``prematerialize_stages``): stages whose
parents are all materialized are independent, so their boundaries'
``stage_prematerialize`` hooks run at once.

The planner's recovery ladder (``plan/planner.py``) demotes through:
watchdog partition retry (``ops/base.py``) -> stage recompute (this
module) -> transient retry on the same context -> whole-query retry on a
fresh context. Every recompute counts ``stageRecomputes`` (and a
per-stage ``stageRecomputes.stage<N>``) through ``faults.record`` and the
query's ``Recovery@query``, with a ``stage-recompute`` instant.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

_LOG = logging.getLogger("spark_rapids_tpu_torch.stages")


def is_stage_boundary(op) -> bool:
    """An exec whose materialized output is a durable stage output: the
    shuffle and broadcast exchanges expose ``stage_invalidate``."""
    return callable(getattr(op, "stage_invalidate", None))


@dataclasses.dataclass
class Stage:
    """One stage: the subtree between a boundary exchange (whose
    materialization is this stage's output; None for the result stage)
    and the child boundaries feeding it."""

    stage_id: int
    boundary: Optional[object]
    ops: List[object] = dataclasses.field(default_factory=list)
    parents: List[int] = dataclasses.field(default_factory=list)

    @property
    def name(self) -> str:
        root = "result" if self.boundary is None else \
            type(self.boundary).__name__
        return f"Stage#{self.stage_id}<{root}>"


class StageGraph:
    """Stage DAG of one physical plan: stages keyed by id, and the
    exchange id -> stage index that maps a lost output back to the stage
    that owns it."""

    def __init__(self):
        self.stages: Dict[int, Stage] = {}
        self.by_exchange: Dict[int, int] = {}
        self.root_stage_id: int = 0

    def __len__(self) -> int:
        return len(self.stages)

    def stage_of_exchange(self, exchange_id: int) -> Optional[Stage]:
        sid = self.by_exchange.get(exchange_id)
        return None if sid is None else self.stages.get(sid)

    def pretty(self) -> str:
        lines = []
        for st in self.stages.values():
            members = ", ".join(type(o).__name__ for o in st.ops)
            lines.append(f"{st.name} parents={st.parents} [{members}]")
        return "\n".join(lines)


def build_stage_graph(root) -> StageGraph:
    """Split the physical plan at exchange boundaries into the stage DAG
    (Spark DAGScheduler's stage cut, applied to the exec tree)."""
    g = StageGraph()

    def new_stage(boundary) -> Stage:
        st = Stage(len(g.stages), boundary)
        g.stages[st.stage_id] = st
        if boundary is not None:
            g.by_exchange[id(boundary)] = st.stage_id
        return st

    def walk(op, stage: Stage):
        stage.ops.append(op)
        for ch in op.children:
            if is_stage_boundary(ch):
                child = new_stage(ch)
                stage.parents.append(child.stage_id)
                walk(ch, child)
            else:
                walk(ch, stage)

    result = new_stage(None)
    g.root_stage_id = result.stage_id
    if is_stage_boundary(root):
        # A plan rooted at an exchange: the result stage is empty and the
        # root exchange owns its own (recoverable) stage.
        child = new_stage(root)
        result.parents.append(child.stage_id)
        walk(root, child)
    else:
        walk(root, result)
    return g


def device_execs(root) -> List[object]:
    """The execs the device engine runs, children before parents: the
    root's region and every region below a ``DeviceToHostExec``, none
    below a ``HostToDeviceExec`` (the runtime re-plan and the concurrent
    stage pass act on these only)."""
    from spark_rapids_tpu_torch.ops.base import (DeviceToHostExec,
                                                 HostToDeviceExec)
    out: List[object] = []

    def walk(op, device: bool):
        if isinstance(op, DeviceToHostExec):
            kid = True
        elif isinstance(op, HostToDeviceExec):
            kid = False
        else:
            kid = device
        for c in op.children:
            walk(c, kid)
        if device:
            out.append(op)

    walk(root, True)
    return out


def stage_for_error(graph: Optional[StageGraph], e) -> Optional[Stage]:
    """The stage whose durable output the failure lost. Only errors
    tagged with a ``fault_owner`` (the owning exchange's id, set by the
    injection site and by the exchange on a failed checksum) are
    attributable; anything else is a root or unattributable loss and the
    caller falls back to the query retry."""
    if graph is None:
        return None
    owner = getattr(e, "fault_owner", None)
    if owner is None:
        return None
    return graph.stage_of_exchange(owner)


def invalidate_stage(ctx, stage: Stage) -> None:
    """Drop the stage's durable output from the context (cache entries
    and catalog registrations), so the next execution recomputes it from
    its parents' still-materialized outputs."""
    if stage.boundary is not None:
        stage.boundary.stage_invalidate(ctx)
    _LOG.warning("lineage recovery: invalidated %s; recomputing it from "
                 "its parent stages on the next attempt", stage.name)


def record_recompute(ctx, stage: Stage) -> None:
    """Count one stage recompute: the process-global counter, its
    per-stage detail, the query's ``Recovery@query`` and a
    ``stage-recompute`` instant on the flight recorder."""
    from spark_rapids_tpu_torch import faults, monitoring
    from spark_rapids_tpu_torch.ops.base import query_metrics_entry
    faults.record("stageRecomputes")
    faults.record(f"stageRecomputes.stage{stage.stage_id}")
    query_metrics_entry(ctx, "Recovery").add("stageRecomputes", 1)
    monitoring.instant("stage-recompute", "recovery",
                       args={"stage": stage.name})


def materialized_stage_count(ctx, graph: Optional[StageGraph]) -> int:
    """How many boundary stages hold a materialized output in ``ctx``
    right now. A preempted query reads it when it resumes
    (``plan/planner.py``): every stage counted here serves its
    materialization instead of recomputing (``resumedStages``)."""
    if graph is None or ctx is None:
        return 0
    n = 0
    for st in graph.stages.values():
        b = st.boundary
        if b is None:
            continue                    # the result stage is never kept
        if any(b._cache_key(dev) in ctx.cache for dev in (True, False)):
            n += 1
    return n
