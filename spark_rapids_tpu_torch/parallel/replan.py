"""Runtime adaptive re-planning (port of the JAX package's
``parallel/replan.py``).

The planner picks a join's strategy from ESTIMATES
(``autoBroadcastJoinThreshold`` over footer and in-memory estimates);
this module re-plans mid-query from the exact materialized sizes, as the
reference's GpuCustomShuffleReaderExec.scala:132 reader rebuilds the rest
of the plan once a shuffle's map output statistics exist.

Flow (driven from the device collect, ``ops/base.py`` ``run_batches``,
before the concurrent stage pass):

1. Walk the plan's device regions for shuffled hash joins whose two
   inputs are shuffle exchanges (stage boundaries,
   ``parallel/stages.py``), bottom-up so inner joins decide first; a full
   outer join never demotes.
2. For each, materialize ONLY the build-side exchange and read its
   observed bytes (``ShuffleExchangeExec.observed_total_bytes``: the kept
   pieces' device bytes).
3. When they fit ``autoBroadcastJoinThreshold``, the join DEMOTES to a
   broadcast hash join: a rewritten subtree whose build input is the
   already-materialized exchange (its partitions read in turn into one
   build side) and whose probe input is the probe exchange's CHILD, so
   the probe side never shuffles. The fusion pass (``plan/fusion.py``)
   re-runs over the rewritten subtree, and the skipped probe exchange is
   flagged (``replan-skip:``) so the stage pass does not shuffle it
   anyway.
4. Decisions are per query (kept in ``ctx.cache``): the cached physical
   plan is untouched, the host engine never sees them, and stage
   recovery still maps a lost build piece to the ORIGINAL exchange's
   stage; a recompute after ``stage_invalidate`` re-reads the decision
   from the cache.

Two guards the reference does not have (ROADMAP queue C):

- A join whose exchanges plan ONE partition is no candidate. Its
  shuffled join already builds one side once and probes the other as one
  coalesced partition; the broadcast join would probe the probe side's
  unshuffled input partition by partition instead (at SF1 on an H100,
  q4 and q18 ran about 2.1x slower warm demoted; PERF.md).
- The re-plan never makes a build the memory tier could not hold. A
  build side above ``join.grace.buildFraction`` of the catalog's device
  budget keeps its shuffled join, whose partitions can take the grace
  path (a broadcast join has no grace rung); and a build exchange whose
  materialization exhausts the OOM ladder (``OomRetryExhausted``) keeps
  the static plan, which materializes it again as its own stage (so
  does a device OOM that no rung could act on).
  ``replanBudgetKeeps`` and ``replanOomKeeps`` count them.

Counters land in the query's ``Cost@query`` entry: ``replanChecks``,
``joinDemotions``, ``replanObservedBytes``, ``estimateErrorPct`` and
``replanRefusions``, which holds, as the reference's does, the second
value ``fuse_stages`` returns: the number of stages fused over the
delegate, not of refusals. ``replanChecks`` and ``joinDemotions`` also
count into the process-global cost counters (``plan/cost.py``
``counters()``), as the reference's do.
"""

from __future__ import annotations

import logging
import traceback
from typing import List

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.memory import oom
from spark_rapids_tpu_torch.plan import cost as COST

_LOG = logging.getLogger("spark_rapids_tpu_torch.replan")


def _metrics(ctx):
    from spark_rapids_tpu_torch.ops.base import query_metrics_entry
    return query_metrics_entry(ctx, "Cost")


def decision_key(join) -> str:
    return f"replan:{id(join):x}"


def _candidates(root) -> List[object]:
    """Every shuffled hash join over two shuffle exchanges, bottom-up
    (inner joins first), in device regions only: host regions run the
    host engine as planned."""
    from spark_rapids_tpu_torch.ops.join import ShuffledHashJoinExec
    from spark_rapids_tpu_torch.parallel.exchange import ShuffleExchangeExec
    from spark_rapids_tpu_torch.parallel.stages import device_execs
    return [op for op in device_execs(root)
            if type(op) is ShuffledHashJoinExec and op.join_type != "full"
            and all(isinstance(c, ShuffleExchangeExec)
                    and c.partitioning.num_partitions > 1
                    for c in op.children)]


def plan_adaptive(ctx, root) -> None:
    """Decide this query's demotions. Idempotent per context: a re-run
    after a stage recompute reuses the cached decisions."""
    if ctx.cache.get("engine") != "device":
        return
    if not bool(ctx.conf.get(C.AQE_REPLAN)):
        return
    threshold = int(ctx.conf.get(C.AUTO_BROADCAST_THRESHOLD))
    if threshold < 0:       # Spark semantics: -1 disables auto-broadcast
        return
    for join in _candidates(root):
        key = decision_key(join)
        if key in ctx.cache:
            continue
        m = _metrics(ctx)
        m.add("replanChecks", 1)
        COST._record("replanChecks")
        build_right = join.join_type != "right"
        build_ex = join.children[1] if build_right else join.children[0]
        probe_ex = join.children[0] if build_right else join.children[1]
        try:
            observed = build_ex.observed_total_bytes(ctx)
        except Exception as e:
            # An exhausted ladder, or an OOM no rung could act on. The
            # exchange closed what it had kept; the static plan
            # materializes it again as its own stage.
            if not (isinstance(e, oom.OomRetryExhausted)
                    or oom.is_oom_error(e)):
                raise
            traceback.clear_frames(e.__traceback__)
            ctx.cache[key] = None
            m.add("replanOomKeeps", 1)
            _LOG.warning("runtime re-plan: %s keeps its shuffled join "
                         "(its build exchange ran out of device memory: "
                         "%s)", join.name, e)
            continue
        m.add("replanObservedBytes", observed)
        est = getattr(join, "est_build_bytes", None)
        if est is not None and observed > 0:
            m.add("estimateErrorPct",
                  abs(est - observed) * 100.0 / observed)
        if observed > threshold:
            ctx.cache[key] = None
            continue
        if observed > ctx.catalog.device_budget * float(
                ctx.conf.get(C.JOIN_GRACE_BUILD_FRACTION)):
            ctx.cache[key] = None
            m.add("replanBudgetKeeps", 1)
            continue
        delegate = _demote(ctx, join, build_ex, probe_ex, build_right)
        ctx.cache[key] = delegate
        ctx.cache[f"replan-skip:{id(probe_ex):x}"] = True
        m.add("joinDemotions", 1)
        COST._record("joinDemotions")
        from spark_rapids_tpu_torch import monitoring
        monitoring.instant(
            "join-demotion", "replan",
            args={"join": join.name, "observedBytes": observed,
                  "threshold": threshold})
        _LOG.info(
            "runtime re-plan: demoting %s to broadcast (observed build "
            "side %d bytes <= threshold %d; probe shuffle skipped)",
            join.name, observed, threshold)


def _demote(ctx, join, build_ex, probe_ex, build_right: bool):
    """The rewritten subtree of one demotion: a ``BroadcastHashJoinExec``
    whose build child is the already-materialized exchange and whose
    probe child is the probe exchange's unshuffled input. Keys and
    condition carry over: neither side's schema changes."""
    from spark_rapids_tpu_torch.ops.join import BroadcastHashJoinExec
    probe_child = probe_ex.children[0]
    if build_right:
        left, right = probe_child, build_ex
    else:
        left, right = build_ex, probe_child
    delegate = BroadcastHashJoinExec(
        left, right, join.left_keys, join.right_keys, join.join_type,
        join.condition)
    # The fusion pass over the rewritten subtree: fused runs below are
    # fixed points, so it fuses only shapes the exchange's removal newly
    # exposed.
    if bool(ctx.conf.get(C.STAGE_FUSION_ENABLED)):
        from spark_rapids_tpu_torch.plan.fusion import fuse_stages
        delegate, fused = fuse_stages(delegate, True)
        if fused:
            _metrics(ctx).add("replanRefusions", fused)
    return delegate


def demoted(ctx, join):
    """The delegate for ``join`` in this query, or None (no demotion, no
    re-plan ran, or the host engine)."""
    return ctx.cache.get(decision_key(join))
