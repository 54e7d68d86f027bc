"""``DataFrame.explain_analyze``: the plan tree annotated with OBSERVED
per-operator numbers beside the cost model's ESTIMATES (port of the JAX
package's ``monitoring/analyze.py``).

``explain`` answers "what will run where"; this answers "what actually
happened, and how wrong was the model". Per physical node:

- observed: rows (where a host-known row count exists: scans,
  projections, exchange serves; ``?`` where counting would cost a device
  sync), bytes, wall-ms (the operator's ``totalTime`` plus a scan's
  ``bufferTime``), batches;
- estimated: the cost model's subtree device estimate (ms, sync count,
  bytes; ``plan/cost.py``) for the logical node the physical node was
  converted from (``_logical_id``), with the subtree's observed wall and
  the signed error percentage. A plan the model cannot estimate renders
  observed-only.

On the card the walls are host time: an operator's ``totalTime`` is its
dispatch, and the device work it queued is waited for where the next
sync happens (the download, or an operator's own sizes pull).

The footer aggregates the audit entries (Recovery@query, Cost@query,
Pipeline@query, Transport@query) and, when the flight recorder is on,
the span-category time breakdown of the query's ring.
"""

from __future__ import annotations

from typing import Dict, List


def _fmt_ms(ns: float) -> str:
    return f"{ns / 1e6:.1f}ms"


def _fmt_bytes(n) -> str:
    return "?" if n is None else f"{int(n):,}B"


def _node_metrics(ctx, op) -> dict:
    if ctx is None:
        return {}
    m = ctx.metrics.get(f"{op.name}@{id(op):x}")
    return dict(m.values) if m is not None else {}


def _wall_ns(vals: dict) -> float:
    # Scans meter their host decode+upload as bufferTime, operators
    # their dispatch as totalTime; a node's wall is whichever it pays.
    return vals.get("totalTime", 0.0) + vals.get("bufferTime", 0.0)


def _subtree_wall_ns(ctx, op) -> float:
    total = _wall_ns(_node_metrics(ctx, op))
    return total + sum(_subtree_wall_ns(ctx, c) for c in op.children)


def render(phys, ctx) -> str:
    """Render the analyzed plan tree for one executed PhysicalPlan."""
    from spark_rapids_tpu_torch.plan import cost as COST
    from spark_rapids_tpu_torch.plan.logical import NotPortedError
    try:
        ests = COST.estimate_plan(phys.meta.plan, phys.conf,
                                  device=getattr(phys, "device", None))
    except (NotPortedError, OSError, ValueError):
        ests = {}   # no footer stats or an unresolvable node: observed-only
    lines: List[str] = []

    def walk(op, depth: int):
        vals = _node_metrics(ctx, op)
        rows = vals.get("numOutputRows")
        nbytes = vals.get("numOutputBytes")
        parts = [
            f"rows={int(rows):,}" if rows is not None else "rows=?",
            f"bytes={_fmt_bytes(nbytes)}",
            f"wall={_fmt_ms(_wall_ns(vals))}",
        ]
        batches = vals.get("numOutputBatches")
        if batches:
            parts.append(f"batches={int(batches)}")
        est = ests.get(getattr(op, "_logical_id", -1))
        if est is not None:
            obs_ms = _subtree_wall_ns(ctx, op) / 1e6
            est_ms = est.device_ms
            err = ""
            if est_ms > 0:
                err = f" err={100.0 * (obs_ms - est_ms) / est_ms:+.0f}%"
            parts.append(
                f"| est {est_ms:.0f}ms/{est.syncs} syncs "
                f"~{_fmt_bytes(est.bytes_out)} obs {obs_ms:.1f}ms{err}")
        lines.append("  " * depth + f"{op.name}  " + " ".join(parts))
        for c in op.children:
            walk(c, depth + 1)

    walk(phys.root, 0)

    # Footer: the per-query audit entries + the trace's category
    # breakdown ("where did the wall-clock go", one line per category).
    if ctx is not None:
        from spark_rapids_tpu_torch.ops.base import audit_metric_groups
        audits = {k: m for k, m in ctx.metrics.items()
                  if m.owner in audit_metric_groups() and m.values}
        for key in sorted(audits):
            vals = audits[key].values
            body = ", ".join(
                f"{n}={v:.0f}" if float(v).is_integer() else f"{n}={v:.2f}"
                for n, v in sorted(vals.items()))
            lines.append(f"{key}: {body}")
        qid = ctx.cache.get("trace_query")
        if qid is not None:
            from spark_rapids_tpu_torch.monitoring import recorder
            cats: Dict[str, float] = {}
            syncs = 0
            for e in recorder.events(qid):
                if e[0] == "X":
                    cats[e[2]] = cats.get(e[2], 0.0) + e[4] / 1e6
                    if e[2] == "sync":
                        syncs += 1
            if cats:
                body = ", ".join(f"{c}={ms:.1f}ms"
                                 for c, ms in sorted(cats.items()))
                lines.append(f"Trace@query {qid}: {body}"
                             + (f", syncs={syncs}" if syncs else ""))
    return "\n".join(lines)
