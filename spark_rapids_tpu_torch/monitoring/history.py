"""Persistent per-query event log, the history-server analog (port of
the JAX package's ``monitoring/history.py``; the fleet records wait for
the cluster runtime).

The registry (telemetry.py) answers "what is the process doing NOW";
this module answers "what did query N do last Tuesday". At query
teardown (``PhysicalPlan.collect``, before the context closes) one JSONL
record per query is appended under ``spark.rapids.sql.eventLog.dir``
(``SRT_EVENT_LOG`` env override; empty = off, the default):

- identity: wall-clock ts, query id, status, duration;
- plan: structural fingerprint, provenance (plan-cache hit / fresh),
  bind slot values and dtypes;
- per-node observed rows/batches/wall in deterministic DFS preorder;
- the flight recorder's span-category breakdown and instant events
  (fault injected, OOM rung, grace join) of this query's ring, verbatim;
- the final per-query metrics entries (operator + audit groups).

:func:`read_events` and :func:`render_report` rebuild
``explain_analyze``-style node reports from these records alone, after
the process that ran the queries has exited.

Imports nothing beyond the standard library; append-only, one file per
process (``events-<pid>.jsonl``) so processes sharing a directory never
interleave partial lines.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

SCHEMA_VERSION = 1

_LOCK = threading.Lock()
_DIR = ""


# -- configuration ------------------------------------------------------------

def event_log_dir(conf=None) -> str:
    """Conf key wins; else the SRT_EVENT_LOG env; else the registered
    default (empty = off)."""
    from spark_rapids_tpu_torch import config as C
    if conf is not None and conf.raw.get(C.EVENT_LOG_DIR.key) is not None:
        return str(conf.get(C.EVENT_LOG_DIR)).strip()
    env = os.environ.get("SRT_EVENT_LOG")
    if env is not None:
        return env.strip()
    return str(C.EVENT_LOG_DIR.default or "").strip()


def maybe_configure(conf) -> None:
    """Adopt this query's event-log directory (process-global, last
    writer wins, as the wire codec's)."""
    global _DIR
    d = event_log_dir(conf)
    if d != _DIR:
        _DIR = d


def set_dir(d: str) -> None:
    """Direct (test/bench) configuration, bypassing the conf plumbing."""
    global _DIR
    _DIR = str(d or "").strip()


def log_dir() -> str:
    return _DIR


# -- record construction ------------------------------------------------------

def plan_fingerprint(phys) -> str:
    """Stable structural fingerprint of the physical tree (matches
    across processes executing the same plan shape)."""
    import hashlib
    shape = phys.tree()
    return hashlib.sha256(shape.encode()).hexdigest()[:16]


def node_stats(root, ctx) -> List[dict]:
    """Per-node observed metrics in deterministic DFS preorder: the node
    indexing shared by the event log and the post-hoc report renderer.
    ``idx`` is the preorder ordinal, so two processes walking the same
    plan agree on it."""
    out: List[dict] = []

    def walk(op, depth):
        idx = len(out)
        m = ctx.metrics.get(f"{op.name}@{id(op):x}") if ctx is not None \
            else None
        vals = dict(m.values) if m is not None else {}
        rows = vals.get("numOutputRows")
        nbytes = vals.get("numOutputBytes")
        wall_ns = vals.get("totalTime", 0.0) + vals.get("bufferTime", 0.0)
        out.append({
            "idx": idx, "depth": depth, "name": op.name,
            "rows": int(rows) if rows is not None else None,
            "bytes": int(nbytes) if nbytes is not None else None,
            "batches": int(vals.get("numOutputBatches", 0)),
            "wall_ms": round(wall_ns / 1e6, 3),
        })
        for c in op.children:
            walk(c, depth + 1)

    walk(root, 0)
    return out


def _json_safe(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


def build_record(phys, ctx, *, query_id: int, status: str,
                 qos_class: Optional[str], tenant: Optional[str],
                 duration_ms: float, error: Optional[str] = None) -> dict:
    """One query's event-log record (also the in-memory shape tests
    assert against before the JSONL round trip)."""
    import time
    from spark_rapids_tpu_torch.monitoring import recorder

    binds = []
    if ctx is not None and "plan_binds" in ctx.cache:
        values = ctx.cache.get("plan_binds") or ()
        dtypes = ctx.cache.get("plan_bind_dtypes") or ()
        for i, v in enumerate(values):
            dt = dtypes[i] if i < len(dtypes) else None
            binds.append({"slot": i, "value": _json_safe(v),
                          "dtype": str(dt) if dt is not None else None})

    categories: Dict[str, float] = {}
    instants: List[list] = []
    if recorder.enabled():
        for e in recorder.events(query_id):
            ph, name, cat, ts, dur, tid, qid, args = e
            if ph == "X":
                categories[cat] = categories.get(cat, 0.0) + dur / 1e6
            else:
                instants.append([name, cat, ts, _json_safe(args)])
        categories = {c: round(ms, 3) for c, ms in categories.items()}

    metrics = {}
    if ctx is not None:
        for key, m in ctx.metrics.items():
            if m.values:
                metrics[key] = {k: float(v) for k, v in m.values.items()}

    return {
        "v": SCHEMA_VERSION,
        "ts": time.time(),
        "query_id": int(query_id),
        "status": status,
        "class": qos_class,
        "tenant": tenant,
        "duration_ms": round(float(duration_ms), 3),
        "plan_fingerprint": plan_fingerprint(phys),
        "provenance": getattr(phys, "provenance", None),
        "bind_slots": binds,
        "nodes": node_stats(phys.root, ctx),
        "categories": categories,
        "instants": instants,
        "metrics": metrics,
        "error": error,
    }


def log_query(phys, ctx, *, query_id: int, status: str,
              qos_class: Optional[str], tenant: Optional[str],
              duration_ms: float, error: Optional[str] = None) -> None:
    """Append one query record to the event log (no-op when the dir is
    unset; never fails a query)."""
    d = _DIR
    if not d:
        return
    try:
        rec = build_record(phys, ctx, query_id=query_id, status=status,
                           qos_class=qos_class, tenant=tenant,
                           duration_ms=duration_ms, error=error)
        line = json.dumps(rec, sort_keys=True)
        path = os.path.join(d, f"events-{os.getpid()}.jsonl")
        with _LOCK:
            os.makedirs(d, exist_ok=True)
            with open(path, "a") as f:
                f.write(line + "\n")
    except Exception:
        import logging
        logging.getLogger("spark_rapids_tpu_torch").warning(
            "event-log write failed", exc_info=True)


# -- readers (the history-server side) ----------------------------------------

def read_events(path: str) -> List[dict]:
    """Load records from one ``.jsonl`` file or every ``events-*.jsonl``
    under a directory, oldest first; torn trailing lines are skipped."""
    files: List[str] = []
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if name.endswith(".jsonl"):
                files.append(os.path.join(path, name))
    elif os.path.exists(path):
        files.append(path)
    out: List[dict] = []
    for fp in files:
        with open(fp) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    out.sort(key=lambda r: r.get("ts", 0.0))
    return out


def render_report(rec: dict) -> str:
    """``explain_analyze``-style node report reconstructed from one
    event-log record alone — no live context, no live process."""
    lines = [
        f"query {rec.get('query_id')} [{rec.get('status')}] "
        f"class={rec.get('class') or '-'} tenant={rec.get('tenant') or '-'} "
        f"wall={rec.get('duration_ms', 0.0):.1f}ms "
        f"plan={rec.get('plan_fingerprint')}"
    ]
    prov = rec.get("provenance")
    if prov:
        lines.append(f"provenance: {prov}")
    if rec.get("bind_slots"):
        body = ", ".join(f"${b['slot']}={b['value']!r}"
                         for b in rec["bind_slots"])
        lines.append(f"bind slots: {body}")
    for n in rec.get("nodes", []):
        rows = f"{n['rows']:,}" if n.get("rows") is not None else "?"
        nbytes = f"{n['bytes']:,}B" if n.get("bytes") is not None else "?"
        parts = [f"rows={rows}", f"bytes={nbytes}",
                 f"wall={n.get('wall_ms', 0.0):.1f}ms"]
        if n.get("batches"):
            parts.append(f"batches={n['batches']}")
        lines.append("  " * n.get("depth", 0) + f"{n['name']}  "
                     + " ".join(parts))
    cats = rec.get("categories") or {}
    if cats:
        body = ", ".join(f"{c}={ms:.1f}ms" for c, ms in sorted(cats.items()))
        lines.append(f"trace: {body}")
    for name, cat, ts, args in rec.get("instants") or []:
        suffix = f" {args}" if args else ""
        lines.append(f"instant [{cat}] {name}{suffix}")
    if rec.get("error"):
        lines.append(f"error: {rec['error']}")
    return "\n".join(lines)
