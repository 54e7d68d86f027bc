"""Query flight recorder: structured trace spans + instant events (port
of the JAX package's ``monitoring/recorder.py``).

The reference stack wraps every GPU operator in an NVTX range
(NvtxWithMetrics.scala:21-44) so a profiler capture shows where a
query's time went. This recorder works WITHOUT an external profiler
attached: a bounded per-query ring buffer of

- **spans**: named intervals with a category, monotonic start/duration
  (``time.perf_counter_ns``), the recording thread, and the owning query
  id (resolved from the thread's ``faults.QueryToken``); and
- **instants**: point events for the things that are *decisions*, not
  durations: fault injected, OOM rung taken, grace join engaged,
  plan-cache hit or miss.

Spans are HOST time. CUDA launches are asynchronous, so on the card an
operator's span measures its dispatch; the device work it queued is
waited for inside the span that next synchronizes (``download``, or a
``sync`` span at ``kernel`` level, see ``syncs.py``).

Always cheap enough to leave on: the DISABLED path of :func:`span` /
:func:`instant` is one module-global load + a truthiness test returning
a shared no-op (no allocation, no lock, no clock read). Enabled, every
ring is a ``collections.deque(maxlen=trace.maxEvents)``, so a runaway
query keeps only a bounded window of its own history.

Config (process-global, last collect's conf wins, as the wire codec's):
``spark.rapids.sql.trace.enabled`` (``SRT_TRACE`` env override),
``spark.rapids.sql.trace.maxEvents``, ``spark.rapids.sql.trace.level``
(``query`` < ``operator`` < ``kernel``).

Consumers: ``DataFrame.trace_export`` renders Chrome trace-event JSON
(chrome.py: loads in Perfetto / chrome://tracing, one track per query
and per thread), ``DataFrame.explain_analyze`` joins the span stream
with per-operator metrics (analyze.py), and :func:`snapshot` aggregates
the span-category time breakdown.

Imports nothing beyond the standard library at module level: faults.py
emits instants from injection sites, and the query-id resolve lazily
imports faults at the first *enabled* record.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

# Verbosity levels: a span/instant records only when its level is at or
# below the configured one.
LEVEL_QUERY = 1      # query/stage lifecycle + every instant event
LEVEL_OPERATOR = 2   # + per-partition, per-operator, upload, shuffle
LEVEL_KERNEL = 3     # + per-batch wire encode/pack, sync attribution

_LEVEL_NAMES = {"query": LEVEL_QUERY, "operator": LEVEL_OPERATOR,
                "kernel": LEVEL_KERNEL}

# -- process-global state -----------------------------------------------------

# THE fast-path gate: the disabled span()/instant() path reads this one
# global and returns. Everything else hides behind it.
_ENABLED = False
_LEVEL = LEVEL_OPERATOR
_MAX_EVENTS = 65536
_MAX_QUERIES = 64           # oldest query rings evicted past this

_LOCK = threading.Lock()
# query id -> deque of event tuples, insertion-ordered so the oldest
# query is evicted first. Event tuples (kept flat for append cost):
#   ("X", name, cat, ts_ns, dur_ns, tid, qid, args_or_None)   span
#   ("i", name, cat, ts_ns, None,   tid, qid, args_or_None)   instant
_RINGS: "collections.OrderedDict[int, collections.deque]" = \
    collections.OrderedDict()
_THREAD_NAMES: Dict[int, str] = {}
_DROPPED: Dict[int, int] = {}       # per-query ring overflow count
_OPEN = itertools.count()           # spans entered
_CLOSED = itertools.count()         # spans exited (well-formedness probe)

# Epoch all timestamps are relative to (perf_counter_ns at import), so
# exported traces start near 0 instead of at an arbitrary boot offset.
_EPOCH_NS = time.perf_counter_ns()

_faults = None                      # lazily-bound port faults module

# Process identity for exported traces: empty by default; a process
# that tags itself (set_process_tag) names its tracks "<tag> query N",
# so traces of several processes stay attributable side by side.
_PROCESS_TAG = ""


def _now_ns() -> int:
    return time.perf_counter_ns() - _EPOCH_NS


def _current_query_id() -> int:
    """The recording thread's query id (the collect's minted token), or
    0 outside a query: events with no query share ring 0."""
    global _faults
    f = _faults
    if f is None:
        from spark_rapids_tpu_torch import faults as f
        globals()["_faults"] = f
    qid = f.current_query_id()
    return 0 if qid is None else qid


def _ring(qid: int) -> collections.deque:
    ring = _RINGS.get(qid)
    if ring is None:
        with _LOCK:
            ring = _RINGS.get(qid)
            if ring is None:
                ring = _RINGS[qid] = collections.deque(maxlen=_MAX_EVENTS)
                while len(_RINGS) > _MAX_QUERIES:
                    old, _ = _RINGS.popitem(last=False)
                    _DROPPED.pop(old, None)
    return ring


def _record(event: tuple, qid: int) -> None:
    ring = _ring(qid)
    if len(ring) == ring.maxlen:
        _DROPPED[qid] = _DROPPED.get(qid, 0) + 1
    ring.append(event)      # deque.append is atomic under the GIL
    tid = event[5]
    if tid not in _THREAD_NAMES:
        _THREAD_NAMES[tid] = threading.current_thread().name


# -- the recording API --------------------------------------------------------

class _NoopSpan:
    """Shared disabled span: __enter__/__exit__ do nothing. One instance
    for the whole process — the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "qid", "_t0")

    def __init__(self, name: str, cat: str, args, qid):
        self.name = name
        self.cat = cat
        self.args = args
        self.qid = qid

    def __enter__(self):
        next(_OPEN)
        self._t0 = _now_ns()
        return self

    def __exit__(self, *exc):
        t0 = self._t0
        dur = _now_ns() - t0
        qid = self.qid if self.qid is not None else _current_query_id()
        _record(("X", self.name, self.cat, t0, dur,
                 threading.get_ident(), qid, self.args), qid)
        next(_CLOSED)
        return False


def span(name: str, cat: str, level: int = LEVEL_OPERATOR,
         args: Optional[dict] = None, qid: Optional[int] = None):
    """A context manager recording one trace span. Disabled (or above
    the configured level) it returns the shared no-op — the caller's
    ``with`` costs two empty method calls and nothing else."""
    if not _ENABLED or level > _LEVEL:
        return _NOOP
    return _Span(name, cat, args, qid)


def now_ns() -> int:
    """Recorder-epoch-relative monotonic timestamp (for retro-recorded
    spans)."""
    return _now_ns()


def record_span(name: str, cat: str, t0_ns: int, dur_ns: int,
                qid: Optional[int] = None, args: Optional[dict] = None,
                level: int = LEVEL_OPERATOR) -> None:
    """Retro-record one completed span, for intervals measured before
    they are known to be worth recording (the plan cache's bind)."""
    if not _ENABLED or level > _LEVEL:
        return
    q = qid if qid is not None else _current_query_id()
    _record(("X", name, cat, t0_ns, max(int(dur_ns), 0),
             threading.get_ident(), q, args), q)


def instant(name: str, cat: str, args: Optional[dict] = None,
            qid: Optional[int] = None, level: int = LEVEL_QUERY) -> None:
    """Record one instant event (fault injected, OOM rung, grace join,
    plan-cache hit or miss). Instants default to LEVEL_QUERY: they are
    rare and they are the events the trace exists to explain."""
    if not _ENABLED or level > _LEVEL:
        return
    q = qid if qid is not None else _current_query_id()
    _record(("i", name, cat, _now_ns(), None,
             threading.get_ident(), q, args), q)


def set_process_tag(tag: str) -> None:
    """Name this process in exported traces. Affects rendering only,
    never recording."""
    global _PROCESS_TAG
    _PROCESS_TAG = str(tag)


def process_tag() -> str:
    return _PROCESS_TAG


def enabled() -> bool:
    return _ENABLED


def level() -> int:
    return _LEVEL


# -- configuration ------------------------------------------------------------

def trace_enabled(conf) -> bool:
    """Conf key wins; else the SRT_TRACE env; else the registered
    default (off)."""
    from spark_rapids_tpu_torch import config as C
    if conf.raw.get(C.TRACE_ENABLED.key) is not None:
        return bool(conf.get(C.TRACE_ENABLED))
    env = os.environ.get("SRT_TRACE")
    if env is not None:
        return env.strip() not in ("", "0", "false", "no")
    return bool(C.TRACE_ENABLED.default)


def maybe_configure(conf) -> None:
    """Adopt this query's trace configuration (process-global, last
    writer wins, as the wire codec's). Called once per collect before
    any span site runs."""
    global _ENABLED, _LEVEL, _MAX_EVENTS
    from spark_rapids_tpu_torch import config as C
    want = trace_enabled(conf)
    lvl = _LEVEL_NAMES.get(
        str(conf.get(C.TRACE_LEVEL)).strip().lower(), LEVEL_OPERATOR)
    max_events = max(int(conf.get(C.TRACE_MAX_EVENTS)), 256)
    if want == _ENABLED and lvl == _LEVEL and max_events == _MAX_EVENTS:
        return
    with _LOCK:
        _LEVEL = lvl
        if max_events != _MAX_EVENTS:
            _MAX_EVENTS = max_events    # existing rings keep their bound
        _ENABLED = want


def configure(enabled_: bool, level_: int = LEVEL_OPERATOR,
              max_events: int = 65536) -> None:
    """Direct (test/bench) configuration, bypassing the conf plumbing."""
    global _ENABLED, _LEVEL, _MAX_EVENTS
    with _LOCK:
        _LEVEL = int(level_)
        _MAX_EVENTS = max(int(max_events), 256)
        _ENABLED = bool(enabled_)


def reset() -> None:
    """Drop every recorded event (test isolation; keeps configuration)."""
    with _LOCK:
        _RINGS.clear()
        _THREAD_NAMES.clear()
        _DROPPED.clear()


# -- consumers ----------------------------------------------------------------

def events(query_id: Optional[int] = None) -> List[tuple]:
    """Recorded events — one query's ring, or every ring interleaved in
    timestamp order."""
    with _LOCK:
        if query_id is not None:
            ring = _RINGS.get(query_id)
            return list(ring) if ring is not None else []
        out: List[tuple] = []
        for ring in _RINGS.values():
            out.extend(ring)
    out.sort(key=lambda e: e[3])
    return out


def query_ids() -> List[int]:
    with _LOCK:
        return list(_RINGS.keys())


def thread_names() -> Dict[int, str]:
    with _LOCK:
        return dict(_THREAD_NAMES)


def open_span_count() -> int:
    """Spans entered minus spans exited: 0 when every begin got its end
    (the well-formedness probe the trace tests assert)."""
    # itertools.count has no read API; peek by advancing paired clones is
    # racy — instead derive from the repr ("count(N)").
    opened = int(repr(_OPEN)[6:-1])
    closed = int(repr(_CLOSED)[6:-1])
    return opened - closed


def snapshot() -> dict:
    """Aggregated process-wide view: per-category span time and counts,
    instant counts by name, per-query event totals: the at-a-glance
    answer to "where did the wall-clock go" without exporting a full
    timeline."""
    cats: Dict[str, Dict[str, float]] = {}
    instants: Dict[str, int] = {}
    queries: Dict[str, Dict[str, float]] = {}
    for e in events():
        ph, name, cat, ts, dur, tid, qid, args = e
        q = queries.setdefault(str(qid), {"events": 0, "spanMs": 0.0})
        q["events"] += 1
        if ph == "X":
            c = cats.setdefault(cat, {"spans": 0, "ms": 0.0})
            c["spans"] += 1
            c["ms"] += dur / 1e6
            q["spanMs"] += dur / 1e6
        else:
            instants[name] = instants.get(name, 0) + 1
    for c in cats.values():
        c["ms"] = round(c["ms"], 3)
    for q in queries.values():
        q["spanMs"] = round(q["spanMs"], 3)
    with _LOCK:
        dropped = sum(_DROPPED.values())
    return {
        "enabled": _ENABLED,
        "level": {v: k for k, v in _LEVEL_NAMES.items()}[_LEVEL],
        "maxEvents": _MAX_EVENTS,
        "categories": cats,
        "instants": instants,
        "queries": queries,
        "droppedEvents": dropped,
        "openSpans": open_span_count(),
    }


def category_breakdown() -> Dict[str, float]:
    """Span-category -> total ms, flat (queued / host-prefetch /
    device-compute / upload / shuffle / sync ...). Nested spans each
    count their own duration, so categories overlap and do not sum to
    the wall."""
    return {cat: agg["ms"]
            for cat, agg in snapshot()["categories"].items()}


def export_chrome(path: Optional[str] = None,
                  query_id: Optional[int] = None) -> dict:
    """Chrome trace-event JSON (loads in Perfetto / chrome://tracing):
    one process track per query, one thread track per worker thread.
    Writes ``path`` when given; returns the document either way."""
    from spark_rapids_tpu_torch.monitoring.chrome import to_chrome
    doc = to_chrome(events(query_id), thread_names(), _PROCESS_TAG)
    if path:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc
