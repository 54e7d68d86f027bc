"""Deterministic fault-injection registry and the per-thread query token
(port of the JAX package's ``faults.py``).

Recovery code that is never exercised cannot be trusted, so every
dispatch funnel of the port is an injection site: tests and
``chip_smoke.py`` run real queries under seeded fault schedules and
check that the rows stay bit-identical to the fault-free run.

Spec grammar (``spark.rapids.sql.test.faults`` config or ``SRT_FAULTS``
env)::

    kind@site[/query=N][:arg][,kind@site[/query=N][:arg]...]

- ``kind``: ``oom`` (a synthetic device allocation failure, recovered by
  the OOM escalation ladder, ``memory/oom.py``), ``corrupt`` (flips one
  byte of a serialized spill frame; detected by the CRC32 frame checksum
  and re-read), ``transient`` (a synthetic UNAVAILABLE, recovered by the
  planner's retry ladder), ``lostoutput`` (a lost stage output at an
  exchange site, recovered by the stage recompute,
  ``parallel/stages.py``), ``stall`` (a bounded hang, then
  :class:`InjectedStallError`, killed and re-dispatched by the
  execution watchdog, ``ops/base.py``), the shuffle transports' kinds
  (``lostshard`` at ``transport``: a fetched shard deleted at rest and an
  owner-tagged loss, recovered by the stage recompute; ``slowput`` at
  ``transport``: a delayed object-store write; ``unavailable`` at
  ``objectstore``: one failed backend request, absorbed by its bounded
  retry; ``parallel/transport/``), and ``workerdeath``, whose cluster
  layer is not ported: it parses and never fires.
- ``site``: a named injection point in a dispatch funnel: ``upload``
  (the wire codec's host->device copy), ``download`` (the result copy),
  ``concat`` (batch coalescing), ``kernel`` (each operator's retried
  per-batch step), ``scan`` (host-side scan-unit decode; fires on
  prefetch and reader threads and is re-raised at the ordered
  consumption point), ``exchange.flush`` / ``exchange.serve`` (shuffle
  map and reduce sides), ``spill.write`` / ``spill.read`` (disk tier
  I/O), ``wire`` (serialized spill frames, ``corrupt`` only),
  ``transport.write`` (a shard written through a transport session),
  ``transport`` (a fetched shard: ``lostshard``, ``oom``, ``transient``,
  ``corrupt``, ``slowput``) and ``objectstore`` (a backend request). The
  grammar accepts any site name, so every spec of the reference parses.
- ``arg``: an integer N fires on the first N hits of the site (default
  1); a float p in (0, 1] fires per hit with probability p from a
  deterministic per-site PRNG seeded by
  ``spark.rapids.sql.test.faults.seed`` / ``SRT_FAULTS_SEED``.
- ``/query=N``: the entry fires only on hits made by the query whose
  fault tag is ``N`` (``spark.rapids.sql.test.faults.queryTag``, else
  the query's minted id).

This module also carries the per-thread QUERY TOKEN: the scheduler's
admission of every owned top-level ``collect`` mints one with an
increasing id (:func:`new_query_token`); the flight recorder files events
under it and query-scoped entries match its tag. Every
:func:`fault_point` is a cancellation checkpoint too, and
:func:`check_preempted` is the partition boundary's preemption
checkpoint.

The registry is process-global and ARMED only while a non-empty spec is
configured; a disarmed ``fault_point`` is a thread-local load and a
global load. Every injection and recovery event bumps the process-global
counters (``faultsInjected``, ``retriesAttempted``,
``spillEscalations``, ``corruptionsDetected``) and, when a query is
running, its ``Recovery@query`` metrics (the recovery sink).

Imports nothing beyond the standard library at module level: deep
dispatch code imports this module.
"""

from __future__ import annotations

import itertools
import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple


class InjectedOomError(RuntimeError):
    """Synthetic device allocation failure. The message carries the
    reference's RESOURCE_EXHAUSTED marker and the port's "out of memory",
    so ``memory.oom.is_oom_error`` routes it into the ladder exactly like
    a real ``torch.OutOfMemoryError``."""

    def __init__(self, site: str):
        super().__init__(
            f"RESOURCE_EXHAUSTED: out of memory: injected fault at "
            f"{site!r} (spark.rapids.sql.test.faults)")
        self.site = site


class InjectedTransientError(RuntimeError):
    """Synthetic backend failure (UNAVAILABLE marker), retried by the
    planner's recovery ladder (``memory/oom.py`` ``is_transient_error``)."""

    def __init__(self, site: str):
        super().__init__(
            f"UNAVAILABLE: injected transient fault at {site!r} "
            f"(spark.rapids.sql.test.faults)")
        self.site = site


class InjectedLostOutputError(RuntimeError):
    """Synthetic loss of a durable stage output. ``fault_owner`` (``id()``
    of the owning exchange, set by the injection site) names the stage
    that stage lineage would recompute."""

    def __init__(self, site: str):
        super().__init__(
            f"UNAVAILABLE: injected lost stage output at {site!r} "
            f"(spark.rapids.sql.test.faults)")
        self.site = site
        self.fault_owner: Optional[int] = None


class InjectedStallError(RuntimeError):
    """Raised when an injected stall ends: its cancel event fired, or its
    safety timeout expired (DEADLINE_EXCEEDED marker)."""

    def __init__(self, site: str):
        super().__init__(
            f"DEADLINE_EXCEEDED: injected stall at {site!r} "
            f"(spark.rapids.sql.test.faults)")
        self.site = site


class QueryCancelledError(RuntimeError):
    """The query was cancelled. The message carries NO transient or OOM
    marker: a cancelled query unwinds through every retry ladder."""

    def __init__(self, query_id: int, reason: str):
        super().__init__(
            f"CANCELLED: query {query_id} {reason} "
            "(spark.rapids.sql.scheduler.*)")
        self.query_id = query_id
        self.reason = reason


class QueryPreemptedError(RuntimeError):
    """Control flow only: the query was asked to yield the card to a
    higher-priority class and unwound at a partition boundary. The
    planner's ladder catches it, spills the query's catalog, waits for
    the preemptor to drain and resumes on the SAME context, where
    materialized stage outputs serve again. Like cancellation, the
    message carries NO transient or OOM marker: no other retry rung may
    consume a preemption."""

    def __init__(self, query_id: int, preemptor: Optional[str] = None):
        super().__init__(
            f"PREEMPTED: query {query_id} yielded the device to a "
            f"{preemptor or 'higher-priority'} query "
            "(spark.rapids.sql.scheduler.preemption.*)")
        self.query_id = query_id
        self.preemptor = preemptor


class QueryToken:
    """Per-query cooperative cancellation handle and identity, registered
    thread-locally on every thread that works for the query (the collect
    thread, watchdog attempts, pipeline prefetchers, scan reader
    threads). ``cancel`` is a plain Event; ``reason`` is set before it so
    the unwinding error names why. A deadline
    (``collect(timeout_ms=...)``) sets the same event from the
    scheduler's timer.

    ``tenant`` and ``qos_class`` are the admission's attribution
    (``parallel/qos/``). ``preempt`` is the gentler second signal
    (``scheduler.preemption.enabled``): the class-ranked device gate sets
    it when a higher-priority query waits behind this one. It is honored
    only at partition boundaries (:func:`check_preempted`) and the query
    resumes afterwards; ``preempt_enabled`` goes off once the query's
    preemption budget is spent."""

    __slots__ = ("query_id", "fault_tag", "cancel", "reason", "tenant",
                 "qos_class", "preempt", "preemptor_class",
                 "preempt_enabled")

    def __init__(self, query_id: int, fault_tag: Optional[int] = None,
                 tenant: Optional[str] = None,
                 qos_class: Optional[str] = None):
        self.query_id = query_id
        # The tag query-scoped fault entries (kind@site/query=N) match.
        self.fault_tag = fault_tag if fault_tag is not None else query_id
        self.cancel = threading.Event()
        self.reason = "cancelled"
        self.tenant = tenant
        # None: FIFO admission (the device gate ranks it as the default
        # class).
        self.qos_class = qos_class
        self.preempt = threading.Event()
        self.preemptor_class: Optional[str] = None
        self.preempt_enabled = True

    def request_cancel(self, reason: str = "cancelled") -> None:
        self.reason = reason
        self.cancel.set()

    def cancelled(self) -> bool:
        return self.cancel.is_set()

    def error(self) -> QueryCancelledError:
        return QueryCancelledError(self.query_id, self.reason)

    def request_preempt(self, preemptor_class: Optional[str] = None) -> None:
        """Ask this query to yield the card at its next partition
        boundary (the class-ranked gate calls this)."""
        self.preemptor_class = preemptor_class
        self.preempt.set()

    def preempt_requested(self) -> bool:
        return self.preempt_enabled and self.preempt.is_set()

    def clear_preempt(self) -> None:
        self.preempt.clear()
        self.preemptor_class = None


_IDS = itertools.count(1)
_ID_LOCK = threading.Lock()


def new_query_token(fault_tag: Optional[int] = None,
                    tenant: Optional[str] = None,
                    qos_class: Optional[str] = None) -> QueryToken:
    """Mint the token of one admitted query (``parallel/scheduler.py``):
    ids start at 1 and increase for the whole process. ``fault_tag``
    None = the id is the tag."""
    with _ID_LOCK:
        qid = next(_IDS)
    return QueryToken(qid, fault_tag, tenant=tenant, qos_class=qos_class)


def set_query_token(token: Optional[QueryToken]) -> None:
    """Register the active query's token for the calling thread. Helper
    threads (prefetch pool, scan readers) take it over explicitly:
    thread-locals do not inherit."""
    _TL.query = token


def get_query_token() -> Optional[QueryToken]:
    return getattr(_TL, "query", None)


def check_cancelled() -> None:
    """Cancellation checkpoint: raise :class:`QueryCancelledError` when
    the calling thread's query was cancelled."""
    tok = getattr(_TL, "query", None)
    if tok is not None and tok.cancel.is_set():
        raise tok.error()


def check_preempted() -> None:
    """Partition-boundary preemption checkpoint: raise
    :class:`QueryPreemptedError` when the class-ranked device gate asked
    the calling thread's query to yield. Separate from
    :func:`check_cancelled` on purpose: preemption is honored only where
    suspending is safe (between partitions, where every live
    intermediate is catalog-registered data at rest). A no-op whenever
    preemption is off (the gate never sets the event)."""
    tok = getattr(_TL, "query", None)
    if tok is not None and tok.preempt_enabled and tok.preempt.is_set():
        raise QueryPreemptedError(tok.query_id, tok.preemptor_class)


def current_query_id() -> Optional[int]:
    """The calling thread's query id (the flight recorder's ring), or
    None outside a query."""
    tok = getattr(_TL, "query", None)
    return None if tok is None else tok.query_id


class FaultSpec:
    """One parsed ``kind@site[/query=N]:arg`` entry."""

    __slots__ = ("kind", "site", "count", "probability", "fired", "query")

    def __init__(self, kind: str, site: str, count: Optional[int],
                 probability: Optional[float],
                 query: Optional[int] = None):
        self.kind = kind
        self.site = site
        self.count = count              # fire on the first N hits
        self.probability = probability  # or per-hit Bernoulli(p)
        self.query = query              # only for this query tag (None=any)
        self.fired = 0

    def __repr__(self):  # pragma: no cover - debug
        arg = self.probability if self.count is None else self.count
        q = "" if self.query is None else f"/query={self.query}"
        return f"FaultSpec({self.kind}@{self.site}{q}:{arg})"


_KINDS = ("oom", "transient", "corrupt", "lostoutput", "stall",
          "lostshard", "workerdeath", "slowput", "unavailable")


class FaultParseError(ValueError):
    pass


def parse_spec(spec: str) -> List[FaultSpec]:
    out: List[FaultSpec] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "@" not in entry:
            raise FaultParseError(
                f"bad fault entry {entry!r}: expected kind@site[:arg]")
        kind, rest = entry.split("@", 1)
        kind = kind.strip().lower()
        if kind not in _KINDS:
            raise FaultParseError(
                f"unknown fault kind {kind!r} (want one of {_KINDS})")
        if ":" in rest:
            site, arg = rest.rsplit(":", 1)
        else:
            site, arg = rest, "1"
        site = site.strip()
        query: Optional[int] = None
        if "/" in site:
            site, qpart = site.split("/", 1)
            site = site.strip()
            qpart = qpart.strip()
            if not qpart.startswith("query="):
                raise FaultParseError(
                    f"bad fault entry {entry!r}: expected /query=N")
            try:
                query = int(qpart[len("query="):])
            except ValueError:
                raise FaultParseError(
                    f"bad fault entry {entry!r}: query tag must be an int")
        if not site:
            raise FaultParseError(f"bad fault entry {entry!r}: empty site")
        arg = arg.strip()
        try:
            if "." in arg:
                p = float(arg)
                if not 0.0 < p <= 1.0:
                    raise FaultParseError(
                        f"fault probability out of (0, 1]: {entry!r}")
                out.append(FaultSpec(kind, site, None, p, query))
            else:
                n = int(arg)
                if n < 1:
                    raise FaultParseError(
                        f"fault count must be >= 1: {entry!r}")
                out.append(FaultSpec(kind, site, n, None, query))
        except ValueError as e:
            if isinstance(e, FaultParseError):
                raise
            raise FaultParseError(f"bad fault arg in {entry!r}") from e
    return out


class FaultInjector:
    """Armed schedule: per-site hit counters + deterministic PRNGs."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = int(seed)
        self.entries = parse_spec(spec)
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._rngs: Dict[str, random.Random] = {}

    def _rng(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            # Seeded per (seed, site): the roll sequence at a site is a
            # pure function of the schedule, never of thread timing at
            # OTHER sites.
            rng = self._rngs[site] = random.Random(f"{self.seed}:{site}")
        return rng

    def should_fire(self, site: str, kinds,
                    query: Optional[int] = None) -> Optional[FaultSpec]:
        """One hit of ``site``; returns the spec entry that fires (first
        match wins) or None. Thread-safe; deterministic for count faults,
        and for probability faults given a deterministic hit order.
        ``query`` is the hitting query's fault tag."""
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            for e in self.entries:
                if e.site != site or e.kind not in kinds:
                    continue
                if e.query is not None and e.query != query:
                    continue
                if e.count is not None:
                    if e.fired < e.count:
                        e.fired += 1
                        return e
                elif self._rng(site).random() < e.probability:
                    e.fired += 1
                    return e
        return None


_LOCK = threading.Lock()
_INJECTOR: Optional[FaultInjector] = None
_COUNTERS: Dict[str, float] = {}
_TL = threading.local()


def _env_injector() -> Optional[FaultInjector]:
    spec = os.environ.get("SRT_FAULTS", "").strip()
    if not spec:
        return None
    return FaultInjector(spec, int(os.environ.get("SRT_FAULTS_SEED", "0")))


with _LOCK:
    _INJECTOR = _env_injector()


def configure(spec: str, seed: int = 0) -> Optional[FaultInjector]:
    """(Re-)arm the process-global schedule; an empty spec disarms. Count
    faults reset to unfired."""
    global _INJECTOR
    with _LOCK:
        _INJECTOR = FaultInjector(spec, seed) if spec.strip() else None
        return _INJECTOR


def maybe_configure(conf) -> None:
    """Arm from ``spark.rapids.sql.test.faults`` when the query's conf
    sets it explicitly (the config wins over SRT_FAULTS); called once per
    query by ``PhysicalPlan.collect``.

    Idempotent against the ARMED schedule: a second collect with the
    same (spec, seed) keeps the current injector and its consumed
    count-fault state, so a repeated collect after a recovered run does
    not re-fire consumed faults; a test that wants a fresh schedule
    calls :func:`configure`."""
    from spark_rapids_tpu_torch import config as C
    if C.TEST_FAULTS.key in conf.raw:
        spec = str(conf.get(C.TEST_FAULTS))
        seed = int(conf.get(C.TEST_FAULTS_SEED))
        with _LOCK:
            cur = _INJECTOR
            if cur is not None and cur.spec == spec and cur.seed == seed:
                return
        configure(spec, seed)


def injector() -> Optional[FaultInjector]:
    return _INJECTOR


def snapshot() -> Tuple[Optional[FaultInjector], Dict[str, float]]:
    """Capture the process-global fault state (armed injector + recovery
    counters) so a test can restore it afterwards."""
    with _LOCK:
        return _INJECTOR, dict(_COUNTERS)


def restore(state: Tuple[Optional[FaultInjector], Dict[str, float]]) -> None:
    """Restore a :func:`snapshot` (the exact injector object, with its
    consumed-fault state, and the counter values as of the snapshot)."""
    global _INJECTOR
    inj, counters_ = state
    with _LOCK:
        _INJECTOR = inj
        _COUNTERS.clear()
        _COUNTERS.update(counters_)


def set_recovery_sink(metrics) -> None:
    """Per-query Metrics object (``Recovery@query``) that mirrors the
    process-global recovery counters on the calling thread."""
    _TL.sink = metrics


def get_recovery_sink():
    """The calling thread's recovery sink (helper threads take it over
    explicitly)."""
    return getattr(_TL, "sink", None)


def set_cancel_event(event) -> None:
    """Register a cancel event for the calling thread: an injected
    ``stall`` waits on it and unwinds with :class:`InjectedStallError`
    the moment it is set."""
    _TL.cancel = event


def get_cancel_event():
    return getattr(_TL, "cancel", None)


def record(name: str, amount: float = 1) -> None:
    """Bump a recovery counter: process-global and the calling thread's
    recovery sink (``DataFrame.metrics()``'s ``Recovery@query``)."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + amount
    sink = getattr(_TL, "sink", None)
    if sink is not None:
        sink.add(name, amount)


def counters() -> Dict[str, float]:
    with _LOCK:
        return dict(_COUNTERS)


def reset_counters() -> None:
    with _LOCK:
        _COUNTERS.clear()


# Safety net for a stall with no cancel event: wait at most this long
# before unwinding as DEADLINE_EXCEEDED.
STALL_TIMEOUT_S = float(os.environ.get("SRT_STALL_TIMEOUT_S", "30"))


def _current_fault_tag() -> Optional[int]:
    """The calling thread's query fault tag (for kind@site/query=N
    matching), or None outside a query: scoped entries then never
    fire."""
    tok = getattr(_TL, "query", None)
    return None if tok is None else tok.fault_tag


def _stall(site: str) -> None:
    """Injected stall: hang this dispatch like a wedged device call,
    bounded. A registered cancel event or query cancel ends it early;
    otherwise the safety timeout expires. Either way the dispatch unwinds
    (a stall never 'completes')."""
    cancel = getattr(_TL, "cancel", None)
    tok = getattr(_TL, "query", None)
    deadline = time.monotonic() + STALL_TIMEOUT_S
    while time.monotonic() < deadline:
        if cancel is not None and cancel.is_set():
            break
        if tok is not None:
            if tok.cancel.wait(0.02):
                raise tok.error()
        elif cancel is not None:
            cancel.wait(0.05)
        else:
            time.sleep(0.05)
    raise InjectedStallError(site)


def _note_injection(kind: str, site: str) -> None:
    record("faultsInjected")
    record(f"faultsInjected.{kind}@{site}")
    from spark_rapids_tpu_torch import monitoring
    monitoring.instant("fault-injected", "recovery",
                       args={"kind": kind, "site": site})


def check_fault(site: str, kinds) -> Optional[FaultSpec]:
    """One hit of ``site`` against the armed schedule, restricted to
    ``kinds``: returns the firing entry (recording the injection
    counters and the ``fault-injected`` instant) or None."""
    inj = _INJECTOR
    if inj is None:
        return None
    e = inj.should_fire(site, kinds, _current_fault_tag())
    if e is None:
        return None
    _note_injection(e.kind, site)
    return e


def fault_point(site: str, owner: Optional[int] = None) -> None:
    """Named injection site AND cancellation checkpoint: raises the
    synthetic error when an ``oom`` / ``transient`` / ``lostoutput``
    entry fires, or hangs (then unwinds) on a ``stall``. ``owner`` tags a
    lostoutput with the owning exchange's id."""
    check_cancelled()
    e = check_fault(site, ("oom", "transient", "lostoutput", "stall"))
    if e is None:
        return
    if e.kind == "oom":
        raise InjectedOomError(site)
    if e.kind == "transient":
        raise InjectedTransientError(site)
    if e.kind == "lostoutput":
        err = InjectedLostOutputError(site)
        err.fault_owner = owner
        raise err
    _stall(site)


def corrupt_blob(site: str, blob: bytes) -> bytes:
    """Corruption site: ``blob`` with one byte flipped when a ``corrupt``
    entry fires (offset from the site PRNG), else unchanged. Used on READ
    paths so the data at rest survives: detection + one re-read
    recovers; persistent corruption fails loudly at the checksum."""
    inj = _INJECTOR
    if inj is None or not blob:
        return blob
    e = inj.should_fire(site, ("corrupt",), _current_fault_tag())
    if e is None:
        return blob
    _note_injection("corrupt", site)
    off = inj._rng(site).randrange(len(blob))
    out = bytearray(blob)
    out[off] ^= 0xFF
    return bytes(out)
