"""Multi-query admission control, isolation and cancellation (port of the
JAX package's ``parallel/scheduler.py``).

The device semaphore (``memory/stores.py`` ``TpuSemaphore``) bounds how
many queries issue device work at once; this module is the other half,
at QUERY granularity. Four pieces:

1. **Admission control**: :class:`QueryManager` holds a bounded run
   queue (``spark.rapids.sql.scheduler.{maxConcurrentQueries,
   queueDepth,admissionTimeoutMs}``). At most ``maxConcurrentQueries``
   collects run at once; more wait FIFO in a queue of ``queueDepth``
   (or in the QoS run queue, ``parallel/qos/``); a query arriving with
   the queue full, or waiting past the admission timeout, is SHED with
   :class:`QueryRejectedError`, which carries a ``retry_after_ms`` hint
   from the observed service rate.

2. **Per-query isolation**: every admitted query gets an increasing
   query id (``faults.new_query_token``); its catalog is owner-tagged
   with that id, its device budget is scaled by
   ``scheduler.queryMemoryFraction``, and the OOM ladder spills the
   offending query's own buffers before :meth:`QueryManager.
   evict_neighbors` spills anyone else's (``crossQueryEvictions``).
   Teardown closes every owned handle and records the catalog's leak
   report (``ExecContext.last_leak_report``).

3. **Cooperative cancellation and deadlines**: ``collect(timeout_ms=...)``
   arms a timer that sets the token's cancel event, and
   :meth:`QueryHandle.cancel` sets it directly. Every ``fault_point`` is
   a cancellation checkpoint, the semaphore acquire and the pipeline's
   ordered wait poll the token, and the helper threads inherit it, so a
   cancelled query unwinds with ``faults.QueryCancelledError``,
   releasing its permit and its buffers.

4. **Memory-pressure brownout** (``scheduler.pressure.*``, off by
   default): every device collect reports its catalog's pressure score
   (:func:`note_pressure`); sustained pressure sheds background-class
   admissions.

Counters (process-global here, and per query in the ``Scheduler@query``
metrics entry): ``queuedMs``, ``admitted``, ``rejected``, ``cancelled``,
``deadlineKills``, ``crossQueryEvictions``, ``preemptions``,
``preemptedMs``, ``resumedStages``, ``clientRetries``; port-only,
``crossQueryEvictedBytes`` (catalog bytes an eviction spilled) and
``crossQueryAllocatorBytes`` (what the caching allocator's count of
allocated bytes fell by across them, on the card).

``SRT_SCHEDULER_MAX_CONCURRENT=1`` (env) makes queries strictly serial.

Every query runs in one process on one card, and the confs that are
process-global in both packages (the wire codec, the native gates, the
flight recorder and telemetry, the OOM ladder's shrink) are adopted per
collect: concurrent queries must share one conf for those.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from spark_rapids_tpu_torch import faults

_COUNTER_LOCK = threading.Lock()
_COUNTERS: Dict[str, float] = {}


def _record(name: str, amount: float = 1) -> None:
    with _COUNTER_LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + amount


def counters() -> Dict[str, float]:
    """Process-global scheduler counters."""
    with _COUNTER_LOCK:
        return dict(_COUNTERS)


def reset_counters() -> None:
    with _COUNTER_LOCK:
        _COUNTERS.clear()


def metrics_entry(ctx):
    """The per-query ``Scheduler@query`` metrics entry (an audit group,
    which the metrics level never drops)."""
    from spark_rapids_tpu_torch.ops.base import query_metrics_entry
    return query_metrics_entry(ctx, "Scheduler")


def _telemetry_reject(kind: str, depth: int, hint, tenant=None,
                      qcls=None) -> None:
    """A rejection's fields as labeled telemetry series beside the bare
    ``rejected`` counter."""
    from spark_rapids_tpu_torch.monitoring import telemetry
    if not telemetry.enabled():
        return
    telemetry.inc("srt_queries_rejected", kind=kind,
                  tenant=str(tenant or "-"), **{"class": str(qcls or "-")})
    telemetry.set_gauge("srt_reject_queue_depth", depth, kind=kind)
    if hint is not None:
        telemetry.set_gauge("srt_reject_retry_after_ms", hint, kind=kind)


def record_plan_cache(ctx, hit: bool) -> None:
    """One execution's plan-cache outcome on its ``Scheduler@query``
    entry and the process counters (``planCacheBindOnly`` /
    ``planCacheMiss``); a tenant-tagged query also counts
    ``planCacheHit.<tenant>`` / ``planCacheMiss.<tenant>`` in the QoS
    counters."""
    name = "planCacheBindOnly" if hit else "planCacheMiss"
    metrics_entry(ctx).add(name, 1)
    _record(name)
    tenant = getattr(getattr(ctx, "query", None), "tenant", None)
    if tenant:
        from spark_rapids_tpu_torch.parallel import qos as Q
        Q._record(f"planCache{'Hit' if hit else 'Miss'}.{tenant}")


class QueryRejectedError(RuntimeError):
    """Load shed or policy rejection. Deliberately NOT a transient error
    (no retry marker): the caller (a serving tier, a test or
    :func:`collect_with_retry`) decides whether to resubmit, from:

    - ``kind``: ``queue-full`` | ``admission-timeout`` | ``tenant-quota``
      | ``deadline-unmeetable`` | ``brownout``
    - ``queue_depth``: the run queue's occupancy at rejection
    - ``retry_after_ms``: when resubmitting could plausibly succeed (the
      observed service time scaled by the queue depth); None only where
      retrying as-is can never help (a deadline the raw cost estimate
      already exceeds)."""

    def __init__(self, reason: str, kind: str = "rejected",
                 queue_depth: Optional[int] = None,
                 retry_after_ms: Optional[float] = None):
        super().__init__(
            f"REJECTED: {reason} (spark.rapids.sql.scheduler.*)")
        self.reason = reason
        self.kind = kind
        self.queue_depth = queue_depth
        self.retry_after_ms = retry_after_ms


class QueryTicket:
    """One admitted query: its token (cancellation handle and owner id),
    its admission bookkeeping and the context cross-query eviction walks.
    A QoS admission carries the priority class, tenant and cost estimate;
    a FIFO admission leaves them None (its tenant may be set, as
    attribution only)."""

    __slots__ = ("token", "queued_ms", "ctx", "deadline_timer",
                 "qos_class", "tenant", "cost_ms", "admitted_at")

    def __init__(self, token: faults.QueryToken, queued_ms: float,
                 qos_class: Optional[str] = None,
                 tenant: Optional[str] = None,
                 cost_ms: Optional[float] = None):
        self.token = token
        self.queued_ms = queued_ms
        self.ctx = None                 # registered by PhysicalPlan
        self.deadline_timer: Optional[threading.Timer] = None
        self.qos_class = qos_class
        self.tenant = tenant
        self.cost_ms = cost_ms
        self.admitted_at = time.perf_counter()

    @property
    def query_id(self) -> int:
        return self.token.query_id

    def arm_deadline(self, timeout_ms: Optional[float]) -> None:
        """A deadline sets the SAME cancel event a cancel does, from a
        daemon timer thread; the query unwinds at its next checkpoint."""
        if timeout_ms is None or timeout_ms <= 0:
            return
        t = threading.Timer(
            timeout_ms / 1000.0,
            lambda: self.token.request_cancel("deadline exceeded"))
        t.daemon = True
        t.start()
        self.deadline_timer = t

    def cancel(self, reason: str = "cancelled") -> None:
        self.token.request_cancel(reason)


class QueryManager:
    """The process-wide query scheduler (admission at query granularity).
    One live instance per process (:func:`get_query_manager`); a conf
    change replaces it only while it is idle."""

    def __init__(self, max_concurrent: int = 2, queue_depth: int = 16,
                 admission_timeout_ms: int = 60000, qos=None):
        self.max_concurrent = max(int(max_concurrent), 1)
        self.queue_depth = max(int(queue_depth), 0)
        self.admission_timeout_ms = max(int(admission_timeout_ms), 1)
        self._lock = threading.Lock()
        self._slots_free = self.max_concurrent
        self._waiters: List[threading.Event] = []   # the FIFO run queue
        self._active: Dict[int, QueryTicket] = {}
        # The QoS policy (parallel/qos/), or None: the FIFO queue above.
        self._qos = qos
        # EWMA of observed query service times, which the retry hint of
        # a rejection reads (never a scheduling input).
        self._service_ewma_ms: Optional[float] = None
        # Brownout state (scheduler.pressure.*), driven by note_pressure.
        self._pressure_score = 0.0
        self._pressure_high_since: Optional[float] = None
        self.brownout_active = False
        # Set (under this manager's lock) when a conf change replaced this
        # manager: late calls on a stale reference follow the chain, so a
        # ticket never lands in a retired manager.
        self._successor: Optional["QueryManager"] = None

    def _current(self) -> "QueryManager":
        m = self
        while m._successor is not None:
            m = m._successor
        return m

    # -- admission -----------------------------------------------------------
    def admit(self, conf=None,
              cancel: Optional[threading.Event] = None,
              priority: Optional[str] = None,
              tenant: Optional[str] = None,
              cost_ms: Optional[float] = None,
              deadline_ms: Optional[float] = None) -> QueryTicket:
        """Block until a run slot frees (FIFO, or WFQ order under QoS),
        up to the admission timeout; raise :class:`QueryRejectedError` at
        once when the queue is full or a QoS check fails, and on timeout.
        ``cancel`` (the query's cancel event, when a handle made it
        first) aborts the wait too, with ``QueryCancelledError``.
        ``priority`` / ``tenant`` / ``cost_ms`` / ``deadline_ms`` feed the
        QoS policy; the FIFO path keeps only ``tenant``, as
        attribution."""
        if self._successor is not None:
            return self._current().admit(
                conf, cancel=cancel, priority=priority, tenant=tenant,
                cost_ms=cost_ms, deadline_ms=deadline_ms)
        if self._qos is not None:
            return self._admit_qos(conf, cancel, priority, tenant,
                                   cost_ms, deadline_ms)
        from spark_rapids_tpu_torch import config as C
        from spark_rapids_tpu_torch import monitoring
        tag = None
        tnt = tenant
        if conf is not None:
            t = int(conf.get(C.TEST_FAULTS_QUERY_TAG))
            if t >= 0:
                tag = t
            if tnt is None:
                v = str(conf.get(C.QOS_TENANT) or "").strip()
                tnt = v or None
        me: Optional[threading.Event] = None
        t0 = time.perf_counter()
        with self._lock:
            if self._successor is not None:
                pass            # retired since the check above: redirect
            elif self._slots_free > 0 and not self._waiters:
                self._slots_free -= 1
                return self._issue(tag, 0.0, cancel, tenant=tnt)
            elif len(self._waiters) >= self.queue_depth:
                _record("rejected")
                _record("rejected.queue-full")
                depth = len(self._waiters)
                hint = self._retry_hint_locked()
                monitoring.instant("query-rejected", "recovery",
                                   args={"reason": "queue full"})
                _telemetry_reject("queue-full", depth, hint, tenant=tnt)
                raise QueryRejectedError(
                    f"run queue full ({depth} queued, "
                    f"{self.max_concurrent} running)",
                    kind="queue-full", queue_depth=depth,
                    retry_after_ms=hint)
            else:
                me = threading.Event()
                self._waiters.append(me)
        if me is None:
            return self._current().admit(
                conf, cancel=cancel, priority=priority, tenant=tenant,
                cost_ms=cost_ms, deadline_ms=deadline_ms)
        deadline = t0 + self.admission_timeout_ms / 1000.0
        while True:
            remaining = deadline - time.perf_counter()
            if remaining <= 0 or (cancel is not None and cancel.is_set()):
                with self._lock:
                    if me in self._waiters:
                        self._waiters.remove(me)
                    elif me.is_set():
                        # Granted between the timeout and the lock: the
                        # slot is ours to hand on.
                        self._release_slot_locked()
                    depth = len(self._waiters)
                    hint = self._retry_hint_locked()
                if cancel is not None and cancel.is_set():
                    _record("cancelled")
                    monitoring.instant(
                        "query-cancelled", "recovery",
                        args={"reason": "cancelled while queued"})
                    raise faults.QueryCancelledError(
                        -1, "cancelled while queued")
                _record("rejected")
                _record("rejected.admission-timeout")
                monitoring.instant("query-rejected", "recovery",
                                   args={"reason": "admission timeout"})
                _telemetry_reject("admission-timeout", depth, hint,
                                  tenant=tnt)
                raise QueryRejectedError(
                    f"admission timeout after "
                    f"{self.admission_timeout_ms}ms "
                    f"({self.max_concurrent} running)",
                    kind="admission-timeout", queue_depth=depth,
                    retry_after_ms=hint)
            if me.wait(min(remaining, 0.05)):
                with self._lock:
                    queued_ms = (time.perf_counter() - t0) * 1000.0
                    return self._issue(tag, queued_ms, cancel, tenant=tnt)

    def _admit_qos(self, conf, cancel, priority, tenant, cost_ms,
                   deadline_ms) -> QueryTicket:
        """QoS admission: tenant quotas and deadline feasibility first,
        then the WFQ run queue instead of FIFO."""
        from spark_rapids_tpu_torch import config as C
        from spark_rapids_tpu_torch import monitoring
        from spark_rapids_tpu_torch.parallel import qos as Q
        qos = self._qos
        qcls = Q.resolve_class(
            priority if priority is not None else
            (str(conf.get(C.QOS_PRIORITY_CLASS)) if conf is not None
             else None))
        tnt = Q.resolve_tenant(
            tenant if tenant is not None else
            (str(conf.get(C.QOS_TENANT) or "") if conf is not None
             else None))
        tag = None
        if conf is not None:
            t = int(conf.get(C.TEST_FAULTS_QUERY_TAG))
            if t >= 0:
                tag = t
            evicted = qos.enforce_kernel_quota(conf, tnt)
            if evicted:
                Q._record("quotaEvictions", evicted)
                monitoring.instant(
                    "qos-quota-eviction", "recovery",
                    args={"tenant": tnt, "entriesEvicted": evicted})

        def reject(kind, reason, depth, hint):
            _record("rejected")
            Q._record(f"rejected.{kind}")
            monitoring.instant(
                "query-rejected", "recovery",
                args={"reason": reason, "kind": kind, "tenant": tnt,
                      "class": qcls})
            _telemetry_reject(kind, depth, hint, tenant=tnt, qcls=qcls)
            raise QueryRejectedError(reason, kind=kind, queue_depth=depth,
                                     retry_after_ms=hint)

        me: Optional[threading.Event] = None
        entry = None
        t0 = time.perf_counter()
        with self._lock:
            if self._successor is None:
                if conf is not None:
                    reason = qos.deadline_rejects(conf, cost_ms,
                                                  deadline_ms)
                    if reason is not None:
                        # Retrying as-is can never help when the RAW
                        # estimate exceeds the deadline; when only the
                        # slack did, a drained queue may let it through.
                        hopeless = (cost_ms is None or not deadline_ms
                                    or cost_ms > deadline_ms)
                        reject("deadline-unmeetable", reason,
                               len(qos.queue),
                               None if hopeless
                               else self._retry_hint_locked())
                    reason = qos.tenant_rejects(
                        conf, tnt, list(self._active.values()))
                    if reason is not None:
                        reject("tenant-quota", reason, len(qos.queue),
                               self._retry_hint_locked())
                if self.brownout_active and qcls == "background":
                    # Sustained device pressure sheds background load
                    # with a retry hint before the OOM ladders engage.
                    reject("brownout",
                           f"brownout: sustained device pressure "
                           f"{self._pressure_score:.2f}, background "
                           f"load shed", len(qos.queue),
                           self._retry_hint_locked())
                if self._slots_free > 0 and len(qos.queue) == 0:
                    self._slots_free -= 1
                    qos.quotas.reserve(tnt)
                    return self._issue(tag, 0.0, cancel, qos_class=qcls,
                                       tenant=tnt, cost_ms=cost_ms)
                if len(qos.queue) >= self.queue_depth:
                    reject("queue-full",
                           f"run queue full ({len(qos.queue)} queued, "
                           f"{self.max_concurrent} running)",
                           len(qos.queue), self._retry_hint_locked())
                me = threading.Event()
                entry = qos.queue.push(qcls, cost_ms, me, tnt)
                qos.quotas.reserve(tnt)
        if me is None:
            return self._current().admit(
                conf, cancel=cancel, priority=priority, tenant=tenant,
                cost_ms=cost_ms, deadline_ms=deadline_ms)
        deadline = t0 + self.admission_timeout_ms / 1000.0
        while True:
            remaining = deadline - time.perf_counter()
            if remaining <= 0 or (cancel is not None and cancel.is_set()):
                with self._lock:
                    if not entry.granted:
                        qos.queue.discard(entry)
                    elif me.is_set():
                        self._release_slot_locked()
                    qos.quotas.release(tnt)
                    depth = len(qos.queue)
                    hint = self._retry_hint_locked()
                if cancel is not None and cancel.is_set():
                    _record("cancelled")
                    monitoring.instant(
                        "query-cancelled", "recovery",
                        args={"reason": "cancelled while queued"})
                    raise faults.QueryCancelledError(
                        -1, "cancelled while queued")
                reject("admission-timeout",
                       f"admission timeout after "
                       f"{self.admission_timeout_ms}ms "
                       f"({self.max_concurrent} running)",
                       depth, hint)
            if me.wait(min(remaining, 0.05)):
                with self._lock:
                    queued_ms = (time.perf_counter() - t0) * 1000.0
                    return self._issue(tag, queued_ms, cancel,
                                       qos_class=qcls, tenant=tnt,
                                       cost_ms=cost_ms)

    def _issue(self, tag: Optional[int], queued_ms: float,
               cancel: Optional[threading.Event],
               qos_class: Optional[str] = None,
               tenant: Optional[str] = None,
               cost_ms: Optional[float] = None) -> QueryTicket:
        """Build the admitted ticket (the caller holds the lock and the
        slot). The id comes from ``faults.new_query_token``, increasing
        for the whole process (the JAX package counts per manager)."""
        token = faults.new_query_token(tag, tenant=tenant,
                                       qos_class=qos_class)
        if cancel is not None:
            # A handle made the cancel event first, so cancel() works
            # while the query is queued; the token adopts it.
            token.cancel = cancel
        ticket = QueryTicket(token, queued_ms, qos_class=qos_class,
                             tenant=tenant, cost_ms=cost_ms)
        self._active[token.query_id] = ticket
        _record("admitted")
        _record("queuedMs", queued_ms)
        if qos_class is not None:
            from spark_rapids_tpu_torch.parallel import qos as Q
            Q._record(f"admitted.{qos_class}")
            self._qos.quotas.record_query(token.query_id, tenant)
        from spark_rapids_tpu_torch import monitoring
        if monitoring.telemetry.enabled():
            monitoring.telemetry.inc("srt_queries_admitted",
                                     tenant=str(tenant or "-"),
                                     **{"class": str(qos_class or "-")})
            monitoring.telemetry.observe("srt_admission_queued_ms",
                                         queued_ms,
                                         **{"class": str(qos_class or "-")})
        if monitoring.enabled():
            # The admission wait, retro-recorded as a "queued" span on the
            # query's own ring (its id exists only now).
            dur = int(queued_ms * 1e6)
            args = {"queuedMs": round(queued_ms, 2)}
            if qos_class is not None:
                args["class"] = qos_class
                args["tenant"] = tenant
            monitoring.record_span(
                "admission-queue", "queued", monitoring.now_ns() - dur,
                dur, qid=token.query_id, args=args,
                level=monitoring.LEVEL_QUERY)
        return ticket

    def _release_slot_locked(self) -> None:
        if self._qos is not None:
            entry, starved = self._qos.queue.pop_next()
            if entry is not None:
                if starved:
                    from spark_rapids_tpu_torch import monitoring
                    from spark_rapids_tpu_torch.parallel import qos as Q
                    Q._record("starvationBoundEngagements")
                    monitoring.instant(
                        "qos-starvation-bound", "recovery",
                        args={"class": entry.qos_class})
                entry.event.set()       # hand the slot on, WFQ order
            else:
                self._slots_free += 1
            return
        if self._waiters:
            self._waiters.pop(0).set()  # hand the slot on, FIFO
        else:
            self._slots_free += 1

    def _observe_service_locked(self, service_ms: float) -> None:
        if service_ms < 0:
            return
        if self._service_ewma_ms is None:
            self._service_ewma_ms = service_ms
        else:
            self._service_ewma_ms += 0.2 * (
                service_ms - self._service_ewma_ms)

    def _retry_hint_locked(self) -> float:
        """The ``retry_after_ms`` hint: the queue ahead of a resubmission
        drained at the observed service rate (a 250 ms prior before any
        query finished), at least 50 ms."""
        base = self._service_ewma_ms \
            if self._service_ewma_ms is not None else 250.0
        queued = len(self._qos.queue) if self._qos is not None \
            else len(self._waiters)
        waves = (1 + queued) / max(self.max_concurrent, 1)
        return round(max(50.0, base * waves), 1)

    def note_pressure(self, score: float, conf=None) -> None:
        """The brownout state machine (``scheduler.pressure.*``): every
        device collect reports its catalog's pressure score at teardown.
        A score held at or above ``brownout.enterScore`` for
        ``brownout.sustainMs`` turns brownout on (background admissions
        shed with retry hints); a score below ``brownout.exitScore``
        turns it off. A registered scale probe
        (:func:`register_scale_probe`) that accepts a scale-up defers the
        entry by one sustain window."""
        if self._successor is not None:
            return self._current().note_pressure(score, conf)
        from spark_rapids_tpu_torch import config as C
        from spark_rapids_tpu_torch import monitoring
        if conf is None or not bool(conf.get(C.PRESSURE_ENABLED)):
            return
        enter = float(conf.get(C.PRESSURE_BROWNOUT_SCORE))
        exit_below = float(conf.get(C.PRESSURE_BROWNOUT_EXIT_SCORE))
        sustain_s = max(
            int(conf.get(C.PRESSURE_BROWNOUT_SUSTAIN_MS)), 0) / 1000.0
        now = time.perf_counter()
        flip = None
        would_enter = False
        with self._lock:
            self._pressure_score = score
            if score >= enter:
                if self._pressure_high_since is None:
                    self._pressure_high_since = now
                if (not self.brownout_active
                        and now - self._pressure_high_since >= sustain_s):
                    would_enter = True
            else:
                self._pressure_high_since = None
                if self.brownout_active and score < exit_below:
                    self.brownout_active = False
                    flip = "exit"
        if would_enter:
            probe = _SCALE_PROBE
            deferred = False
            if probe is not None:
                try:
                    deferred = bool(probe(score))
                except Exception:       # a broken probe must not wedge
                    deferred = False    # the brownout valve
            with self._lock:
                if deferred:
                    self._pressure_high_since = now
                elif not self.brownout_active:
                    self.brownout_active = True
                    flip = "enter"
            if deferred:
                _record("brownoutDeferrals")
                monitoring.instant(
                    "brownout-deferred-scaleup", "recovery",
                    args={"pressureScore": round(score, 4)})
                if monitoring.telemetry.enabled():
                    monitoring.telemetry.inc("srt_brownout_deferrals")
        if flip is not None:
            _record("brownouts" if flip == "enter" else "brownoutExits")
            monitoring.instant(
                f"brownout-{flip}", "recovery",
                args={"pressureScore": round(score, 4)})
            if monitoring.telemetry.enabled():
                monitoring.telemetry.set_gauge(
                    "srt_brownout_active", 1 if flip == "enter" else 0)
                if flip == "enter":
                    monitoring.telemetry.inc("srt_brownouts")

    def finish(self, ticket: QueryTicket) -> None:
        """Query teardown (success, failure or cancel): disarm the
        deadline, release the run slot and wake the next queued query."""
        if self._successor is not None:
            return self._current().finish(ticket)
        if ticket.deadline_timer is not None:
            ticket.deadline_timer.cancel()
        service_ms = (time.perf_counter() - ticket.admitted_at) * 1000.0
        with self._lock:
            self._observe_service_locked(service_ms)
            if self._qos is not None and ticket.tenant is not None:
                self._qos.quotas.release(ticket.tenant)
            self._active.pop(ticket.query_id, None)
            self._release_slot_locked()

    # -- isolation -----------------------------------------------------------
    def register_context(self, ticket: QueryTicket, ctx) -> None:
        """Attach the query's ExecContext, so cross-query eviction can
        reach its catalog (and only its catalog)."""
        ticket.ctx = ctx

    def evict_neighbors(self, requester_id: Optional[int]) -> int:
        """The OOM ladder's rung before the batch-target shrink: spill
        every OTHER active query's spillable device buffers to the host.
        The offender's own buffers went in the rungs before; neighbors
        are touched only when that was not enough. Each catalog spills
        under its own lock, so a neighbor's thread never sees a buffer
        half moved. Returns the catalog bytes freed; each eviction that
        freed anything counts ``crossQueryEvictions``."""
        if self._successor is not None:
            return self._current().evict_neighbors(requester_id)
        with self._lock:
            victims = [t for qid, t in self._active.items()
                       if qid != requester_id and t.ctx is not None]
        freed = 0
        for t in victims:
            catalog = getattr(t.ctx, "_catalog", None)
            if catalog is None:
                continue                # never built: nothing to spill
            before = _allocated_bytes()
            got = catalog.handle_oom()
            if got > 0:
                released = max(before - _allocated_bytes(), 0)
                freed += got
                _record("crossQueryEvictions")
                _record("crossQueryEvictedBytes", got)
                _record("crossQueryAllocatorBytes", released)
                faults.record("crossQueryEvictions")
                from spark_rapids_tpu_torch import monitoring
                monitoring.instant(
                    "cross-query-eviction", "recovery",
                    args={"requester": requester_id,
                          "victim": t.query_id, "bytesFreed": got,
                          "allocatorBytesFreed": released})
        return freed

    @property
    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    @property
    def queued_count(self) -> int:
        with self._lock:
            if self._qos is not None:
                return len(self._qos.queue)
            return len(self._waiters)

    @property
    def qos(self):
        """The QosPolicy when QoS is enabled, else None (FIFO)."""
        return self._qos


def _allocated_bytes() -> int:
    """The caching allocator's count of allocated bytes on the current
    CUDA device (a host-side counter: no sync), 0 without one."""
    import torch
    return int(torch.cuda.memory_allocated()) \
        if torch.cuda.is_available() else 0


_MANAGER: Optional[QueryManager] = None
_MANAGER_LOCK = threading.Lock()


def _env_max_concurrent() -> Optional[int]:
    v = os.environ.get("SRT_SCHEDULER_MAX_CONCURRENT", "").strip()
    return int(v) if v else None


def _qos_sig(conf) -> Optional[tuple]:
    """The (weights, starvationBound) signature when QoS is enabled for
    this conf or the environment, else None (FIFO)."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.parallel import qos as Q
    if not Q.qos_enabled(conf):
        return None
    if conf is not None:
        return (str(conf.get(C.QOS_WEIGHTS)),
                max(int(conf.get(C.QOS_STARVATION_BOUND)), 1))
    return (str(C.QOS_WEIGHTS.default),
            max(int(C.QOS_STARVATION_BOUND.default), 1))


def get_query_manager(conf=None) -> QueryManager:
    """The process-wide manager, sized from the first conf seen (with the
    ``SRT_SCHEDULER_MAX_CONCURRENT`` override) and re-sized from a later
    conf only while idle: a running query never sees its bound change.
    The QoS gate and its weights and starvation bound take part in the
    same idle-only resize."""
    from spark_rapids_tpu_torch import config as C
    global _MANAGER
    want = None
    if conf is not None:
        want = (max(int(conf.get(C.SCHEDULER_MAX_CONCURRENT)), 1),
                max(int(conf.get(C.SCHEDULER_QUEUE_DEPTH)), 0),
                max(int(conf.get(C.SCHEDULER_ADMISSION_TIMEOUT_MS)), 1))
        env = _env_max_concurrent()
        if env is not None:
            want = (max(env, 1),) + want[1:]

    def build(sizes) -> QueryManager:
        from spark_rapids_tpu_torch.parallel import qos as Q
        sig = _qos_sig(conf)
        policy = Q.QosPolicy(*sig) if sig is not None else None
        return QueryManager(*sizes, qos=policy)

    with _MANAGER_LOCK:
        if _MANAGER is None:
            if want is None:
                env = _env_max_concurrent()
                want = (max(env, 1) if env else 2, 16, 60000)
            _MANAGER = build(want)
        elif want is not None and (
                (_MANAGER.max_concurrent, _MANAGER.queue_depth,
                 _MANAGER.admission_timeout_ms) != want
                or (_MANAGER._qos.sig if _MANAGER._qos is not None
                    else None) != _qos_sig(conf)):
            new_mgr = None
            with _MANAGER._lock:
                idle = not _MANAGER._active and not _MANAGER._waiters \
                    and (_MANAGER._qos is None
                         or len(_MANAGER._qos.queue) == 0)
                if idle:
                    # The idle check and the retirement are atomic under
                    # the old manager's lock: a racing admit either
                    # enqueued first (not idle) or follows the successor.
                    new_mgr = build(want)
                    _MANAGER._successor = new_mgr
            if new_mgr is not None:
                _MANAGER = new_mgr
        return _MANAGER


def note_pressure(score: float, conf=None) -> None:
    """Report a device collect's pressure score to the live manager; a
    no-op before any query built one."""
    with _MANAGER_LOCK:
        mgr = _MANAGER
    if mgr is not None:
        mgr.note_pressure(score, conf)


# An autoscaler's scale-up probe, consulted before brownout engages:
# called with the pressure score, True means a scale-up was accepted and
# the entry waits one more sustain window. The port has no cluster layer
# yet, so nothing registers one outside tests.
_SCALE_PROBE = None


def register_scale_probe(probe) -> None:
    """Install (or with ``None`` clear) the scale-up probe."""
    global _SCALE_PROBE
    _SCALE_PROBE = probe


def backoff_ms(hint_ms: Optional[float], attempt: int, seed: int,
               max_backoff_ms: float) -> float:
    """Deterministic-jitter client backoff: the retry hint stretched by a
    per-(client, attempt) jitter in [0, 25%), capped. Knuth
    multiplicative hashing instead of wall-clock randomness keeps a herd
    of clients spread out reproducibly."""
    base = float(hint_ms) if hint_ms and hint_ms > 0 else 250.0
    jitter = (((seed + 1) * 2654435761 + attempt * 40503) % 1000) / 4000.0
    return min(base * (1.0 + jitter), float(max_backoff_ms))


def collect_with_retry(attempt_fn, conf=None,
                       max_attempts: Optional[int] = None,
                       max_backoff_ms: Optional[float] = None,
                       seed: int = 0, sleep=time.sleep):
    """The client half of the backpressure contract: run one collect
    attempt; on a :class:`QueryRejectedError` with a ``retry_after_ms``
    hint, back off for the hint (plus the jitter of :func:`backoff_ms`,
    capped at ``client.retry.maxBackoffMs``) and resubmit, up to
    ``client.retry.maxAttempts`` attempts in all. A rejection without a
    hint re-raises at once. Every resubmission counts
    ``clientRetries`` and ``clientRetries.<kind>``."""
    from spark_rapids_tpu_torch import config as C
    if max_attempts is None:
        max_attempts = int(conf.get(C.CLIENT_RETRY_MAX_ATTEMPTS)) \
            if conf is not None \
            else int(C.CLIENT_RETRY_MAX_ATTEMPTS.default)
    if max_backoff_ms is None:
        max_backoff_ms = float(conf.get(C.CLIENT_RETRY_MAX_BACKOFF_MS)) \
            if conf is not None \
            else float(C.CLIENT_RETRY_MAX_BACKOFF_MS.default)
    max_attempts = max(int(max_attempts), 1)
    attempt = 0
    while True:
        try:
            return attempt_fn()
        except QueryRejectedError as e:
            attempt += 1
            if e.retry_after_ms is None or attempt >= max_attempts:
                raise
            delay_ms = backoff_ms(e.retry_after_ms, attempt, seed,
                                  max_backoff_ms)
            _record("clientRetries")
            _record(f"clientRetries.{e.kind}")
            from spark_rapids_tpu_torch.monitoring import telemetry
            if telemetry.enabled():
                telemetry.inc("srt_client_retries", kind=e.kind)
            sleep(delay_ms / 1000.0)


def query_memory_fraction(conf, manager: QueryManager) -> float:
    """The fair-share fraction of one admitted query's catalog budget:
    the conf's, or 1/maxConcurrentQueries when it is 0 (auto)."""
    from spark_rapids_tpu_torch import config as C
    frac = float(conf.get(C.SCHEDULER_QUERY_MEMORY_FRACTION))
    if frac <= 0:
        frac = 1.0 / manager.max_concurrent
    return min(max(frac, 0.01), 1.0)


class QueryHandle:
    """The async collect handle of ``DataFrame.submit()``: the query runs
    on a daemon thread; ``cancel()`` sets the shared cancel event, which
    works both while the query is queued (the admission wait aborts) and
    while it runs (the next checkpoint unwinds)."""

    def __init__(self, run_collect, timeout_ms: Optional[float] = None):
        self._cancel = threading.Event()
        self._rows = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()

        def work():
            try:
                self._rows = run_collect(self._cancel, timeout_ms)
            except BaseException as e:
                self._error = e
            finally:
                self._done.set()

        self._thread = threading.Thread(
            target=work, daemon=True, name="srt-query")
        self._thread.start()

    def cancel(self) -> None:
        self._cancel.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        """The rows on success; re-raises the query's error
        (``QueryCancelledError``, ``QueryRejectedError``, ...)."""
        if not self._done.wait(timeout):
            raise TimeoutError("query still running")
        if self._error is not None:
            raise self._error
        return self._rows
