"""Physical operator base (port of the JAX package's ``ops/base.py``).

A plan is a tree of ``Exec`` nodes; each node, per partition, produces an
iterator of ``DeviceBatch``es whose kernels are eager torch calls
(``execute_device``) or of ``HostBatch``es computed in numpy
(``execute_host``, the host engine). The planner picks one engine per
node and joins them with ``DeviceToHostExec`` / ``HostToDeviceExec``.
``Exec.collect`` runs every partition on the root's engine; on the device
it then downloads all result batches in one batched pass.

Each query's ``ExecContext`` owns a spill catalog (``memory/stores.py``)
that holds the exchanges' map-side pieces and the out-of-core operators'
staged batches; ``run_batches`` sets it as the active catalog of the OOM
ladder (``memory/oom.py``) and leaves the context open, so the planner's
recovery ladder (``plan/planner.py``) can re-run a query on it with its
still-materialized stage outputs; the owner of the context closes it
(``PhysicalPlan`` when its ladder ends, a standalone ``collect`` when it
is done). The
funnels that pull child streams (``collect`` and the exchange's map side)
go through ``Exec.execute_device_recovering``: an exhausted ladder there
tries the operator's on-device degraded mode (``_grace_retry``) and
otherwise raises; device work never moves to the host engine.

The same two funnels run their partition loop through the partition
pipeline (``parallel/pipeline.py``): a subtree with a file scan below it
(``host_prefetchable``) has its host half (``prefetch_host``: decode,
stats pruning, wire encode and pack) run on host threads ahead of the
ordered consumer, which makes every upload and launch. Before its
partition loop a device collect re-plans shuffled joins from observed
sizes (``parallel/replan.py``) and materializes independent stages at
once (``parallel/pipeline.py`` ``prematerialize_stages``). With
``spark.rapids.sql.watchdog.enabled`` each partition (and the partition
count) runs under the execution watchdog (``Exec._watchdog_run``): an
attempt past its deadline is killed and re-dispatched. The device work
of a collect (re-plan, stage pass, partition loop, download) holds one
permit of the process-wide device semaphore
(``memory/stores.py`` ``TpuSemaphore``, ``concurrentTpuTasks``); the
query's admission is the planner's (``parallel/scheduler.py``).

Every ``timed`` interval is also a flight-recorder span
(``monitoring/recorder.py``) and, while a torch profiler is recording,
a ``torch.profiler.record_function`` range named ``<Op>:<metric>``, so
a profiler capture attributes the kernels to their operators. The
collect funnel files its spans under the query's token
(``faults.QueryToken``) and counts ``srt_collects`` /
``srt_collect_ms`` into the telemetry registry.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import DeviceLike, faults, resolve_device
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.columnar.host import (
    HostBatch, download_batches, host_to_device)
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.exprs.base import island_sink
from spark_rapids_tpu_torch.memory import oom
from spark_rapids_tpu_torch.monitoring import recorder as _rec

_PROFILER = torch.autograd.profiler

Schema = Tuple[Tuple[str, DataType], ...]

_LOG = logging.getLogger("spark_rapids_tpu_torch")


class Metrics:
    """Per-operator metric registry (host-clock nanoseconds, counts).
    ``add`` is safe from the pipeline's prefetch threads."""

    def __init__(self, owner: str = ""):
        self.owner = owner
        self.values: Dict[str, float] = {}
        self.lock = threading.Lock()

    def add(self, name: str, amount: float):
        with self.lock:
            self.values[name] = self.values.get(name, 0) + amount

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"Metrics({self.values})"


# -- audit metric groups ------------------------------------------------------
# The registry of per-query audit entries (<Owner>@query) that the metrics
# verbosity filter (spark.rapids.sql.metrics.level) never drops: they are
# recovery and pipeline audit trails, not operator telemetry. Every
# subsystem creates its entry through query_metrics_entry(), which
# registers the owner here.
_AUDIT_METRIC_GROUPS = {"Recovery", "Pipeline"}
_AUDIT_LOCK = threading.Lock()


def register_audit_metric_group(owner: str) -> None:
    """Mark ``owner`` as a level-filter-exempt audit group (idempotent)."""
    with _AUDIT_LOCK:
        _AUDIT_METRIC_GROUPS.add(owner)


def audit_metric_groups() -> frozenset:
    with _AUDIT_LOCK:
        return frozenset(_AUDIT_METRIC_GROUPS)


def record_batch(m: Metrics, batch) -> None:
    """Count one output batch, and its rows where they are known on the
    host: a device batch's ``rows_hint``, a host batch's ``num_rows``
    (never forces a device sync)."""
    m.add("numOutputBatches", 1)
    rows = getattr(batch, "rows_hint", None)
    if rows is None and isinstance(batch, HostBatch):
        rows = batch.num_rows
    if rows is not None:
        m.add("numOutputRows", int(rows))


# ExecContext.cache entries that outlive close(): the query's identity.
_KEPT_ON_CLOSE = ("trace_query", "plan_binds", "plan_bind_dtypes")


@dataclasses.dataclass
class ExecContext:
    """Per-query execution context: conf, per-operator metrics, a
    per-query cache (a broadcast join's built side, shared across its
    probe partitions; an exchange's map-side pieces, as spillable
    handles) and the query's spill catalog.

    ``close`` (the context's owner calls it when the query ends: the
    planner after its recovery ladder, a standalone ``Exec.collect``)
    runs the ``on_close`` hooks (a broadcast drops its single), closes
    every shuffle transport session the cache holds (each exchange's
    shards), records
    the catalog's leak report in ``last_leak_report`` (``[]``: the query
    freed all it registered) and its counters in ``last_spill_metrics``,
    and empties the cache but for the query's identity: ``trace_query``
    (the flight-recorder ring its events went to) and the plan cache's
    binding vector, which ``explain_analyze`` and the event log read
    after the collect.

    ``query`` is the admitting scheduler's ticket
    (``parallel/scheduler.py``): its query id tags the catalog's buffers,
    and its manager's fair share scales the catalog's budget. None: an
    unmanaged context (a standalone ``Exec.collect``, unit tests), with
    the full budget and no owner."""

    conf: TpuConf = dataclasses.field(default_factory=TpuConf)
    metrics: Dict[str, Metrics] = dataclasses.field(default_factory=dict)
    cache: Dict[str, Any] = dataclasses.field(default_factory=dict)
    query: Optional[Any] = None
    last_leak_report: Optional[list] = None
    last_spill_metrics: Optional[Dict[str, int]] = None
    on_close: List[Any] = dataclasses.field(default_factory=list)
    _catalog: Optional[Any] = None
    _lock: Any = dataclasses.field(default_factory=threading.Lock,
                                   repr=False, compare=False)

    def metrics_for(self, op: "Exec") -> Metrics:
        key = f"{op.name}@{id(op):x}"
        m = self.metrics.get(key)
        if m is None:
            # setdefault: a prefetch thread and the consumer may ask at
            # once, and both must get the one entry.
            m = self.metrics.setdefault(key, Metrics(owner=op.name))
        return m

    @property
    def catalog(self):
        """The query's spill catalog, built on first use under the
        context's lock (stage threads and a neighbor's eviction read it
        from other threads; two catalogs must never race into being):
        its device budget is ``spark.rapids.memory.tpu.budgetBytes`` or,
        when that is 0, ``allocFraction`` of the visible device memory
        capped at ``maxAllocFraction`` of it less ``reserve`` (at least
        1 MiB); for an admitted query, times
        ``scheduler.queryMemoryFraction``, with the query id as the
        buffers' owner tag."""
        if self._catalog is None:
            with self._lock:
                if self._catalog is not None:
                    return self._catalog
                from spark_rapids_tpu_torch import config as C
                from spark_rapids_tpu_torch.memory.stores import \
                    BufferCatalog
                budget = int(self.conf.get(C.DEVICE_BUDGET_BYTES))
                if budget <= 0:
                    visible = _visible_device_bytes()
                    budget = int(visible * self.conf.get(C.HBM_POOL_FRACTION))
                    ceiling = int(visible *
                                  self.conf.get(C.MAX_ALLOC_FRACTION)) \
                        - int(self.conf.get(C.RESERVE_BYTES))
                    budget = max(min(budget, ceiling), 1 << 20)
                owner = None
                if self.query is not None:
                    from spark_rapids_tpu_torch.parallel import \
                        scheduler as SC
                    frac = SC.query_memory_fraction(
                        self.conf, SC.get_query_manager(self.conf))
                    # The share never raises a budget (port-only: the
                    # reference floors it at 1 MiB, which lifts an
                    # explicit budget below that even at 1.0).
                    budget = max(int(budget * frac),
                                 min(budget, 1 << 20))
                    owner = self.query.query_id
                self._catalog = BufferCatalog(
                    device_budget_bytes=budget,
                    host_budget_bytes=int(
                        self.conf.get(C.HOST_SPILL_STORAGE_SIZE)),
                    spill_dir=str(self.conf.get(C.SPILL_DIR)),
                    compression_codec=str(
                        self.conf.get(C.SHUFFLE_COMPRESSION_CODEC)),
                    debug=bool(self.conf.get(C.MEMORY_DEBUG)),
                    owner=owner)
        return self._catalog

    def close(self):
        """Query teardown (see the class doc); the metrics stay."""
        hooks, self.on_close = self.on_close, []
        for hook in hooks:
            hook()
        # Shuffle transport sessions (parallel/transport/) own their
        # shards (catalog handles, spool files, objects): teardown closes
        # every session the cache still holds, whether the query
        # succeeded, failed or was cancelled.
        from spark_rapids_tpu_torch.parallel.transport.base import \
            ShuffleSession
        for v in list(self.cache.values()):
            if isinstance(v, ShuffleSession):
                v.close()
        kept = {k: self.cache[k] for k in _KEPT_ON_CLOSE if k in self.cache}
        self.cache.clear()
        self.cache.update(kept)
        if self._catalog is not None:
            self.last_leak_report = self._catalog.leak_report()
            self.last_spill_metrics = dict(self._catalog.metrics)
            self._catalog.close()
            self._catalog = None


def query_metrics_entry(ctx: ExecContext, owner: str) -> Metrics:
    """The per-query ``<owner>@query`` audit metrics entry, registered as
    level-filter exempt (``Recovery`` holds retriesAttempted,
    spillEscalations, faultsInjected and the grace join's counts;
    ``Pipeline`` the partition pipeline's counters)."""
    register_audit_metric_group(owner)
    key = f"{owner}@query"
    m = ctx.metrics.get(key)
    if m is None:
        m = ctx.metrics.setdefault(key, Metrics(owner=owner))
    return m


def _visible_device_bytes() -> int:
    """Total memory of the current CUDA device; 8 GiB (the JAX package's
    fallback) where there is none."""
    import torch
    if torch.cuda.is_available():
        return int(torch.cuda.mem_get_info()[1])
    return 8 << 30


# Flight-recorder category per timed() metric: operator dispatch is
# device-compute; scan decode/buffer work is host-side; shuffle and
# sizes-pull syncs label themselves.
_TIMED_CATS = {"bufferTime": "host-prefetch", "shuffleTime": "shuffle",
               "sizesPullTime": "sync"}


class timed:
    """Context manager adding elapsed host-clock ns to a metric. Kernels
    are asynchronous on the card, so on CUDA this measures dispatch, not
    device time. The same interval records as a flight-recorder span
    (category by metric, ``_TIMED_CATS``) and, while a torch profiler is
    recording, as a ``record_function`` range ``<Op>:<metric>`` (the
    NvtxWithMetrics.scala:21-44 analog; outside a capture the range is
    skipped, as a JAX TraceAnnotation costs nothing outside a trace).
    Inside it, host roundtrips of expressions
    (``exprs.base.host_roundtrip``) count into ``metrics``."""

    __slots__ = ("metrics", "name", "token", "t0", "_ann", "_span")

    def __init__(self, metrics: Metrics, name: str = "totalTime"):
        self.metrics = metrics
        self.name = name

    def __enter__(self):
        self.token = island_sink.set(self.metrics)
        owner = self.metrics.owner or "op"
        self._ann = None
        if _PROFILER._is_profiler_enabled:
            self._ann = torch.profiler.record_function(
                f"{owner}:{self.name}")
            self._ann.__enter__()
        self._span = _rec.span(
            owner, _TIMED_CATS.get(self.name, "device-compute"),
            _rec.LEVEL_OPERATOR,
            args=None if self.name == "totalTime" else {"metric": self.name})
        self._span.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.metrics.add(self.name, time.perf_counter_ns() - self.t0)
        self._span.__exit__(None, None, None)
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
        island_sink.reset(self.token)
        return False


class WatchdogTimeoutError(RuntimeError):
    """Every watchdog attempt at a unit of work exceeded its deadline.
    The message carries the DEADLINE_EXCEEDED marker, so the planner's
    transient retry is the next rung of the recovery ladder."""

    def __init__(self, op: str, label: str, timeout_ms: int,
                 attempts: int):
        super().__init__(
            f"DEADLINE_EXCEEDED: watchdog killed {op} {label} on all "
            f"{attempts} attempt(s) of {timeout_ms}ms "
            "(spark.rapids.sql.watchdog.*)")
        self.label = label


@dataclasses.dataclass
class _WatchdogParams:
    timeout_ms: int
    max_attempts: int


def _watchdog_params(conf: TpuConf) -> Optional[_WatchdogParams]:
    from spark_rapids_tpu_torch import config as C
    if not bool(conf.get(C.WATCHDOG_ENABLED)):
        return None
    return _WatchdogParams(
        timeout_ms=max(int(conf.get(C.WATCHDOG_TASK_TIMEOUT_MS)), 1),
        max_attempts=max(int(conf.get(C.WATCHDOG_MAX_ATTEMPTS)), 1))


class Exec:
    """A physical operator. ``schema`` is the output schema."""

    def __init__(self, *children: "Exec"):
        self.children: Tuple["Exec", ...] = tuple(children)

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__

    def num_partitions(self, ctx: ExecContext) -> int:
        return self.children[0].num_partitions(ctx)

    def execute_device(self, ctx: ExecContext,
                       partition: int) -> Iterator[DeviceBatch]:
        raise NotImplementedError

    def execute_host(self, ctx: ExecContext,
                     partition: int) -> Iterator[HostBatch]:
        raise NotImplementedError

    def host_prefetchable(self) -> bool:
        """True when this subtree has a separable host half worth
        prefetching: a file scan below, with no exchange between (an
        exchange pipelines its own map-side loop)."""
        from spark_rapids_tpu_torch.parallel.stages import \
            is_stage_boundary
        return any(c.host_prefetchable() for c in self.children
                   if not is_stage_boundary(c))

    def prefetch_host(self, ctx: ExecContext, partition: int) -> None:
        """Run the host half of ``partition`` ahead of its device half
        (decode, stats pruning, wire encode and pack: everything before
        the upload), on a pipeline prefetch thread. Results land in
        ``ctx.cache`` keyed by (node, partition) and the ordered
        consumer's ``execute_device`` pops them, so a prefetch that is
        never consumed costs CPU only, never rows. Recursion stops at
        exchanges: partition numbering changes there."""
        from spark_rapids_tpu_torch.parallel.stages import \
            is_stage_boundary
        for c in self.children:
            if not is_stage_boundary(c):
                c.prefetch_host(ctx, partition)

    def drop_prefetch(self, ctx: ExecContext) -> None:
        """Drop the prefetched payloads in ``ctx.cache`` that no consumer
        took (a partition loop that stopped early or failed), so none
        stays pinned in the context. Reaches what ``prefetch_host``
        reaches."""
        from spark_rapids_tpu_torch.parallel.stages import \
            is_stage_boundary
        for c in self.children:
            if not is_stage_boundary(c):
                c.drop_prefetch(ctx)

    def _grace_retry(self, ctx: ExecContext, partition: int):
        """The operator's on-device OOM rung above the ladder: a
        replacement device iterator (the shuffled hash join's grace path)
        or None."""
        return None

    def execute_device_recovering(self, ctx: ExecContext,
                                  partition: int) -> Iterator[DeviceBatch]:
        """The device stream with the operator's last OOM rung: when the
        device path dies on an exhausted ladder (``OomRetryExhausted``)
        before its first batch, offer the operator's on-device degraded
        mode (``_grace_retry``); where there is none, or it fails too,
        the error propagates. After the first batch the consumer has seen
        device output, so a later failure propagates rather than
        duplicating rows."""
        it = self.execute_device(ctx, partition)
        try:
            first = next(it)
        except StopIteration:
            return
        except oom.OomRetryExhausted as e:
            grace_it = self._grace_retry(ctx, partition)
            if grace_it is None:
                raise
            _LOG.warning("OOM ladder exhausted in %s partition %d; "
                         "retrying on the device through the grace path: "
                         "%s", self.name, partition, e)
            from spark_rapids_tpu_torch import monitoring
            monitoring.instant("grace-join-engaged", "recovery",
                               args={"op": self.name,
                                     "partition": partition})
            yield from grace_it
            return
        yield first
        yield from it

    def _watchdog_run(self, ctx: ExecContext, wd: _WatchdogParams,
                      label: str, fn):
        """Run one unit of device work (a partition's stream, the
        partition count, a stage's materialization) under the execution
        watchdog: a deadline with bounded re-dispatch, the speculative
        re-execution half of the fault story (Dean & Ghemawat, MapReduce,
        OSDI 2004), scoped to a partition.

        Attempts run one after another, each on its own
        ``srt-watchdog-*`` thread carrying the query's catalog, recovery
        sink, token and the attempt's cancel event, on the plan's device.
        The first attempt to complete within its deadline wins; a killed
        attempt's output is dropped whole (the work is pure batch ->
        batch, so any winner gives the same rows). Kills are cooperative:
        an injected stall, and a consumer waiting on a prefetch, unwind
        on the cancel event; kernels the killed attempt already queued
        still run, and its tensors are freed when its thread unwinds."""
        from spark_rapids_tpu_torch import monitoring
        from spark_rapids_tpu_torch.parallel.pipeline import device_scope
        timeout_s = wd.timeout_ms / 1000.0
        catalog = oom.get_active_catalog()
        sink = faults.get_recovery_sink()
        token = faults.get_query_token()
        device = self.plan_device()
        for attempt in range(wd.max_attempts):
            cancel = threading.Event()
            box: Dict[str, Any] = {}

            def work():
                # Thread-locals do not cross threads.
                oom.set_active_catalog(catalog, sink)
                faults.set_query_token(token)
                faults.set_cancel_event(cancel)
                try:
                    with device_scope(device):
                        box["out"] = fn()
                except BaseException as e:
                    box["err"] = e
                finally:
                    faults.set_cancel_event(None)
                    faults.set_query_token(None)
                    oom.set_active_catalog(None)

            t = threading.Thread(
                target=work, daemon=True,
                name=f"srt-watchdog-{label}-a{attempt}")
            t.start()
            t.join(timeout_s)
            if not t.is_alive():
                err = box.get("err")
                if err is not None:
                    raise err
                return box["out"]
            cancel.set()
            faults.record("watchdogKills")
            ctx.metrics_for(self).add("watchdogKills", 1)
            monitoring.instant("watchdog-kill", "recovery",
                               args={"op": self.name, "label": label,
                                     "attempt": attempt + 1})
            _LOG.warning("watchdog: %s %s exceeded %dms (attempt %d/%d); "
                         "killing and %s", self.name, label, wd.timeout_ms,
                         attempt + 1, wd.max_attempts,
                         "re-dispatching" if attempt + 1 < wd.max_attempts
                         else "giving up")
            # A cooperatively cancelled attempt unwinds at once, so the
            # re-dispatch rarely overlaps the old thread.
            t.join(0.2)
            if attempt + 1 < wd.max_attempts:
                faults.record("partitionRetries")
        raise WatchdogTimeoutError(self.name, label, wd.timeout_ms,
                                   wd.max_attempts)

    def plan_device(self):
        """The device this plan's source uploads to."""
        dev = getattr(self, "device", None)
        if dev is not None:
            return dev
        for c in self.children:
            dev = c.plan_device()
            if dev is not None:
                return dev
        return None

    def collect(self, ctx: Optional[ExecContext] = None,
                device: bool = True) -> List[tuple]:
        """Run all partitions on the device engine, then download every
        result batch in one batched pass and return the rows; with
        ``device=False`` run them on the host engine."""
        rows: List[tuple] = []
        for hb in self.collect_batches(ctx, device):
            rows.extend(hb.to_pylist())
        return rows

    def collect_batches(self, ctx: Optional[ExecContext] = None,
                        device: bool = True) -> List[HostBatch]:
        """``collect`` as host batches (numpy columns), before the rows
        are made: one standalone query, which restores a batch target
        an earlier query's OOM ladder degraded, runs ``run_batches`` and
        closes the context when it ends."""
        ctx = ctx or ExecContext()
        oom.reset_degradation()
        try:
            return self.run_batches(ctx, device)
        finally:
            ctx.close()

    def run_batches(self, ctx: ExecContext,
                    device: bool = True) -> List[HostBatch]:
        """One attempt at the query on ``ctx``, which stays open (its
        owner closes it). The query's catalog is the ladder's active
        catalog while it runs (and its ``Recovery@query`` entry the
        recovery sink). On the device engine, under one permit of the
        device semaphore, the runtime re-plan and the concurrent stage
        pass run first, then the ordered partition loop (under the
        watchdog when it is on; each partition boundary a cancellation
        and a preemption checkpoint), then one batched download. The
        whole call is the query's ``collect`` span, each partition a
        ``partition`` span and the result copy a ``download`` span."""
        # The engine the query's root runs on: exchanges coalesce their
        # partitions only under the device engine.
        ctx.cache.setdefault("engine", "device" if device else "host")
        # Adopt this query's wire codec (process-global,
        # spark.rapids.sql.wire.codec) before any upload happens, its
        # flight-recorder and telemetry configuration before any span
        # site runs (spark.rapids.sql.trace.* / metrics.*), its
        # spark.rapids.sql.native.* gates and its preemption setting.
        from spark_rapids_tpu_torch import monitoring
        from spark_rapids_tpu_torch.columnar import wire
        from spark_rapids_tpu_torch.memory import stores
        from spark_rapids_tpu_torch.monitoring import telemetry
        from spark_rapids_tpu_torch.ops import native
        wire.maybe_configure(ctx.conf)
        monitoring.maybe_configure(ctx.conf)
        telemetry.maybe_configure(ctx.conf)
        native.maybe_configure(ctx.conf)
        stores.preemption_configure(ctx.conf)
        t0 = time.perf_counter()
        collect_span = monitoring.span(
            "collect", "query", level=monitoring.LEVEL_QUERY,
            args={"op": self.name} if device
            else {"op": self.name, "engine": "host"})
        collect_span.__enter__()
        try:
            # Device subtrees under a host root register into the catalog
            # too; the recovery sink mirrors ladder and injection counters
            # into this query's Recovery@query entry.
            oom.set_active_catalog(ctx.catalog,
                                   query_metrics_entry(ctx, "Recovery"))
            if not device:
                out: List[HostBatch] = []
                for p in range(self.num_partitions(ctx)):
                    with monitoring.span("partition", "host-compute",
                                         args={"partition": p,
                                               "op": self.name}):
                        out.extend(self.execute_host(ctx, p))
                return out
            from spark_rapids_tpu_torch import config as C
            # Task admission (GpuSemaphore.scala:74-87): at most
            # concurrentTpuTasks queries issue device work at once. The
            # permit covers the re-plan, the stage pass, the partition
            # loop and the download; the caller makes the rows from the
            # host batches outside it.
            sem = stores.get_tpu_semaphore(
                max(int(ctx.conf.get(C.CONCURRENT_TPU_TASKS)), 1))
            with sem:
                return self._device_batches(ctx)
        finally:
            oom.set_active_catalog(None)
            collect_span.__exit__(None, None, None)
            # Live telemetry of a device collect: one counter inc + one
            # histogram observe, the spill catalog's tier occupancy and
            # device high watermark, and its pressure score, which feeds
            # the admission brownout (parallel/scheduler.py).
            cat = ctx._catalog if device else None
            if device:
                telemetry.inc("srt_collects")
                telemetry.observe("srt_collect_ms",
                                  (time.perf_counter() - t0) * 1e3)
            if cat is not None:
                from spark_rapids_tpu_torch.parallel import scheduler as SC
                score = stores.pressure_score(cat)
                if telemetry.enabled():
                    telemetry.set_gauge("srt_pressure_score", score)
                SC.note_pressure(score, ctx.conf)
            if cat is not None and telemetry.enabled():
                telemetry.set_gauge("srt_memory_bytes", cat.device_bytes,
                                    tier="device")
                telemetry.set_gauge("srt_memory_bytes", cat.host_bytes,
                                    tier="host")
                telemetry.set_gauge("srt_memory_bytes", cat.disk_bytes,
                                    tier="disk")
                telemetry.set_gauge("srt_device_budget_bytes",
                                    cat.device_budget)
                telemetry.max_gauge("srt_device_watermark_bytes",
                                    cat.device_bytes)
            if device:
                # Cost-model self-calibration: this query's observed sync
                # span mean and upload throughput (and its Cost@query
                # estimateErrorPct as a damper) fold into the placement
                # model's effective constants (plan/cost.py). A no-op
                # with tracing off or calibration disabled.
                from spark_rapids_tpu_torch.plan import cost as COST
                try:
                    COST.observe_query(ctx)
                except Exception:   # calibration never fails a query
                    _LOG.warning("cost calibration skipped", exc_info=True)

    def _device_batches(self, ctx: ExecContext) -> List[HostBatch]:
        """The device half of ``run_batches``, under the permit."""
        from spark_rapids_tpu_torch import monitoring
        from spark_rapids_tpu_torch.parallel import pipeline as PL
        from spark_rapids_tpu_torch.parallel import replan as RP
        # Runtime re-plan before the stage pass: build-side exchanges
        # materialize now, observed sizes demote shuffled joins to
        # broadcast, and the skipped probe exchanges are flagged so the
        # stage pass does not shuffle them anyway.
        RP.plan_adaptive(ctx, self)
        # Independent stages (a join's two sides) materialize their
        # exchange outputs at once before the ordered partition loop; a
        # no-op when the pipeline is off or the plan has one stage.
        PL.prematerialize_stages(ctx, self)
        wd = _watchdog_params(ctx.conf)
        batches: List[DeviceBatch] = []
        if wd is None:
            nparts = self.num_partitions(ctx)
        else:
            # The partition count can itself do device work (the
            # coalescing exchange materializes to learn its sizes), so it
            # runs under the watchdog too.
            nparts = self._watchdog_run(
                ctx, wd, "partition-count",
                lambda: self.num_partitions(ctx))
        # consume() waits for p's host half, then returns the device
        # stream verbatim; the serial pipeline just streams.
        pipe = PL.open_pipeline(ctx, self, nparts)
        try:
            for p in range(nparts):
                # Per-partition cancellation checkpoint (the deep funnels
                # check too, through fault_point) and the preemption
                # checkpoint, which fires only at this boundary.
                faults.check_cancelled()
                faults.check_preempted()
                with monitoring.span("partition", "device-compute",
                                     args={"partition": p,
                                           "op": self.name}):
                    if wd is None:
                        batches.extend(pipe.consume(
                            p, lambda p=p:
                            self.execute_device_recovering(ctx, p)))
                    else:
                        # The pipeline's wait for p's host half runs
                        # inside the deadline: a stalled prefetch is
                        # killed with its attempt.
                        batches.extend(self._watchdog_run(
                            ctx, wd, f"partition {p}",
                            lambda p=p: pipe.consume(
                                p, lambda: list(
                                    self.execute_device_recovering(
                                        ctx, p)))))
        finally:
            pipe.close()
        names = tuple(n for n, _ in self.schema)
        with monitoring.span("download", "device-compute",
                             args={"batches": len(batches)}):
            return oom.retry_on_oom(download_batches, batches, names)


class LeafExec(Exec):
    """Base for source nodes."""

    def num_partitions(self, ctx: ExecContext) -> int:
        raise NotImplementedError


class InMemorySourceExec(LeafExec):
    """In-memory host-batch source, pre-partitioned; uploads each batch to
    ``device`` (``None`` = the CUDA card, raising when there is none)
    through the wire codec.

    The host batches never change and their staging bytes are a pure
    function of batch and codec mode, so each partition is encoded and
    packed once per mode and kept; every collect then only copies and
    decodes. Consecutive packed batches below
    ``spark.rapids.sql.wire.minUploadBytes`` share one copy. On the host
    engine it yields its host batches as they are."""

    def __init__(self, schema: Schema,
                 partitions: Sequence[Sequence[HostBatch]],
                 device: DeviceLike = None):
        super().__init__()
        self._schema = tuple(schema)
        self._partitions = [list(p) for p in partitions]
        self._packed: Dict[Tuple[str, int], list] = {}
        self.device = resolve_device(device)

    @property
    def schema(self) -> Schema:
        return self._schema

    def num_partitions(self, ctx: ExecContext) -> int:
        return len(self._partitions)

    def packed(self, partition: int) -> list:
        """The partition's ``EncodedBatch``es under the current codec
        mode, packed on first use."""
        from spark_rapids_tpu_torch.columnar import wire
        key = (wire.codec_mode(), partition)
        encs = self._packed.get(key)
        if encs is None:
            encs = self._packed[key] = [
                wire.pack_batch(hb) for hb in self._partitions[partition]]
        return encs

    def execute_device(self, ctx, partition):
        from spark_rapids_tpu_torch import config as C
        from spark_rapids_tpu_torch.columnar import wire
        m = ctx.metrics_for(self)
        with timed(m, "packTime"):
            encs = self.packed(partition)
        groups = wire.plan_upload_groups(
            [e.nbytes for e in encs],
            int(ctx.conf.get(C.WIRE_MIN_UPLOAD_BYTES)))
        for g in groups:
            with timed(m, "uploadTime"):
                outs = oom.retry_on_oom(wire.upload_packed_group,
                                        [encs[i] for i in g], self.device)
            for out in outs:
                record_batch(m, out)
                yield out

    def execute_host(self, ctx, partition):
        yield from iter(self._partitions[partition])


class DeviceToHostExec(Exec):
    """Device -> host transition (GpuColumnarToRowExec analog): runs the
    child on the device engine and downloads each partition's batches
    with one batched copy. Its metrics: ``deviceTime`` (the device
    subtree's dispatch), ``downloadTime`` (the copy, which waits for the
    device work), ``downloadRows`` and ``downloadBytes``."""

    def __init__(self, child: Exec):
        super().__init__(child)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute_host(self, ctx, partition):
        m = ctx.metrics_for(self)
        with timed(m, "deviceTime"):
            batches = list(self.children[0].execute_device(ctx, partition))
        moved: Dict[str, int] = {}
        with timed(m, "downloadTime"):
            hbs = download_batches(batches, tuple(n for n, _ in self.schema),
                                   moved)
        m.add("downloadRows", moved.get("rows", 0))
        m.add("downloadBytes", moved.get("bytes", 0))
        yield from hbs

    def execute_device(self, ctx, partition):  # pragma: no cover
        raise AssertionError("DeviceToHostExec is a host-side node")


class HostToDeviceExec(Exec):
    """Host -> device transition (GpuRowToColumnarExec analog): runs the
    child on the host engine and uploads each batch to ``device`` (None:
    the plan's source device) with the plain wire layout. ``hostTime``
    is the host clock spent pulling from the child: the host subtree,
    and any device subtree below it, whose share its
    ``DeviceToHostExec``s record."""

    def __init__(self, child: Exec, device: DeviceLike = None):
        super().__init__(child)
        self.device = None if device is None else resolve_device(device)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def host_prefetchable(self) -> bool:
        # The subtree below runs on the host engine, which reads no
        # prefetched payload: prefetching it would decode twice.
        return False

    def prefetch_host(self, ctx, partition):
        return None

    def execute_device(self, ctx, partition):
        m = ctx.metrics_for(self)
        dev = self.plan_device()
        it = self.children[0].execute_host(ctx, partition)
        while True:
            with timed(m, "hostTime"):
                hb = next(it, None)
            if hb is None:
                return
            with timed(m, "uploadTime"):
                out = oom.retry_on_oom(host_to_device, hb, device=dev,
                                       mode="plain")
            record_batch(m, out)
            yield out

    def execute_host(self, ctx, partition):  # pragma: no cover
        raise AssertionError("HostToDeviceExec is a device-side node")
