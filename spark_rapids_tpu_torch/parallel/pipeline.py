"""Pipelined partition executor: overlap host decode and encode with
device work, and materialize independent stages at once (port of the JAX
package's ``parallel/pipeline.py``).

A bounded host thread pool runs the separable host half of each partition
(everything an ``Exec.prefetch_host`` hook does before the upload: a file
scan's stats pruning, unit decode, wire encode and pack)
``prefetchPartitions`` ahead of one ordered consumer that makes every
upload and every launch. Prefetch threads touch no CUDA API and no tensor
on the card: a torch call made there would run on that thread's default
stream, outside the consumer's order. Results therefore come in the
serial order, the upload of partition p+1 overlaps the device work of p,
and an error raised in a prefetch (a ``scan`` fault, ``faults.py``) is
re-raised where the consumer takes that partition, where the serial path
would have raised it. Each prefetch task runs under the consumer's query
token, recovery sink and active catalog, and its own cancel event, in a
``prefetch`` span; a consumer that waits for one does so in a
``pipeline-wait`` span, polling the query's token and the watchdog's
cancel event: a killed attempt (``ops/base.py`` ``_watchdog_run``)
cancels the partition's prefetch, which unwinds an injected stall, and
its re-dispatch recomputes the host half inline.

:func:`prematerialize_stages` runs the plan's independent stages (the
stage DAG of ``parallel/stages.py``) before the ordered partition loop:
in bottom-up waves, a wave of one inline, a larger one on ``srt-stage-*``
threads, at most ``pipeline.maxConcurrentStages`` at once. Each thread
carries the query's token, recovery sink and active catalog, and runs on
the plan's device; its launches go to that thread's current stream,
which is the device's default stream (the port makes no side stream), so
they stay ordered with the consumer's. A failure in a wave re-raises the
one of the smallest stage id, where the serial pull would have hit
first, to the planner's recovery ladder. Where every failure of a wave
is a device OOM, the failed stages run again one at a time instead
(``serialStageRetries``; port-only): side by side, each stage's working
set sits beside the other's, which no spill of the catalog reaches, and
a failed materialization leaves nothing behind.

The pipeline runs at the two partition loops that pull a subtree's
partitions: ``Exec.collect`` and the exchange's map side
(``parallel/exchange.py``). Its threads (``hostThreads``, at most one a
partition) and a MULTITHREADED reader's (``numThreads``, at most one a
unit) hand a large batch's column encodes to ``columnar/wire.py``'s
encode pool and wait for them; the encode pool's own tasks never wait on
a pool, so however many submitters wait, the pool drains.

``spark.rapids.sql.pipeline.enabled=false`` or ``SRT_PIPELINE=0`` gives
the serial dispatch exactly: :func:`open_pipeline` then returns the
no-op serial pipeline and no thread is created. So does a loop of one
partition, or a subtree with no separable host half (no file scan below
it without an exchange between).

Counters (process-global here, and the per-query ``Pipeline@query``
metrics entry): ``hostPrefetchMs``, ``consumerWaitMs``,
``pipelineStalls``, ``prefetchedPartitions``, ``stagingBytesPrefetched``,
``concurrentStages`` (the stages of each concurrent wave),
``serialStageRetries`` and the derived ``overlapRatio`` (the share of
host-prefetch time the
consumer did not wait for: 0 means the pipeline degenerated to serial, 1
that the decode was hidden behind device work).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import logging
import os
import threading
import time
import traceback
from typing import Dict, Optional

_LOG = logging.getLogger("spark_rapids_tpu_torch.pipeline")

_COUNTER_LOCK = threading.Lock()
_COUNTERS: Dict[str, float] = {}


def _record(ctx, name: str, amount: float) -> None:
    with _COUNTER_LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + amount
    if ctx is not None:
        metrics_entry(ctx).add(name, amount)


def record(ctx, name: str, amount: float) -> None:
    """Counter hook for prefetch-side producers (the scan's staging bytes,
    io/scan.py): counts land in the process-global counters and in the
    query's ``Pipeline@query`` entry."""
    _record(ctx, name, amount)


def counters() -> Dict[str, float]:
    """Process-global pipeline counters, with overlapRatio derived."""
    with _COUNTER_LOCK:
        out = dict(_COUNTERS)
    return _with_overlap_ratio(out)


def reset_counters() -> None:
    with _COUNTER_LOCK:
        _COUNTERS.clear()


def _with_overlap_ratio(vals: Dict[str, float]) -> Dict[str, float]:
    prefetch = vals.get("hostPrefetchMs", 0.0)
    if prefetch > 0:
        waited = min(vals.get("consumerWaitMs", 0.0), prefetch)
        vals["overlapRatio"] = round(1.0 - waited / prefetch, 4)
    return vals


def metrics_entry(ctx):
    """The per-query ``Pipeline@query`` metrics entry."""
    from spark_rapids_tpu_torch.ops.base import query_metrics_entry
    return query_metrics_entry(ctx, "Pipeline")


def finalize_metrics(ctx) -> None:
    """Recompute the query's overlapRatio from its cumulative ms counters
    (a ratio does not add across the query's pipelines)."""
    m = ctx.metrics.get("Pipeline@query")
    if m is not None:
        with m.lock:
            _with_overlap_ratio(m.values)


@dataclasses.dataclass(frozen=True)
class PipelineParams:
    prefetch_partitions: int
    host_threads: int
    max_concurrent_stages: int


def params_of(conf) -> Optional[PipelineParams]:
    """Resolved pipeline parameters, or None when the pipeline is off
    (the conf, or ``SRT_PIPELINE=0``)."""
    from spark_rapids_tpu_torch import config as C
    if os.environ.get("SRT_PIPELINE", "").strip() == "0":
        return None
    if not bool(conf.get(C.PIPELINE_ENABLED)):
        return None
    return PipelineParams(
        prefetch_partitions=max(
            int(conf.get(C.PIPELINE_PREFETCH_PARTITIONS)), 1),
        host_threads=max(int(conf.get(C.PIPELINE_HOST_THREADS)), 1),
        max_concurrent_stages=max(
            int(conf.get(C.PIPELINE_MAX_CONCURRENT_STAGES)), 1))


class _ConsumeCancelled(RuntimeError):
    """The watchdog killed the consuming attempt while it waited on a
    prefetch; the abandoned attempt thread unwinds on this (the watchdog
    has already dropped the attempt)."""


class _SerialPipeline:
    """The disabled pipeline: ``consume`` runs the partition inline, with
    no thread, no buffering and no counter."""

    def consume(self, partition: int, fn):
        return fn()

    def close(self):
        pass


class PartitionPipeline:
    """Bounded producer/consumer over one partition loop.

    Producers run ``source.prefetch_host(ctx, p)`` for partitions up to
    ``prefetch_partitions`` ahead of the consumer; the consumer calls
    :meth:`consume` in strict partition order from one thread, so the
    order of uploads and launches, and of the rows, is the serial
    path's."""

    def __init__(self, ctx, source, nparts: int, params: PipelineParams):
        from spark_rapids_tpu_torch import faults
        from spark_rapids_tpu_torch.memory import oom
        # Thread-locals do not cross threads: each prefetch task takes
        # over the consumer's query token (its ring and fault tag), its
        # recovery sink and its active catalog.
        self._token = faults.get_query_token()
        self._sink = faults.get_recovery_sink()
        self._catalog = oom.get_active_catalog()
        self._ctx = ctx
        self._source = source
        self._nparts = nparts
        self._depth = params.prefetch_partitions
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=min(params.host_threads, max(nparts, 1)),
            thread_name_prefix="srt-prefetch")
        self._futures: Dict[int, concurrent.futures.Future] = {}
        self._cancels: Dict[int, threading.Event] = {}
        self._consumed: set = set()
        self._submitted = -1
        self._closed = False

    def _prefetch_task(self, partition: int, cancel) -> None:
        from spark_rapids_tpu_torch import faults, monitoring
        from spark_rapids_tpu_torch.memory import oom
        faults.set_query_token(self._token)
        oom.set_active_catalog(self._catalog, self._sink)
        faults.set_cancel_event(cancel)
        t0 = time.perf_counter()
        try:
            if not self._closed and not cancel.is_set():
                with monitoring.span("prefetch", "host-prefetch",
                                     args={"partition": partition}):
                    self._source.prefetch_host(self._ctx, partition)
        finally:
            faults.set_cancel_event(None)
            oom.set_active_catalog(None)
            faults.set_query_token(None)
            _record(self._ctx, "hostPrefetchMs",
                    (time.perf_counter() - t0) * 1000.0)
            _record(self._ctx, "prefetchedPartitions", 1)

    def _ensure_submitted(self, upto: int) -> None:
        upto = min(upto, self._nparts - 1)
        while self._submitted < upto:
            self._submitted += 1
            p = self._submitted
            cancel = self._cancels[p] = threading.Event()
            self._futures[p] = self._pool.submit(self._prefetch_task, p,
                                                 cancel)

    def _take(self, partition: int) -> None:
        """Wait until the partition's host half is done, re-raising its
        error here, at the ordered consumption point. The wait polls the
        query's token and the watchdog attempt's cancel event: either
        cancels the partition's prefetch and unwinds this consumer. A
        re-dispatched attempt finds the partition taken and runs its
        host half inline."""
        from spark_rapids_tpu_torch import faults
        self._ensure_submitted(partition + self._depth)
        fut = self._futures.get(partition)
        if fut is None or partition in self._consumed:
            return
        self._consumed.add(partition)
        cancel = self._cancels[partition]
        wait_span = None
        # Counted as 0 where the host half was ready, so the metrics' keys
        # do not depend on timing.
        stalled = not fut.done()
        _record(self._ctx, "pipelineStalls", int(stalled))
        if stalled:
            # The ordered consumer blocks on this partition's host half:
            # that wait is queue time, on the trace timeline.
            from spark_rapids_tpu_torch import monitoring
            wait_span = monitoring.span("pipeline-wait", "queued",
                                        args={"partition": partition})
            wait_span.__enter__()
        t0 = time.perf_counter()
        try:
            while True:
                try:
                    fut.result(timeout=0.05)
                    return
                except concurrent.futures.TimeoutError:
                    if fut.done():
                        raise   # the task raised TimeoutError itself
                    tok = faults.get_query_token()
                    if tok is not None and tok.cancelled():
                        cancel.set()
                        raise tok.error()
                    wd_cancel = faults.get_cancel_event()
                    if wd_cancel is not None and wd_cancel.is_set():
                        cancel.set()
                        raise _ConsumeCancelled(
                            f"partition {partition} consume cancelled")
        except (_ConsumeCancelled, faults.QueryCancelledError):
            raise
        except BaseException:
            if cancel.is_set():
                # The prefetch unwound on our cancel (a killed stall): the
                # re-dispatched attempt recomputes the host half inline.
                return
            raise
        finally:
            waited = (time.perf_counter() - t0) * 1000.0
            if waited > 0:
                _record(self._ctx, "consumerWaitMs", waited)
            if wait_span is not None:
                wait_span.__exit__(None, None, None)

    def consume(self, partition: int, fn):
        """Wait for the partition's prefetch, then run ``fn`` (the device
        half) on the calling thread."""
        self._take(partition)
        return fn()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for cancel in self._cancels.values():
            cancel.set()
        self._pool.shutdown(wait=True, cancel_futures=True)
        # A failed or stopped loop must not leave encoded partitions
        # pinned in the context.
        if any(p not in self._consumed for p in self._futures):
            self._source.drop_prefetch(self._ctx)
        finalize_metrics(self._ctx)


def open_pipeline(ctx, source, nparts: int):
    """A :class:`PartitionPipeline` for this partition loop, or the serial
    no-op when the pipeline is off, the loop has one partition, or the
    subtree has no separable host half."""
    params = params_of(ctx.conf)
    if params is None or nparts <= 1 or not source.host_prefetchable():
        return _SerialPipeline()
    return PartitionPipeline(ctx, source, nparts, params)


# ---------------------------------------------------------------------------
# Concurrent independent stages
# ---------------------------------------------------------------------------

def device_scope(device):
    """``torch.cuda.device(device)`` for a CUDA device (the current device
    is per thread, and the kernels launch on the current device's
    stream), else a null context."""
    if device is not None and getattr(device, "type", None) == "cuda":
        import torch
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _oom_only(errors) -> bool:
    """Whether every failure of a stage wave is a device OOM, raw or an
    exhausted ladder: the wave's failed stages then run again alone."""
    from spark_rapids_tpu_torch.memory import oom
    return all(oom.is_unmet_oom(e) for e in errors)


def prematerialize_stages(ctx, root) -> None:
    """Materialize independent stages' exchange outputs concurrently.

    Stages run in bottom-up waves: a stage is ready when every parent
    stage's output is materialized. A wave of one runs inline (the lazy
    pull would do the same work); a larger wave fans out on threads, at
    most ``pipeline.maxConcurrentStages``. Every materialization is
    idempotent against the context cache, so a re-collect after a stage
    recompute runs only what was invalidated."""
    params = params_of(ctx.conf)
    if params is None or params.max_concurrent_stages <= 1:
        return
    from spark_rapids_tpu_torch import faults
    from spark_rapids_tpu_torch.memory import oom
    from spark_rapids_tpu_torch.ops.base import _watchdog_params
    from spark_rapids_tpu_torch.parallel import stages as S
    graph = S.build_stage_graph(root)
    # A host-tagged exchange of a mixed plan materializes on the host,
    # when its host consumer pulls it (the reference prematerializes it
    # on the device too, and fails there).
    on_device = {id(op) for op in S.device_execs(root)}
    runnable = {st.stage_id: st for st in graph.stages.values()
                if id(st.boundary) in on_device
                and callable(getattr(st.boundary, "stage_prematerialize",
                                     None))}
    if len(runnable) < 2:
        return
    wd = _watchdog_params(ctx.conf)
    catalog = oom.get_active_catalog()
    sink = faults.get_recovery_sink()
    token = faults.get_query_token()
    device = root.plan_device()

    def run_stage(st):
        from spark_rapids_tpu_torch import monitoring

        def materialize():
            st.boundary.stage_prematerialize(ctx)
        with monitoring.span(st.name, "stage",
                             level=monitoring.LEVEL_QUERY):
            if wd is None:
                materialize()
            else:
                st.boundary._watchdog_run(ctx, wd, st.name, materialize)

    def run_stage_threaded(st):
        oom.set_active_catalog(catalog, sink)
        faults.set_query_token(token)
        try:
            with device_scope(device):
                run_stage(st)
        finally:
            faults.set_query_token(None)
            oom.set_active_catalog(None)

    done: set = set()
    pending = dict(runnable)
    while pending:
        # Ready: every parent stage's output is materialized. A stage
        # whose parent cannot prematerialize never becomes ready and
        # materializes lazily in the consumer instead.
        wave = sorted((st for st in pending.values()
                       if all(pid in done for pid in st.parents)),
                      key=lambda st: st.stage_id)
        if not wave:
            break
        for st in wave:
            pending.pop(st.stage_id)
        if len(wave) == 1:
            run_stage(wave[0])
        else:
            _record(ctx, "concurrentStages", len(wave))
            errors: Dict[int, BaseException] = {}
            nworkers = min(params.max_concurrent_stages, len(wave))
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=nworkers,
                    thread_name_prefix="srt-stage") as pool:
                futs = {st.stage_id: pool.submit(run_stage_threaded, st)
                        for st in wave}
                for sid, fut in futs.items():
                    try:
                        fut.result()
                    except BaseException as e:
                        errors[sid] = e
            if errors and _oom_only(errors.values()):
                # Out of device memory side by side: release what the
                # failed attempts' frames hold, then run each failed
                # stage alone, with the finished stages' outputs
                # spillable.
                for e in errors.values():
                    traceback.clear_frames(e.__traceback__)
                failed = sorted(errors)
                errors.clear()
                for sid in failed:
                    _LOG.warning("stage %d ran out of device memory beside "
                                 "%d other(s); running it alone", sid,
                                 len(wave) - 1)
                    _record(ctx, "serialStageRetries", 1)
                    run_stage(runnable[sid])
            elif errors:
                # The smallest stage id: the one the serial pull order
                # would have hit first.
                raise errors[min(errors)]
        done.update(st.stage_id for st in wave)
