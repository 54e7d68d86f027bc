"""Pipelined partition executor: overlap host decode and encode with
device work (port of the JAX package's ``parallel/pipeline.py``, without
``prematerialize_stages``, which needs the stage DAG).

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
token, recovery sink and active catalog, in a ``prefetch`` span; a
consumer that waits for one does so in a ``pipeline-wait`` span.

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
``pipelineStalls``, ``prefetchedPartitions``, ``stagingBytesPrefetched``
and the derived ``overlapRatio`` (the share of host-prefetch time the
consumer did not wait for: 0 means the pipeline degenerated to serial, 1
that the decode was hidden behind device work).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import threading
import time
from typing import Dict, Optional

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


def is_stage_boundary(op) -> bool:
    """An exec whose materialized output is a stage output. The port's
    only one is the shuffle exchange (the reference asks its stage DAG,
    ``parallel/stages.py``, which is not ported)."""
    from spark_rapids_tpu_torch.parallel.exchange import ShuffleExchangeExec
    return isinstance(op, ShuffleExchangeExec)


@dataclasses.dataclass(frozen=True)
class PipelineParams:
    prefetch_partitions: int
    host_threads: int


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
        host_threads=max(int(conf.get(C.PIPELINE_HOST_THREADS)), 1))


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
        self._consumed: set = set()
        self._submitted = -1
        self._closed = False

    def _prefetch_task(self, partition: int) -> None:
        from spark_rapids_tpu_torch import faults, monitoring
        from spark_rapids_tpu_torch.memory import oom
        faults.set_query_token(self._token)
        oom.set_active_catalog(self._catalog, self._sink)
        t0 = time.perf_counter()
        try:
            if not self._closed:
                with monitoring.span("prefetch", "host-prefetch",
                                     args={"partition": partition}):
                    self._source.prefetch_host(self._ctx, partition)
        finally:
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
            self._futures[p] = self._pool.submit(self._prefetch_task, p)

    def _take(self, partition: int) -> None:
        """Wait until the partition's host half is done, re-raising its
        error here, at the ordered consumption point."""
        self._ensure_submitted(partition + self._depth)
        fut = self._futures.get(partition)
        if fut is None or partition in self._consumed:
            return
        self._consumed.add(partition)
        wait_span = None
        if not fut.done():
            _record(self._ctx, "pipelineStalls", 1)
            # The ordered consumer blocks on this partition's host half:
            # that wait is queue time, on the trace timeline.
            from spark_rapids_tpu_torch import monitoring
            wait_span = monitoring.span("pipeline-wait", "queued",
                                        args={"partition": partition})
            wait_span.__enter__()
        t0 = time.perf_counter()
        try:
            fut.result()
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
