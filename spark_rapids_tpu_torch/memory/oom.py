"""OOM -> tiered recovery at dispatch boundaries (port of the JAX
package's ``memory/oom.py``; ref DeviceMemoryEventHandler.scala:42-69).

The reference installs an allocation-failure callback that spills the
buffer catalog and lets the allocator retry the same allocation. PyTorch's
caching allocator raises ``torch.OutOfMemoryError`` instead (after freeing
its own cached blocks and retrying once), so the equivalent lives at the
dispatch sites: each operator's per-batch device step runs through
:func:`retry_on_oom`.

Recovery is a bounded escalation ladder; the step is retried after every
rung that changed something:

0. ``drop-scan-cache``: drop the file scan's decoded units on the card
   (``io/scan.py`` ``DEVICE_SCAN_CACHE``), which the catalog does not
   hold: a later scan reads them from the files again;
1. ``spill-some``: spill the lowest-priority catalog buffers until about
   half the registered device bytes are freed;
2. ``spill-all``: spill every spillable device buffer;
3. ``evict-neighbors``: under the multi-query scheduler, spill every
   OTHER running query's spillable device buffers
   (``parallel/scheduler.py`` ``QueryManager.evict_neighbors``): the
   offender's own buffers went first, and a neighbor is touched only
   when that was not enough. It acts only for a managed query with a
   neighbor that holds device buffers;
4. ``shrink``: halve the process-wide batch target
   (:func:`effective_batch_target`), so every later coalesce and exchange
   serve issues smaller batches, then retry once more.

An exhausted ladder raises :class:`OomRetryExhausted`, whose message
carries no OOM marker, so enclosing ``retry_on_oom`` frames pass it on.
A row-wise step (a join's probe, an exchange's map side, a partial
aggregate) first splits the batch in hand (:func:`split_on_oom`,
port-only: the shrink rung sizes only later batches). The operator layer
(``ops/base.py`` ``execute_device_recovering``) then tries the
operator's on-device degraded mode (the grace hash join); where that
fails too the error reaches the caller. Work never moves to the host.

The wrapped steps are pure batch -> batch, so a retry is safe. The active
catalog and the query's ``Recovery@query`` metrics (the recovery sink of
``faults.py``) are set per collect (thread-local), so dispatch sites deep
in the operators need no context. Every rung counts ``spillEscalations``
and every retry ``retriesAttempted`` through ``faults.record`` (the
process-global recovery counters and that sink), and every rung taken is
an ``oom-rung`` instant on the flight recorder. An injected OOM
(``faults.InjectedOomError``, raised at a dispatch funnel's fault site
inside the retried call) walks the same ladder as a real one.

The transient helpers at the end (:func:`is_transient_error`,
:func:`backoff_delay_ms`) serve the planner's recovery ladder
(``plan/planner.py``): which errors a query may be retried for, and how
long it waits before each retry.
"""

from __future__ import annotations

import logging
import random
import threading
import traceback
from typing import Callable, Iterator, List, TypeVar

import torch

from spark_rapids_tpu_torch import faults

_LOG = logging.getLogger("spark_rapids_tpu_torch.memory")

T = TypeVar("T")

_local = threading.local()


def set_active_catalog(catalog, metrics=None) -> None:
    """The catalog the dispatch sites of this thread spill into, and the
    query's recovery ``Metrics`` (``faults.set_recovery_sink``); None
    clears both."""
    _local.catalog = catalog
    faults.set_recovery_sink(metrics if catalog is not None else None)


def get_active_catalog():
    return getattr(_local, "catalog", None)


class OomRetryExhausted(RuntimeError):
    """Device OOM persisted through the whole escalation ladder. The
    message carries no OOM marker on purpose: an enclosing retry_on_oom
    passes this on instead of repeating the rungs that failed."""

    def __init__(self, original: BaseException, rungs: List[str]):
        super().__init__(
            f"device memory exhausted after escalation ladder "
            f"{rungs!r}; original: {type(original).__name__}")
        self.original = original
        self.rungs = rungs


def is_oom_error(e: BaseException) -> bool:
    """``torch.OutOfMemoryError`` (the caching allocator), or an error
    whose message reports a device allocation failure ("out of memory",
    as a CUDA status string from the port's own kernel wrappers gives
    it). Deliberately narrow: a false match costs a spill pass and a
    duplicate dispatch."""
    if isinstance(e, OomRetryExhausted):
        return False
    if isinstance(e, torch.OutOfMemoryError):
        return True
    s = f"{type(e).__name__}: {e}"
    return "out of memory" in s or "Out of memory" in s


# -- the degraded batch target (the shrink rung) ------------------------------

_MAX_DEGRADE_FACTOR = 8
_MIN_TARGET_ROWS = 1 << 12
_degrade_lock = threading.Lock()
_degrade_factor = 1

RUNG_DROP_SCAN_CACHE = "drop-scan-cache"
RUNG_SPILL_SOME = "spill-some"
RUNG_SPILL_ALL = "spill-all"
RUNG_EVICT_NEIGHBORS = "evict-neighbors"
RUNG_SHRINK = "shrink"

# Rung names of the last ladder, in firing order.
last_ladder: List[str] = []


def degrade_factor() -> int:
    return _degrade_factor


def effective_batch_target(target_rows: int) -> int:
    """``batchSizeRows`` after OOM degradation: once the shrink rung has
    fired, every consumer that coalesces toward the target (the
    aggregate's input, the exchange's reduce side) issues proportionally
    smaller batches until :func:`reset_degradation`."""
    return max(int(target_rows) // _degrade_factor, _MIN_TARGET_ROWS)


def shrink_batch_target() -> bool:
    """Halve the process-wide batch target (bounded). True if it moved."""
    global _degrade_factor
    with _degrade_lock:
        if _degrade_factor >= _MAX_DEGRADE_FACTOR:
            return False
        _degrade_factor *= 2
        _LOG.warning("OOM escalation: batch target degraded to 1/%d",
                     _degrade_factor)
        return True


def reset_degradation() -> None:
    global _degrade_factor
    with _degrade_lock:
        _degrade_factor = 1


# -- the ladder -----------------------------------------------------------------

def _evict_neighbor_queries() -> int:
    """The cross-query rung: ask the query manager to spill the other
    running queries' catalogs to the host. 0 bytes outside a managed
    query or without a neighbor holding device buffers."""
    tok = faults.get_query_token()
    if tok is None:
        return 0
    from spark_rapids_tpu_torch.parallel import scheduler
    return scheduler.get_query_manager().evict_neighbors(tok.query_id)


def retry_on_oom(fn: Callable[..., T], *args, **kwargs) -> T:
    """Run ``fn``; on a device OOM walk the drop-scan-cache -> spill-some
    -> spill-all -> evict-neighbors -> shrink ladder, retrying after each
    rung that changed something.
    Anything else propagates; a ladder that changed nothing re-raises the
    original error."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:
        if not is_oom_error(e):
            raise
        first = e
    # The failed call's frames hold the tensors it had allocated; clear
    # their locals so the spill and the retry see that memory free.
    traceback.clear_frames(first.__traceback__)
    catalog = get_active_catalog()
    rungs: List[str] = []
    last: BaseException = first
    for rung in (RUNG_DROP_SCAN_CACHE, RUNG_SPILL_SOME, RUNG_SPILL_ALL,
                 RUNG_EVICT_NEIGHBORS, RUNG_SHRINK):
        if rung == RUNG_DROP_SCAN_CACHE:
            from spark_rapids_tpu_torch.io.scan import DEVICE_SCAN_CACHE
            acted = DEVICE_SCAN_CACHE.drop_device_entries() > 0
        elif rung == RUNG_SPILL_SOME:
            acted = catalog is not None and catalog.spill_some() > 0
        elif rung == RUNG_SPILL_ALL:
            acted = catalog is not None and catalog.handle_oom() > 0
        elif rung == RUNG_EVICT_NEIGHBORS:
            acted = _evict_neighbor_queries() > 0
        else:
            acted = shrink_batch_target()
        if not acted:
            # Nothing changed at this rung: the same dispatch would fail
            # the same way, so escalate without a retry.
            continue
        rungs.append(rung)
        last_ladder[:] = rungs
        faults.record("spillEscalations")
        from spark_rapids_tpu_torch import monitoring
        monitoring.instant("oom-rung", "recovery", args={"rung": rung})
        _LOG.warning("device OOM: escalation rung %r (of %r), retrying "
                     "dispatch: %s", rung, rungs, last)
        try:
            faults.record("retriesAttempted")
            return fn(*args, **kwargs)
        except Exception as e2:
            if not is_oom_error(e2):
                raise
            traceback.clear_frames(e2.__traceback__)
            last = e2
    last_ladder[:] = rungs
    if not rungs:
        raise last
    raise OomRetryExhausted(last, rungs)


def is_unmet_oom(e: BaseException) -> bool:
    """A device OOM the ladder left unmet: an exhausted ladder, or a raw
    OOM where no rung could act."""
    return isinstance(e, OomRetryExhausted) or is_oom_error(e)


def split_on_oom(step: Callable, batch, offset: int = 0) -> Iterator:
    """Yield ``step(batch, offset)``, a device step whose dispatches run
    under :func:`retry_on_oom`; ``offset`` is the batch's first row
    within the one first passed. Where the OOM is left unmet, the batch in
    hand needs more than every spill freed, and the shrink rung only
    sizes later batches: halve this one (``DeviceBatch.halves``) and run
    ``step`` on each half, in order, recursively down to
    ``_MIN_TARGET_ROWS`` of capacity, below which the error propagates.
    A step must keep nothing of a call that raises. A row-wise step (a
    join's probe, an exchange's map side, a partial aggregate) then gives
    the same rows in the same order, in more batches. Each split counts
    ``splitRetries`` and is an ``oom-split`` instant."""
    try:
        out = step(batch, offset)
    except Exception as e:
        if not is_unmet_oom(e) or batch.capacity < 2 * _MIN_TARGET_ROWS:
            raise
        traceback.clear_frames(e.__traceback__)
        _LOG.warning("device OOM left unmet on a %d-row batch; splitting "
                     "it in half: %s", batch.capacity, e)
    else:
        yield out
        return
    faults.record("splitRetries")
    from spark_rapids_tpu_torch import monitoring
    monitoring.instant("oom-split", "recovery",
                       args={"capacity": batch.capacity})
    lo, hi = batch.halves()
    yield from split_on_oom(step, lo, offset)
    yield from split_on_oom(step, hi, offset + lo.capacity)


# -- transient failures -------------------------------------------------------

def is_transient_error(e: BaseException) -> bool:
    """Backend failures worth retrying the query for (the planner's
    recovery ladder), by the reference's markers. Deliberately narrow:
    a deterministic error must not run twice. No CUDA error string is a
    marker: a sticky CUDA error (an illegal memory access, a device-side
    assert) poisons the context, and retrying it would hide a kernel
    bug."""
    s = f"{type(e).__name__}: {e}"
    return any(marker in s for marker in (
        "UNAVAILABLE", "DEADLINE_EXCEEDED", "connection reset",
        "Connection reset", "Socket closed", "ABORTED",
        "failed to connect", "stream terminated"))


def backoff_delay_ms(attempt: int, base_ms: int, max_ms: int,
                     seed: int = 0) -> float:
    """Exponential backoff with deterministic jitter: attempt ``i``
    sleeps ``min(base * 2^i, max) * U(0.5, 1.0)``, U from a PRNG seeded
    by (seed, attempt), so a seeded chaos run repeats its sleeps too."""
    d = min(float(base_ms) * (2 ** int(attempt)), float(max_ms))
    jitter = random.Random(f"{seed}:backoff:{attempt}").uniform(0.5, 1.0)
    return d * jitter
