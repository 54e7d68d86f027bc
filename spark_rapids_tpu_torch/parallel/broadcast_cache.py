"""The cluster's broadcast artifact cache (port of the JAX package's
``parallel/broadcast_cache.py``).

Broadcast stages are not dispatchable (``cluster/coordinator.py``: every
process builds its broadcast singles itself, Spark executor semantics),
so in an N-process cluster the same build side is collected and
concatenated N times. This module makes the cluster's stage-output store
a build-artifact cache for them: the FIRST process to build a broadcast
single publishes it through the query's store (hostfile spool or
objectstore) under a content-addressed tag, and every later process
adopts the committed blob instead of collecting the child again.

Key (``ClusterExecInfo.broadcast_tag``)::

    bc-<plan_fp>-s<sid>-g<gensum>

- ``plan_fp``: sha256 of the query's plan pickle (two queries never
  collide; driver and workers hash the same shipped file);
- ``sid``: the broadcast stage's id in the shared DFS numbering;
- ``gensum``: the sum of the generations of the broadcast stage's
  dispatchable upstream stages, so a build of pre-recompute inputs is
  never found.

The stage outputs' durability contract holds: CRC-framed blob, the
manifest as the publication barrier, one refetch on a CRC mismatch; a
lost or corrupt entry is a miss and a LOCAL rebuild, never an error or a
recompute (sessions open with ``owner=None``, so a loss is attributed to
no stage).

Keys ``spark.rapids.sql.broadcast.cache.enabled`` and
``.fetchTimeoutMs``; process-global counters (``parallel/transport``)
``broadcastCacheHits``, ``broadcastCacheMisses`` (a miss = built
locally) and ``broadcastCachePublishes``.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

_LOG = logging.getLogger("spark_rapids_tpu_torch.cluster")


def _cache_conf(ctx) -> Tuple[Optional[object], Optional[int]]:
    """(installed ClusterExecInfo, fetch timeout ms) when the cache is
    usable in this context, else (None, None)."""
    from spark_rapids_tpu_torch import config as C
    info = ctx.cache.get("cluster")
    if info is None or not bool(ctx.conf.get(C.BROADCAST_CACHE_ENABLED)):
        return None, None
    return info, max(
        int(ctx.conf.get(C.BROADCAST_CACHE_FETCH_TIMEOUT_MS)), 1)


def maybe_fetch(ctx, exchange):
    """A published broadcast single for ``exchange``, or None (cache
    disabled / not a tagged broadcast stage / not published yet /
    lost / corrupt — all of which mean: build it locally).

    On a hit, returns ``(handle, batch)``: the handle satisfies the
    SpillableBatch get/release protocol the broadcast hit path uses, so
    the caller parks it at the exchange's cache key exactly like a
    locally-built single; its session is parked in ``ctx.cache`` too,
    so context teardown releases the fetched buffers."""
    info, timeout_ms = _cache_conf(ctx)
    if info is None:
        return None
    tag = info.broadcast_tag(exchange)
    if tag is None:
        return None
    from spark_rapids_tpu_torch import monitoring
    from spark_rapids_tpu_torch.parallel import transport as T
    try:
        sess = info.open_session(ctx, tag, 1, owner=None,
                                 fetch_timeout_ms=timeout_ms,
                                 device=exchange.plan_device())
        sess.fetch_only = True
        handles = sess.fetch_shards(0)
        if len(handles) != 1:
            raise ValueError(
                f"broadcast cache entry {tag} has {len(handles)} "
                f"shards (want exactly 1)")
        batch = handles[0].get()
    except Exception as e:
        # Everything is a miss: not-yet-published (fetch timeout),
        # shard lost under us, CRC failure past the refetch, store
        # unavailable. The local rebuild is always correct.
        T.record("broadcastCacheMisses")
        _LOG.debug("broadcast cache miss for %s: %s: %s", tag,
                   type(e).__name__, e)
        return None
    ctx.cache[f"bcastcache-sess:{tag}"] = sess
    T.record("broadcastCacheHits")
    monitoring.instant("broadcast-cache-hit", "shuffle",
                       args={"tag": tag, "rows": batch.rows_hint})
    _LOG.info("broadcast cache hit: adopted %s (%d capacity) instead "
              "of rebuilding", tag, batch.capacity)
    return handles[0], batch


def maybe_publish(ctx, exchange, single) -> None:
    """Best-effort publication of a locally-built broadcast single:
    write-shard + commit under the exchange's broadcast tag. Failures
    are swallowed — the cache is an accelerator, never a correctness
    dependency; concurrent publishers are safe (the manifest PUT/rename
    is atomic and both blobs are bit-identical builds of the same
    inputs)."""
    info, _ = _cache_conf(ctx)
    if info is None:
        return
    tag = info.broadcast_tag(exchange)
    if tag is None:
        return
    from spark_rapids_tpu_torch.parallel import transport as T
    try:
        sess = info.open_session(ctx, tag, 1, owner=None,
                                 device=exchange.plan_device())
        sess.write_shard(0, single)
        sess.commit()
        ctx.cache[f"bcastcache-sess:{tag}"] = sess
        T.record("broadcastCachePublishes")
        T.record("broadcastCacheMisses")     # built locally = a miss
        _LOG.info("broadcast cache publish: %s", tag)
    except Exception as e:
        _LOG.warning("broadcast cache publish of %s failed (cache "
                     "skipped): %s: %s", tag, type(e).__name__, e)
