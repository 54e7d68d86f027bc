"""Shuffle transport SPI (port of the JAX package's
``parallel/transport/base.py``).

Shuffle transport is a swappable layer, as in the reference: the columnar
serializer fallback (GpuColumnarBatchSerializer.scala:38) works
everywhere, and the UCX/RDMA plugin slots in behind the same
RapidsShuffleInternalManager interface. Every exchange talks to a
:class:`ShuffleTransport` chosen by ``spark.rapids.sql.shuffle.transport``
instead of deciding itself where its shards live.

Contract:

- ``Transport.open(conf, tag, ...)`` starts ONE map/reduce session for
  one exchange materialization. ``tag`` names the exchange's durable
  output (stable across a recompute of the same exchange).
- ``session.write_shard(partition, batch)`` appends one map-side piece
  to a reduce partition's shard list. Shards are owner-tagged with the
  exchange's id, so a loss found at fetch time goes through the
  lineage-scoped stage recompute (``parallel/stages.py``), not a
  whole-query retry.
- ``session.commit()`` publishes the map output atomically: a fetch
  never observes a half-written shard set.
- ``session.fetch_shards(partition)`` returns the partition's shard
  handles (``.capacity``, ``.rows_hint``, ``.get() -> DeviceBatch``,
  ``.release()``, ``.close()``: the SpillableBatch protocol,
  ``memory/stores.py``), in deterministic map order.
- ``session.invalidate()`` drops the durable output (the stage
  recompute's ``stage_invalidate`` contract) so a recompute rewrites it;
  ``session.abort()`` cleans up a partial materialization;
  ``session.close()`` is query teardown.

Serialized shards are CRC-framed by ``wire.frame_blob``, so a flipped bit
at rest on any transport is detected at fetch (one refetch, counter
``remoteShardRefetches``) instead of decoding into wrong rows.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence


class ShardLostError(RuntimeError):
    """A durable shuffle shard is gone (a missing spool file or object, a
    vanished manifest, an injected ``lostshard``). Carries the
    UNAVAILABLE marker, so an unattributable loss still lands in the
    whole-query retry, and ``fault_owner`` (the owning exchange's id), so
    the lineage recovery recomputes exactly the owning stage instead."""

    def __init__(self, what: str, owner: Optional[int] = None):
        super().__init__(f"UNAVAILABLE: lost shuffle shard: {what}")
        self.fault_owner = owner


class TransportError(RuntimeError):
    """Non-recoverable transport misconfiguration (an unknown or unported
    transport name, an unreachable spool directory, a rendezvous
    timeout)."""


class ShuffleSession:
    """One exchange materialization through one transport. Subclasses
    implement the five SPI verbs; the base class carries the identity
    fields every implementation needs and the observed sizes."""

    def __init__(self, tag: str, owner: Optional[int]):
        # ``tag`` names the durable output; ``owner`` is the owning
        # exchange exec's id(), the lineage attribution every loss or
        # corruption error carries.
        self.tag = tag
        self.owner = owner
        # Observed bytes per partition, in the transport's own units
        # (device bytes in process, framed blob bytes on a spool or an
        # object store): what the runtime re-plan and the byte-aware
        # partition coalescing read (parallel/replan.py, the exchange's
        # _groups).
        self.shard_bytes: Dict[int, int] = {}

    def record_shard_bytes(self, partition: int, nbytes: int) -> None:
        self.shard_bytes[partition] = \
            self.shard_bytes.get(partition, 0) + int(nbytes)

    def observed_bytes(self, partition: Optional[int] = None) -> int:
        """Observed bytes of one partition, or of the whole map output
        (``partition`` None). Meaningful after ``commit()``."""
        if partition is not None:
            return self.shard_bytes.get(partition, 0)
        return sum(self.shard_bytes.values())

    # -- map side ------------------------------------------------------------
    def write_shard(self, partition: int, batch) -> None:
        raise NotImplementedError

    def commit(self) -> None:
        raise NotImplementedError

    # -- reduce side ---------------------------------------------------------
    def fetch_shards(self, partition: int) -> Sequence:
        raise NotImplementedError

    # -- lifecycle -----------------------------------------------------------
    def abort(self) -> None:
        """Failed mid-materialization: release whatever was written (the
        recovery ladder runs the materialization again from scratch)."""
        self.invalidate()

    def invalidate(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Query teardown: release everything. Idempotent."""
        self.invalidate()


class ShuffleTransport:
    """Transport factory. Stateless; one session per exchange
    materialization."""

    name = "?"

    def open(self, conf, tag: str, num_partitions: int,
             owner: Optional[int] = None, catalog=None, metrics=None,
             device=None) -> ShuffleSession:
        """``device`` is where fetched shards decode (the reading
        session's device, whatever device wrote them)."""
        raise NotImplementedError
