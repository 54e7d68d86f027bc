"""In-process shuffle transport: the catalog-backed exchange behind the
SPI (port of the JAX package's ``parallel/transport/inprocess.py``).

Shards stay on the device as ``SpillableBatch`` handles of the query's
catalog at ``PRIORITY_SHUFFLE_OUTPUT`` (``memory/stores.py``): they spill
first under the device budget, device -> host -> disk (CRC-framed on
disk), and are restored when served. The serializer-fallback half of
the reference's transport split (GpuColumnarBatchSerializer.scala:38):
always available, no copies, one process.
"""

from __future__ import annotations

from typing import List, Optional

from spark_rapids_tpu_torch.parallel.transport.base import (
    ShuffleSession, ShuffleTransport)


class InProcessSession(ShuffleSession):
    def __init__(self, tag: str, num_partitions: int,
                 owner: Optional[int], catalog):
        super().__init__(tag, owner)
        self._catalog = catalog
        self.buckets: List[list] = [[] for _ in range(num_partitions)]
        self._committed = False

    def write_shard(self, partition: int, batch) -> None:
        from spark_rapids_tpu_torch import faults
        from spark_rapids_tpu_torch.memory.stores import (
            PRIORITY_SHUFFLE_OUTPUT, SpillableBatch)
        faults.fault_point("transport.write", owner=self.owner)
        sb = SpillableBatch(self._catalog, batch, PRIORITY_SHUFFLE_OUTPUT)
        self.record_shard_bytes(partition, sb.size_bytes)
        self.buckets[partition].append(sb)

    def commit(self) -> None:
        # Handles are visible the moment they register; commit is the
        # SPI's publication barrier and a no-op here.
        self._committed = True

    def fetch_shards(self, partition: int):
        return self.buckets[partition]

    def release_partition(self, partition: int) -> None:
        """Close one reduce partition's handles: an exchange built for
        one operator's out-of-core pass frees its buckets as it finishes
        them."""
        for sb in self.buckets[partition]:
            sb.close()
        self.buckets[partition] = []

    def invalidate(self) -> None:
        for p in range(len(self.buckets)):
            self.release_partition(p)
        self.shard_bytes = {}
        self._committed = False


class InProcessTransport(ShuffleTransport):
    name = "inprocess"

    def open(self, conf, tag: str, num_partitions: int,
             owner: Optional[int] = None, catalog=None, metrics=None,
             device=None) -> InProcessSession:
        if catalog is None:
            raise ValueError(
                "the inprocess transport needs the query's buffer catalog")
        return InProcessSession(tag, num_partitions, owner, catalog)
