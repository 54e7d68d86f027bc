"""Mesh shuffle transport: the collective path behind the SPI (port of
the JAX package's ``parallel/transport/mesh.py``).

The data plane is the collective inside ``MeshExchangeExec``
(``parallel/mesh.py``): the group moves the pieces, not this module.
What the SPI adds is the durable half: each LOGICAL partition's
post-exchange shard registers through ``write_shard`` as a spillable
handle of the query's catalog at ``PRIORITY_SHUFFLE_OUTPUT``
(``memory/stores.py``: bounded by the memory ladder, CRC-framed once
spilled), and ``fetch_shards`` / ``invalidate`` give the collective's
output the same lineage-recovery contract as every other transport: a
lost shard costs one stage recompute.

The transport does not fold partitions itself: the exchange's
fold / unfold pass writes one shard a logical partition, so consumers
never see the mesh's geometry.
"""

from __future__ import annotations

from typing import Optional

from spark_rapids_tpu_torch.parallel.transport.base import ShuffleTransport
from spark_rapids_tpu_torch.parallel.transport.inprocess import (
    InProcessSession)


class MeshSession(InProcessSession):
    """The collective's durable half is the in-process session's: catalog
    handles at ``PRIORITY_SHUFFLE_OUTPUT``, one bucket a logical
    partition."""


class MeshTransport(ShuffleTransport):
    name = "mesh"

    def open(self, conf, tag: str, num_partitions: int,
             owner: Optional[int] = None, catalog=None, metrics=None,
             device=None) -> MeshSession:
        if catalog is None:
            raise ValueError(
                "the mesh transport needs the query's buffer catalog")
        return MeshSession(tag, num_partitions, owner, catalog)
