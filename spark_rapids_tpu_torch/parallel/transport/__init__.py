"""Pluggable shuffle transport: registry and selection (port of the JAX
package's ``parallel/transport/__init__.py``).

Built-in transports, one SPI (``base.py``):

- ``inprocess``: the catalog-backed single-process exchange (shards are
  ``SpillableBatch`` handles under the memory ladder).
- ``hostfile``: shards spool to a shared directory as CRC-framed blobs
  with a manifest and socket rendezvous, so independent worker
  processes map-write and reduce-fetch each other's shards.
- ``objectstore``: the same contract keyed into a flat object namespace
  behind a pluggable put/get/list/delete backend (an HTTP stub ships),
  with bounded retry and deterministic-jitter backoff on transient
  backend errors.
- ``mesh``: the collective path's durable half (``mesh.py``): the
  planner lowers hash shuffles to ``MeshExchangeExec``
  (``parallel/mesh_exchange.py``), whose per-partition shards are catalog
  handles; every other exchange (single, round robin, range) of a mesh
  query materializes ``inprocess``.

Selection: ``spark.rapids.sql.shuffle.transport``, then an explicitly
set ``spark.rapids.sql.mesh.enabled`` true, then the
``SRT_SHUFFLE_TRANSPORT`` env (a whole-process override), then
``inprocess``. Third-party transports register with
:func:`register_transport`.

Counters (process-global here, and the per-query ``Transport@query``
metrics entry): ``transportBytesWritten``, ``transportBytesFetched``,
``transportShardsWritten``, ``transportShardsFetched``,
``remoteShardRefetches`` (CRC-failed fetches that re-read),
``remoteShardsLost`` (losses handed to the lineage recovery),
``objectstoreRetries``, ``rendezvousDegraded``, ``slowPuts``.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict

from spark_rapids_tpu_torch.parallel.transport.base import (  # noqa: F401
    ShardLostError, ShuffleSession, ShuffleTransport, TransportError)

_LOCK = threading.Lock()
_COUNTERS: Dict[str, float] = {}


def record(name: str, amount: float = 1) -> None:
    """Bump a process-global transport counter."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + amount


def counters() -> Dict[str, float]:
    with _LOCK:
        return dict(_COUNTERS)


def reset_counters() -> None:
    with _LOCK:
        _COUNTERS.clear()


def metrics_entry(ctx):
    """The per-query ``Transport@query`` metrics entry (an audit group,
    exempt from the metrics level filter)."""
    from spark_rapids_tpu_torch.ops.base import query_metrics_entry
    return query_metrics_entry(ctx, "Transport")


# -- registry ----------------------------------------------------------------

def _make_inprocess() -> ShuffleTransport:
    from spark_rapids_tpu_torch.parallel.transport.inprocess import \
        InProcessTransport
    return InProcessTransport()


def _make_hostfile() -> ShuffleTransport:
    from spark_rapids_tpu_torch.parallel.transport.hostfile import \
        HostFileTransport
    return HostFileTransport()


def _make_mesh() -> ShuffleTransport:
    from spark_rapids_tpu_torch.parallel.transport.mesh import \
        MeshTransport
    return MeshTransport()


def _make_objectstore() -> ShuffleTransport:
    from spark_rapids_tpu_torch.parallel.transport.objectstore import \
        ObjectStoreTransport
    return ObjectStoreTransport()


_REGISTRY: Dict[str, Callable[[], ShuffleTransport]] = {
    "inprocess": _make_inprocess,
    "hostfile": _make_hostfile,
    "mesh": _make_mesh,
    "objectstore": _make_objectstore,
}
_INSTANCES: Dict[str, ShuffleTransport] = {}


def register_transport(name: str,
                       factory: Callable[[], ShuffleTransport]) -> None:
    """Register a third-party transport under ``name`` (selectable by
    spark.rapids.sql.shuffle.transport)."""
    with _LOCK:
        _REGISTRY[name] = factory
        _INSTANCES.pop(name, None)


def _unknown(name: str) -> TransportError:
    return TransportError(f"unknown shuffle transport {name!r} "
                          f"(registered: {sorted(_REGISTRY)})")


def transport_name(conf) -> str:
    """The configured transport's name: the explicit conf key, then an
    explicitly set mesh.enabled true, then the SRT_SHUFFLE_TRANSPORT env,
    then inprocess."""
    from spark_rapids_tpu_torch import config as C
    name = str(conf.get(C.SHUFFLE_TRANSPORT) or "").strip().lower()
    if not name and C.MESH_ENABLED.key in conf.raw and \
            bool(conf.get(C.MESH_ENABLED)):
        name = "mesh"
    if not name:
        name = os.environ.get("SRT_SHUFFLE_TRANSPORT", "").strip().lower()
    if not name:
        name = "inprocess"
    if name not in _REGISTRY:
        raise _unknown(name)
    return name


def get_transport(name: str) -> ShuffleTransport:
    """The (process-cached) transport instance for ``name``."""
    with _LOCK:
        t = _INSTANCES.get(name)
        if t is not None:
            return t
        factory = _REGISTRY.get(name)
        if factory is None:
            raise _unknown(name)
    t = factory()
    with _LOCK:
        return _INSTANCES.setdefault(name, t)


def materialization_transport(conf) -> ShuffleTransport:
    """The transport a materialized ``ShuffleExchangeExec`` spools
    through: 'mesh' resolves to 'inprocess' (the collective exchange is
    its own exec, ``MeshExchangeExec``; the exchanges it does not take,
    single, round robin and range, materialize in process)."""
    name = transport_name(conf)
    return get_transport("inprocess" if name == "mesh" else name)
