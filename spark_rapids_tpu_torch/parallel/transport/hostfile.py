"""Host-file / socket shuffle transport: the cross-process data plane
(port of the JAX package's ``parallel/transport/hostfile.py``).

Map side: every shard serializes to ONE self-describing CRC-framed blob
(``memory/stores.batch_to_shard_blob``, ``wire.frame_blob`` outside) and
spools to a shared directory::

    <dir>/<exchange-tag>/<worker>/p00003-0001.shard
    <dir>/<exchange-tag>/<worker>.manifest.json     (atomic rename)

``commit()`` publishes the manifest: shard files are invisible to
fetchers until their manifest lands, so a fetch never observes a
half-written map output. With a socket rendezvous configured
(``...hostfile.rendezvous``) the commit is also announced over TCP, so
fetchers block on the commit barrier instead of polling the directory.

Reduce side: ``fetch_shards(p)`` waits for ``expectedWorkers`` manifests,
then serves partition p's shards in (worker, sequence) order:
deterministic, so the rows are bit for bit those of the in-process path.
A fetched blob decodes onto the READING session's device (a host-to-
device copy a shard, traced as an ``upload`` span and counted in the
wire codec's ``shardUploads`` / ``shardUploadBytes``) and registers with
the query's catalog as a spillable output, like an in-process piece.

Failures:

- a fetched frame failing its CRC re-reads ONCE (``remoteShardRefetches``);
  a persistently bad frame raises ``WireCorruptionError`` owner-tagged,
  so the lineage recovery (``parallel/stages.py``) recomputes the owning
  stage;
- a missing shard file or manifest raises :class:`ShardLostError`, also
  owner-tagged: one lost shard costs ONE stage recompute;
- the ``lostshard@transport`` fault deletes the shard at rest before
  raising, so a recovery has to REWRITE the data, not re-read a
  survivor; ``oom@transport`` and ``transient@transport`` fire at the
  same fetch funnel.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

from spark_rapids_tpu_torch.parallel.transport.base import (
    ShardLostError, ShuffleSession, ShuffleTransport)

_LOG = logging.getLogger("spark_rapids_tpu_torch.transport")


def default_spool_dir() -> str:
    return os.path.join(tempfile.gettempdir(),
                        f"srt_torch_shuffle_{os.getpid()}")


def valid_manifest(m) -> bool:
    """Torn-manifest guard shared by the file and object transports: a
    manifest counts as published only when it parses into the complete
    schema ``commit()`` writes. One written without the atomic rename (a
    crashed writer, a truncated upload) reads as not yet published and
    keeps the fetcher polling."""
    if not isinstance(m, dict):
        return False
    if not isinstance(m.get("worker"), str):
        return False
    if not isinstance(m.get("num_partitions"), int):
        return False
    shards = m.get("shards")
    if not isinstance(shards, dict):
        return False
    for entries in shards.values():
        if not isinstance(entries, list):
            return False
        for e in entries:
            if not isinstance(e, dict) or \
                    not isinstance(e.get("file"), str) or \
                    not isinstance(e.get("capacity"), int):
                return False
    return True


class ShardHandle:
    """Lazy shard handle with the SpillableBatch protocol: ``capacity``
    and ``rows_hint`` come from the manifest (no I/O); ``get()`` reads,
    verifies and decodes on first use and serves the catalog-registered
    (spillable) batch afterwards. ``locator`` is a path or an object key:
    the owning session's ``_fetch_blob`` reads it."""

    def __init__(self, session, locator: str, capacity: int,
                 rows: Optional[int]):
        self._session = session
        self._locator = locator
        self.capacity = capacity
        self.rows_hint = rows
        self._sb = None          # SpillableBatch once fetched (catalog)
        self._batch = None       # plain DeviceBatch (no catalog)
        self._closed = False

    def get(self):
        if self._sb is not None:
            return self._sb.get()
        if self._batch is not None:
            return self._batch
        batch = self._session._fetch_blob(self._locator)
        if self.rows_hint is not None and batch.rows_hint is None:
            batch.rows_hint = self.rows_hint
        catalog = self._session._catalog
        if catalog is not None:
            from spark_rapids_tpu_torch.memory.stores import (
                PRIORITY_SHUFFLE_OUTPUT, SpillableBatch)
            self._sb = SpillableBatch(catalog, batch,
                                      PRIORITY_SHUFFLE_OUTPUT)
            return self._sb.get()
        self._batch = batch
        return batch

    def release(self, priority: int = 0) -> None:
        if self._sb is not None:
            self._sb.release(priority)

    def close(self) -> None:
        if not self._closed:
            if self._sb is not None:
                self._sb.close()
            self._sb = self._batch = None
            self._closed = True


def decode_fetched(session, locator: str, framed: bytes):
    """One fetched frame -> a batch on the session's device: the CRC
    check, the decode and its host-to-device copy (an ``upload`` span),
    and the fetch counters. Raises ``WireCorruptionError`` on a bad
    frame."""
    from spark_rapids_tpu_torch import monitoring, resolve_device
    from spark_rapids_tpu_torch.columnar import wire
    from spark_rapids_tpu_torch.memory.stores import shard_blob_to_batch
    from spark_rapids_tpu_torch.parallel import transport as T
    with monitoring.span("shard-upload", "upload",
                         args={"bytes": len(framed), "shard": locator}):
        batch = shard_blob_to_batch(framed,
                                    resolve_device(session.device))
    wire._wrecord("shardUploads")
    wire._wrecord("shardUploadBytes", len(framed))
    T.record("transportBytesFetched", len(framed))
    T.record("transportShardsFetched")
    if session._metrics is not None:
        session._metrics.add("transportBytesFetched", len(framed))
        session._metrics.add("transportShardsFetched", 1)
    return batch


def fetch_with_refetch(session, locator: str, read):
    """The shared fetch funnel of the file and object transports: the
    ``transport`` fault site, then ``read()`` (raising ShardLostError on
    a missing shard) through the ``transport`` corruption site, with ONE
    re-read on a CRC mismatch; a second mismatch raises the error
    tagged with the session's owner."""
    from spark_rapids_tpu_torch import faults
    from spark_rapids_tpu_torch.columnar.wire import WireCorruptionError
    from spark_rapids_tpu_torch.parallel import transport as T
    faults.check_cancelled()
    e = faults.check_fault("transport", ("lostshard", "oom", "transient"))
    if e is not None:
        if e.kind == "oom":
            raise faults.InjectedOomError("transport")
        if e.kind == "transient":
            raise faults.InjectedTransientError("transport")
        # lostshard: delete the data at rest FIRST, so the recovery has
        # to rewrite the shard, not re-read a survivor.
        session._drop_at_rest(locator)
        T.record("remoteShardsLost")
        raise ShardLostError(f"injected loss of {locator}",
                             owner=session.owner)
    last: Optional[WireCorruptionError] = None
    for _ in range(2):
        framed = faults.corrupt_blob("transport", read())
        try:
            return decode_fetched(session, locator, framed)
        except WireCorruptionError as err:
            last = err
            faults.record("corruptionsDetected")
            faults.record("remoteShardRefetches")
            T.record("remoteShardRefetches")
            _LOG.warning("shard frame checksum mismatch (%s), "
                         "refetching: %s", locator, err)
    # Persistently corrupt at rest: the durable output is gone. The owner
    # tag makes the lineage recovery recompute just the owning stage.
    last.fault_owner = session.owner
    raise last


class HostFileSession(ShuffleSession):
    def __init__(self, conf, tag: str, num_partitions: int,
                 owner: Optional[int], catalog, metrics, device):
        super().__init__(tag, owner)
        from spark_rapids_tpu_torch import config as C
        from spark_rapids_tpu_torch.parallel.transport import rendezvous \
            as RV
        self._catalog = catalog
        self._metrics = metrics
        # Where fetched shards decode (None: the CUDA card).
        self.device = device
        self.num_partitions = num_partitions
        base = str(conf.get(C.SHUFFLE_TRANSPORT_HOSTFILE_DIR) or "") \
            or default_spool_dir()
        self.worker = str(conf.get(
            C.SHUFFLE_TRANSPORT_HOSTFILE_WORKER_ID) or "") \
            or f"w{os.getpid()}"
        # Exclusive-manifest mode: ONE tag-scoped manifest published by
        # whichever worker computed the stage; commit() replaces it
        # atomically, so a recompute on another worker never leaves a
        # fetcher a mix of old and new shards.
        self.exclusive = bool(conf.get(
            C.SHUFFLE_TRANSPORT_HOSTFILE_EXCLUSIVE_MANIFEST))
        self.expected_workers = 1 if self.exclusive else max(int(conf.get(
            C.SHUFFLE_TRANSPORT_HOSTFILE_EXPECTED_WORKERS)), 1)
        self.fetch_timeout_ms = int(conf.get(
            C.SHUFFLE_TRANSPORT_HOSTFILE_FETCH_TIMEOUT_MS))
        self._rv_addr = RV.parse_addr(str(conf.get(
            C.SHUFFLE_TRANSPORT_HOSTFILE_RENDEZVOUS) or ""))
        self._rv_params = RV.client_params(conf)
        self.root = os.path.join(base, tag)
        self._my_dir = os.path.join(self.root, self.worker)
        self._seq: Dict[int, int] = {}
        # This worker's manifest entries: partition -> [entry, ...]
        self._written: Dict[int, List[dict]] = {}
        self._committed = False
        # Fetch side: the worker manifests and per-partition handles.
        self._manifests: Optional[List[dict]] = None
        self._handles: Dict[int, List[ShardHandle]] = {}

    def _manifest_path(self) -> str:
        name = "exchange.manifest.json" if self.exclusive else \
            f"{self.worker}.manifest.json"
        return os.path.join(self.root, name)

    # -- map side ------------------------------------------------------------
    def write_shard(self, partition: int, batch) -> None:
        from spark_rapids_tpu_torch import faults
        from spark_rapids_tpu_torch.memory.stores import batch_to_shard_blob
        from spark_rapids_tpu_torch.parallel import transport as T
        faults.fault_point("transport.write", owner=self.owner)
        blob = batch_to_shard_blob(batch)
        seq = self._seq.get(partition, 0)
        self._seq[partition] = seq + 1
        os.makedirs(self._my_dir, exist_ok=True)
        fname = f"p{partition:05d}-{seq:04d}.shard"
        path = os.path.join(self._my_dir, fname)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
        rows = batch.rows_hint
        self.record_shard_bytes(partition, len(blob))
        self._written.setdefault(partition, []).append(
            {"file": f"{self.worker}/{fname}",
             "capacity": int(batch.capacity),
             "rows": None if rows is None else int(rows),
             "bytes": len(blob)})
        T.record("transportBytesWritten", len(blob))
        T.record("transportShardsWritten")
        if self._metrics is not None:
            self._metrics.add("transportBytesWritten", len(blob))
            self._metrics.add("transportShardsWritten", 1)

    def commit(self) -> None:
        os.makedirs(self.root, exist_ok=True)
        manifest = {"worker": self.worker,
                    "num_partitions": self.num_partitions,
                    "shards": {str(p): entries
                               for p, entries in self._written.items()}}
        path = self._manifest_path()
        tmp = path + f".{self.worker}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f)
        # os.replace is the atomicity contract: a concurrent fetcher sees
        # the previous complete manifest or this one, never a torn mix.
        os.replace(tmp, path)
        self._committed = True
        if self._rv_addr is None:
            return
        from spark_rapids_tpu_torch.parallel import transport as T
        from spark_rapids_tpu_torch.parallel.transport import rendezvous \
            as RV
        timeout_s, retries, backoff = self._rv_params
        try:
            RV.announce_commit(self._rv_addr, self.tag, self.worker,
                               timeout_s=timeout_s, retries=retries,
                               backoff_ms=backoff)
        except RV.RendezvousUnavailableError as e:
            # The manifest is already durable on the spool; a dead
            # rendezvous only loses the event wait, so fetchers degrade
            # to directory polling instead of this commit failing.
            T.record("rendezvousDegraded")
            _LOG.warning("rendezvous unavailable at commit (degrading "
                         "fetchers to manifest polling): %s", e)

    # -- reduce side ---------------------------------------------------------
    def _wait_rendezvous(self) -> None:
        from spark_rapids_tpu_torch.parallel import transport as T
        from spark_rapids_tpu_torch.parallel.transport import rendezvous \
            as RV
        timeout_s, retries, backoff = self._rv_params
        try:
            RV.wait_committed(self._rv_addr, self.tag,
                              self.expected_workers, self.fetch_timeout_ms,
                              connect_timeout_s=timeout_s, retries=retries,
                              backoff_ms=backoff)
        except RV.RendezvousUnavailableError as e:
            # The spool is the source of truth; the rendezvous only saves
            # the poll.
            T.record("rendezvousDegraded")
            _LOG.warning("rendezvous unavailable at fetch (degrading to "
                         "manifest polling): %s", e)

    def _read_manifests(self) -> List[dict]:
        out = []
        try:
            names = sorted(os.listdir(self.root))
        except FileNotFoundError:
            names = []
        for name in names:
            if not name.endswith(".manifest.json"):
                continue
            if self.exclusive and name != "exchange.manifest.json":
                continue
            try:
                with open(os.path.join(self.root, name),
                          encoding="utf-8") as f:
                    m = json.load(f)
            except (OSError, ValueError):
                continue          # a racing writer: poll again
            if valid_manifest(m):
                out.append(m)
        return out

    def _load_manifests(self) -> List[dict]:
        if self._manifests is not None:
            return self._manifests
        if self._rv_addr is not None:
            self._wait_rendezvous()
        deadline = time.monotonic() + self.fetch_timeout_ms / 1000.0
        while True:
            manifests = self._read_manifests()
            if len(manifests) >= self.expected_workers:
                break
            if time.monotonic() >= deadline:
                raise ShardLostError(
                    f"exchange {self.tag}: {len(manifests)}/"
                    f"{self.expected_workers} worker manifests in "
                    f"{self.root} after {self.fetch_timeout_ms}ms",
                    owner=self.owner)
            time.sleep(0.02)
        manifests.sort(key=lambda m: str(m.get("worker", "")))
        self._manifests = manifests
        return manifests

    def fetch_shards(self, partition: int):
        handles = self._handles.get(partition)
        if handles is None:
            handles = []
            for m in self._load_manifests():
                for entry in m.get("shards", {}).get(str(partition), []):
                    handles.append(ShardHandle(
                        self, os.path.join(self.root, entry["file"]),
                        int(entry["capacity"]), entry.get("rows")))
            self._handles[partition] = handles
        return handles

    def _read(self, path: str) -> bytes:
        from spark_rapids_tpu_torch.parallel import transport as T
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError as err:
            T.record("remoteShardsLost")
            raise ShardLostError(f"{path}: {err}", owner=self.owner) \
                from err

    def _drop_at_rest(self, path: str) -> None:
        try:
            os.remove(path)
        except OSError:
            pass

    def _fetch_blob(self, path: str):
        """Read, CRC-verify and decode one shard file (the fetch funnel,
        ``fetch_with_refetch``)."""
        return fetch_with_refetch(self, path, lambda: self._read(path))

    # -- lifecycle -----------------------------------------------------------
    def release_partition(self, partition: int) -> None:
        """Close one reduce partition's fetched handles (an out-of-core
        consumer frees its buckets as it finishes them); the files stay
        until ``invalidate`` / ``close``."""
        for h in self._handles.pop(partition, []):
            h.close()

    def _close_handles(self) -> None:
        for hs in self._handles.values():
            for h in hs:
                h.close()
        self._handles = {}
        self._manifests = None

    def invalidate(self) -> None:
        """Drop the WHOLE durable output (the stage recompute contract):
        the recompute rewrites every worker's shards under the tag."""
        self._close_handles()
        shutil.rmtree(self.root, ignore_errors=True)
        self._written = {}
        self._seq = {}
        self._committed = False

    def close(self) -> None:
        """Query teardown: release fetched handles and remove what THIS
        worker wrote. Other workers' spool data survives: their sessions
        own it (their fetches may still be running)."""
        self._close_handles()
        shutil.rmtree(self._my_dir, ignore_errors=True)
        if self._committed or not self.exclusive:
            # Only a committed manifest is ours to retract: in exclusive
            # mode the manifest may belong to another worker's commit.
            try:
                os.remove(self._manifest_path())
            except OSError:
                pass
        try:
            os.rmdir(self.root)   # the last worker out removes the tag
        except OSError:
            pass


class HostFileTransport(ShuffleTransport):
    name = "hostfile"

    def open(self, conf, tag: str, num_partitions: int,
             owner: Optional[int] = None, catalog=None, metrics=None,
             device=None) -> HostFileSession:
        return HostFileSession(conf, tag, num_partitions, owner, catalog,
                               metrics, device)
