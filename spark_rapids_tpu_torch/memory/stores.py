"""Tiered buffer stores: device -> host RAM -> disk (port of the JAX
package's ``memory/stores.py``; ref RapidsBufferCatalog and the
Rapids{Device,Host,Disk}Store chain).

The device tier is governed by a watermark budget: the catalog counts the
bytes of every registered device batch against a budget and, when an
admission would cross it, synchronously spills the lowest-priority
buffers (RapidsBufferStore.synchronousSpill, driven by admission). A
real allocation failure is handled at the dispatch sites instead
(``memory/oom.py``), which call :meth:`BufferCatalog.spill_some` and
:meth:`BufferCatalog.handle_oom`.

A spilled batch leaves the device whole: every tensor is copied into a
numpy buffer (host tier) and, past the host budget, serialized into one
blob, compressed by the codec and written as a CRC frame into the native
spill file (disk tier). The entry then holds no device tensor. A restore
rebuilds the batch bit for bit: data, validity, string lengths and byte
matrices, the selection vector, ``num_rows`` and ``rows_hint``. The disk
write and read are the ``spill.write`` / ``spill.read`` fault sites, and
a read passes its frame through the ``wire`` corruption site before the
CRC check, which then re-reads once (``faults.py``).

Spill priorities follow SpillPriorities.scala: shuffle outputs spill
first, actively read inputs never.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import DeviceLike, faults
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, DeviceColumn

_LOG = logging.getLogger("spark_rapids_tpu_torch.memory")

# SpillPriorities.scala analogs: lower spills first.
PRIORITY_SHUFFLE_OUTPUT = 0
PRIORITY_DEFAULT = 50
# Broadcast singles are re-read by every probe partition: they spill after
# shuffle buckets and scratch, before actively read inputs.
PRIORITY_BROADCAST = 75
PRIORITY_ACTIVE_INPUT = 100


class StorageTier:
    DEVICE = "device"
    HOST = "host"
    DISK = "disk"


def default_spill_dir() -> str:
    """``spark_rapids_tpu_spill`` under the process's temporary
    directory."""
    return os.path.join(tempfile.gettempdir(), "spark_rapids_tpu_spill")


def _batch_to_numpy(batch: DeviceBatch) -> Tuple[dict, list]:
    """Device batch -> (meta, numpy buffers), padding included (an exact
    image: the restore has the same capacities). Every buffer is a copy,
    also for a batch on the CPU, so the host tier shares no storage with
    the batch it spilled."""
    bufs = []
    cols_meta = []
    for c in batch.columns:
        entry = {"dtype": c.dtype.name}
        bufs.append(c.data.to("cpu", copy=True).numpy())
        bufs.append(c.validity.to("cpu", copy=True).numpy())
        if c.lengths is not None:
            bufs.append(c.lengths.to("cpu", copy=True).numpy())
            entry["has_lengths"] = True
        cols_meta.append(entry)
    meta = {"cols": cols_meta, "num_rows": int(batch.num_rows),
            "rows_hint": batch.rows_hint, "device": str(batch.device)}
    if batch.sel is not None:
        bufs.append(batch.sel.to("cpu", copy=True).numpy())
        meta["has_sel"] = True
    return meta, bufs


def _numpy_to_batch(meta: dict, bufs: list,
                    device: DeviceLike = None) -> DeviceBatch:
    """Inverse of :func:`_batch_to_numpy`, onto ``device`` (None: the
    device it came from)."""
    device = torch.device(meta["device"] if device is None else device)

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    cols = []
    bi = 0
    for entry in meta["cols"]:
        t = dt.type_named(entry["dtype"])
        data = up(bufs[bi])
        validity = up(bufs[bi + 1])
        bi += 2
        lengths = None
        if entry.get("has_lengths"):
            lengths = up(bufs[bi])
            bi += 1
        cols.append(DeviceColumn(t, data, validity, lengths))
    sel = up(bufs[bi]) if meta.get("has_sel") else None
    out = DeviceBatch(tuple(cols), torch.tensor(
        meta["num_rows"], dtype=torch.int32, device=device), sel=sel)
    out.rows_hint = meta.get("rows_hint")
    return out


def _serialize_bufs(bufs: list) -> Tuple[bytes, list]:
    """Buffers -> one contiguous byte blob + a dtype / shape directory."""
    directory = []
    parts = []
    for a in bufs:
        raw = np.ascontiguousarray(a).tobytes()
        directory.append({"dtype": a.dtype.str, "shape": a.shape,
                          "nbytes": len(raw)})
        parts.append(raw)
    return b"".join(parts), directory


def _deserialize_bufs(blob: bytes, directory: list) -> list:
    """Inverse of :func:`_serialize_bufs`. The buffers view one writable
    copy of the blob."""
    data = bytearray(blob)
    out = []
    off = 0
    for d in directory:
        n = d["nbytes"]
        dtype = np.dtype(d["dtype"])
        arr = np.frombuffer(data, dtype=dtype, count=n // dtype.itemsize,
                            offset=off).reshape(d["shape"])
        out.append(arr)
        off += n
    return out


# ---------------------------------------------------------------------------
# The shard wire format (the shuffle transport SPI's at-rest form,
# parallel/transport/): ONE CRC-framed blob a shard, the meta and a buffer
# directory as a JSON header, then the contiguous buffer bytes. The
# format is the JAX package's byte for byte (the header carries no
# device), so a blob written by either package decodes in the other. The
# numpy round trip is exact, so a transport that moves these blobs keeps
# the rows bit for bit.
# ---------------------------------------------------------------------------

def batch_to_shard_blob(batch: DeviceBatch) -> bytes:
    """DeviceBatch -> one CRC-framed, self-describing byte blob
    (``wire.frame_blob`` outside, so a fetch detects corruption at the
    frame)."""
    import json
    import struct

    from spark_rapids_tpu_torch.columnar.wire import frame_blob
    meta, bufs = _batch_to_numpy(batch)
    meta.pop("device", None)
    blob, directory = _serialize_bufs(bufs)
    header = json.dumps(
        {"meta": meta,
         "directory": [{"dtype": d["dtype"], "shape": list(d["shape"]),
                        "nbytes": d["nbytes"]} for d in directory]},
    ).encode("utf-8")
    return frame_blob(struct.pack("<I", len(header)) + header + blob)


def shard_blob_to_batch(framed: bytes, device: DeviceLike) -> DeviceBatch:
    """Inverse of :func:`batch_to_shard_blob`, onto ``device`` (the
    reading session's device, whichever device wrote the blob). Raises
    ``WireCorruptionError`` on any frame or CRC mismatch: wrong bytes
    never decode into wrong rows."""
    import json
    import struct

    from spark_rapids_tpu_torch.columnar.wire import unframe_blob
    payload = unframe_blob(framed)
    (hlen,) = struct.unpack_from("<I", payload)
    header = json.loads(payload[4:4 + hlen].decode("utf-8"))
    bufs = _deserialize_bufs(payload[4 + hlen:], header["directory"])
    return _numpy_to_batch(header["meta"], bufs, device)


@dataclasses.dataclass
class BufferEntry:
    buffer_id: int
    tier: str
    size_bytes: int
    priority: int
    # Owning query id (RapidsBufferCatalog's owner tagging): per-query
    # accounting (``owned_bytes``) and the tenant byte quota. None:
    # unmanaged (a standalone ``Exec.collect``, unit tests).
    owner: Optional[int] = None
    # Exactly one tier's state is set.
    device_batch: Optional[DeviceBatch] = None
    host_meta: Optional[dict] = None
    host_bufs: Optional[list] = None
    disk_meta: Optional[dict] = None
    disk_directory: Optional[list] = None
    disk_block: Optional[int] = None


class BufferCatalog:
    """id -> buffer across the tiers, with the device -> host -> disk
    spill chain. The spill file opens, and the codec loads, at the first
    spill to disk."""

    def __init__(self, device_budget_bytes: int = 1 << 34,
                 host_budget_bytes: int = 1 << 30,
                 spill_dir: str = "",
                 compression_codec: str = "none",
                 debug: bool = False,
                 owner: Optional[int] = None):
        from spark_rapids_tpu_torch.memory.compression import CODEC_NAMES
        if (compression_codec or "").lower() not in CODEC_NAMES:
            raise ValueError(
                f"unknown compression codec {compression_codec!r}")
        self.device_budget = int(device_budget_bytes)
        self.host_budget = int(host_budget_bytes)
        self.spill_dir = spill_dir or default_spill_dir()
        self.codec_name = compression_codec
        self.debug = debug
        # The owner tag of every buffer this catalog registers: the
        # admitted query's id (catalogs are per query).
        self.owner = owner
        self._entries: Dict[int, BufferEntry] = {}
        self._next_id = itertools.count()
        self._device_bytes = 0
        self._host_bytes = 0
        self._lock = threading.RLock()
        self._spill_file = None
        self._codec = None
        self._codec_loaded = False
        self._stacks: Dict[int, str] = {}
        self.metrics = {"spill_to_host": 0, "spill_to_disk": 0,
                        "restore_from_host": 0, "restore_from_disk": 0,
                        "disk_bytes_raw": 0, "disk_bytes_stored": 0,
                        "peak_device_bytes": 0}

    @property
    def codec(self):
        """The disk tier's codec (None for ``none``), loaded on first
        use."""
        if not self._codec_loaded:
            from spark_rapids_tpu_torch.memory.compression import get_codec
            self._codec = get_codec(self.codec_name)
            self._codec_loaded = True
        return self._codec

    def _file(self):
        if self._spill_file is None:
            from spark_rapids_tpu_torch.memory.native import NativeSpillFile
            self._spill_file = NativeSpillFile(self.spill_dir)
        return self._spill_file

    # -- registration --------------------------------------------------------
    def add_batch(self, batch: DeviceBatch,
                  priority: int = PRIORITY_DEFAULT) -> int:
        size = batch.device_size_bytes()
        with self._lock:
            self._ensure_device_room(size)
            bid = next(self._next_id)
            self._entries[bid] = BufferEntry(
                bid, StorageTier.DEVICE, size, priority, owner=self.owner,
                device_batch=batch)
            self._device_bytes += size
            self._note_peak()
            if self.debug:
                import traceback
                self._stacks[bid] = "".join(
                    traceback.format_stack(limit=8)[:-1])
                _LOG.info("catalog add id=%d size=%d device_bytes=%d",
                          bid, size, self._device_bytes)
            return bid

    def acquire_batch(self, buffer_id: int) -> DeviceBatch:
        """The batch back on the device, from whatever tier, re-admitted
        under the budget and pinned (priority ACTIVE_INPUT) until
        :meth:`release` (SpillableColumnarBatch.getColumnarBatch)."""
        with self._lock:
            e = self._entries[buffer_id]
            e.priority = PRIORITY_ACTIVE_INPUT
            if e.tier == StorageTier.DEVICE:
                return e.device_batch
            # The source tier's state detaches BEFORE _ensure_device_room:
            # the cascaded device -> host spill it can trigger must never
            # pick this entry as a host -> disk victim.
            if e.tier == StorageTier.HOST:
                self.metrics["restore_from_host"] += 1
                meta, bufs = e.host_meta, e.host_bufs
                e.host_meta = e.host_bufs = None
                self._host_bytes -= e.size_bytes
            else:
                self.metrics["restore_from_disk"] += 1
                blob = self._read_disk_frame(e)
                if self.codec is not None:
                    blob = self.codec.decompress(blob,
                                                 e.disk_meta["raw_len"])
                meta = e.disk_meta
                bufs = _deserialize_bufs(blob, e.disk_directory)
                self._file().free(e.disk_block)
                e.disk_meta = e.disk_directory = e.disk_block = None
            try:
                self._ensure_device_room(e.size_bytes)
                batch = _numpy_to_batch(meta, bufs)
            except BaseException:
                # A failed restore (a device OOM the caller's ladder may
                # retry) leaves the bytes in host memory: the entry is a
                # host entry again, whichever tier it came from.
                e.host_meta, e.host_bufs = meta, bufs
                e.tier = StorageTier.HOST
                self._host_bytes += e.size_bytes
                raise
            e.tier = StorageTier.DEVICE
            e.device_batch = batch
            self._device_bytes += e.size_bytes
            self._note_peak()
            return batch

    def _note_peak(self):
        if self._device_bytes > self.metrics["peak_device_bytes"]:
            self.metrics["peak_device_bytes"] = self._device_bytes

    def release(self, buffer_id: int, priority: int = PRIORITY_DEFAULT):
        """Done reading: the buffer is spillable again."""
        with self._lock:
            e = self._entries.get(buffer_id)
            if e is not None:
                e.priority = priority

    def remove(self, buffer_id: int):
        with self._lock:
            e = self._entries.pop(buffer_id, None)
            if e is None:
                return
            if self.debug:
                self._stacks.pop(buffer_id, None)
                _LOG.info("catalog remove id=%d size=%d", buffer_id,
                          e.size_bytes)
            if e.tier == StorageTier.DEVICE:
                self._device_bytes -= e.size_bytes
            elif e.tier == StorageTier.HOST:
                self._host_bytes -= e.size_bytes
            elif e.disk_block is not None:
                self._file().free(e.disk_block)

    def _read_disk_frame(self, e: BufferEntry) -> bytes:
        """Read and CRC-check a spilled frame. A mismatch re-reads once;
        a second mismatch raises: wrong bytes never decode into rows."""
        from spark_rapids_tpu_torch.columnar.wire import (
            WireCorruptionError, unframe_blob)
        last: Optional[WireCorruptionError] = None
        for _ in range(2):
            faults.fault_point("spill.read")
            framed = self._file().read(e.disk_block)
            framed = faults.corrupt_blob("wire", framed)
            try:
                return unframe_blob(framed)
            except WireCorruptionError as err:
                last = err
                faults.record("corruptionsDetected")
                self.metrics["corruption_detected"] = \
                    self.metrics.get("corruption_detected", 0) + 1
                _LOG.warning("spill frame checksum mismatch (buffer %d), "
                             "re-reading: %s", e.buffer_id, err)
        raise last

    # -- OOM recovery --------------------------------------------------------
    def spill_some(self, target_bytes: Optional[int] = None) -> int:
        """The ladder's first rung: spill the lowest-priority device
        buffers until about ``target_bytes`` are freed (default: half the
        registered device bytes). Returns the bytes spilled (0: nothing
        was spillable)."""
        freed = 0
        with self._lock:
            if target_bytes is None:
                target_bytes = max(self._device_bytes // 2, 1)
            while freed < target_bytes:
                victim = self._pick_victim(StorageTier.DEVICE)
                if victim is None:
                    break
                freed += victim.size_bytes
                self._spill_device_to_host(victim)
        if freed:
            self.metrics["oom_spills"] = self.metrics.get("oom_spills", 0) + 1
        return freed

    def handle_oom(self) -> int:
        """A real device allocation failure: spill EVERY spillable device
        buffer (DeviceMemoryEventHandler's alloc-failure callback, driven
        from the dispatch site). Returns the bytes spilled; 0 means a
        retry would fail again."""
        freed = 0
        with self._lock:
            while True:
                victim = self._pick_victim(StorageTier.DEVICE)
                if victim is None:
                    break
                freed += victim.size_bytes
                self._spill_device_to_host(victim)
        if freed:
            self.metrics["oom_spills"] = self.metrics.get("oom_spills", 0) + 1
        return freed

    # -- spilling ------------------------------------------------------------
    def _ensure_device_room(self, incoming: int):
        """Evict lowest-priority device buffers until ``incoming`` bytes
        fit the budget; with nothing left to spill, admit anyway."""
        while self._device_bytes + incoming > self.device_budget:
            victim = self._pick_victim(StorageTier.DEVICE)
            if victim is None:
                break
            self._spill_device_to_host(victim)

    def _pick_victim(self, tier: str) -> Optional[BufferEntry]:
        best = None
        for e in self._entries.values():
            if e.tier != tier or e.priority >= PRIORITY_ACTIVE_INPUT:
                continue
            if best is None or e.priority < best.priority or \
                    (e.priority == best.priority and
                     e.buffer_id < best.buffer_id):
                best = e
        return best

    def _spill_device_to_host(self, e: BufferEntry):
        meta, bufs = _batch_to_numpy(e.device_batch)
        e.device_batch = None
        e.tier = StorageTier.HOST
        e.host_meta, e.host_bufs = meta, bufs
        self._device_bytes -= e.size_bytes
        self._host_bytes += e.size_bytes
        self.metrics["spill_to_host"] += 1
        # Cascade: a host tier over its budget pushes victims to disk.
        while self._host_bytes > self.host_budget:
            victim = self._pick_victim(StorageTier.HOST)
            if victim is None:
                break
            self._spill_host_to_disk(victim)

    def _spill_host_to_disk(self, e: BufferEntry):
        from spark_rapids_tpu_torch.columnar.wire import frame_blob
        faults.fault_point("spill.write")
        blob, directory = _serialize_bufs(e.host_bufs)
        raw_len = len(blob)
        if self.codec is not None:
            blob = self.codec.compress(blob)
        block = self._file().write(frame_blob(blob))
        e.disk_meta = dict(e.host_meta)
        e.disk_meta["raw_len"] = raw_len
        e.disk_directory = directory
        e.disk_block = block
        e.host_meta = e.host_bufs = None
        e.tier = StorageTier.DISK
        self._host_bytes -= e.size_bytes
        self.metrics["spill_to_disk"] += 1
        self.metrics["disk_bytes_raw"] += raw_len
        self.metrics["disk_bytes_stored"] += len(blob)

    # -- introspection -------------------------------------------------------
    def tier_of(self, buffer_id: int) -> str:
        with self._lock:
            return self._entries[buffer_id].tier

    def entry(self, buffer_id: int) -> BufferEntry:
        with self._lock:
            return self._entries[buffer_id]

    @property
    def device_bytes(self) -> int:
        return self._device_bytes

    @property
    def host_bytes(self) -> int:
        return self._host_bytes

    @property
    def disk_bytes(self) -> int:
        return 0 if self._spill_file is None \
            else self._spill_file.allocated_bytes

    def owned_bytes(self) -> Dict[Optional[int], int]:
        """Registered bytes per owner tag (any tier): the per-query
        accounting the tenant byte quota reads."""
        out: Dict[Optional[int], int] = {}
        with self._lock:
            for e in self._entries.values():
                out[e.owner] = out.get(e.owner, 0) + e.size_bytes
        return out

    def leak_report(self) -> List[Tuple[int, int, str]]:
        """Buffers still registered: (id, bytes, creation stack); stacks
        are recorded in debug mode only."""
        with self._lock:
            return [(e.buffer_id, e.size_bytes,
                     self._stacks.get(e.buffer_id, "<enable "
                                      "spark.rapids.memory.tpu.debug for "
                                      "the allocation stack>"))
                    for e in self._entries.values()]

    def close(self):
        leaks = self.leak_report()
        if leaks and self.debug:
            _LOG.warning("catalog closing with %d leaked buffers (%d "
                         "bytes):", len(leaks), sum(b for _, b, _ in leaks))
            for bid, size, stack in leaks:
                _LOG.warning("  leaked id=%d size=%d\n%s", bid, size, stack)
        if self._spill_file is not None:
            self._spill_file.close()
            self._spill_file = None


class SpillableBatch:
    """Operator-facing handle that re-materializes its batch from
    whatever tier it is on (SpillableColumnarBatch.scala)."""

    def __init__(self, catalog: BufferCatalog, batch: DeviceBatch,
                 priority: int = PRIORITY_DEFAULT):
        self._catalog = catalog
        # Host-known shape facts, so consumers (the exchange's reduce
        # side, out-of-core bucketing, grace joins) group handles by size
        # with no device sync and no restore.
        self.capacity = batch.capacity
        self.size_bytes = batch.device_size_bytes()
        self.rows_hint = batch.rows_hint
        self._id = catalog.add_batch(batch, priority)
        self._closed = False

    @property
    def buffer_id(self) -> int:
        return self._id

    def get(self) -> DeviceBatch:
        return self._catalog.acquire_batch(self._id)

    def release(self, priority: int = PRIORITY_DEFAULT):
        self._catalog.release(self._id, priority)

    def close(self):
        if not self._closed:
            self._catalog.remove(self._id)
            self._closed = True

    def __enter__(self):
        return self.get()

    def __exit__(self, *exc):
        self.release()
        return False


# -- the device semaphore -------------------------------------------------------

_GLOBAL_SEM: Optional["TpuSemaphore"] = None
_GLOBAL_SEM_LOCK = threading.Lock()

# Class-aware device preemption (spark.rapids.sql.scheduler.preemption.
# enabled): process-global like the wire codec and the recorder, so the
# last collect's conf wins. Off keeps the acquire path the flat
# class-blind semaphore.
_PREEMPT_ENABLED = False


def preemption_configure(conf) -> None:
    """Adopt this query's preemption setting (the collect funnel calls
    it before it takes the semaphore)."""
    global _PREEMPT_ENABLED
    from spark_rapids_tpu_torch import config as C
    _PREEMPT_ENABLED = bool(conf.get(C.PREEMPTION_ENABLED))


def preemption_enabled() -> bool:
    return _PREEMPT_ENABLED


def _class_rank(token) -> int:
    """The token's priority rank at the device gate (lower is better).
    An unclassed (FIFO) query ranks as the default class, so preemption
    engages only when some query declared a class."""
    from spark_rapids_tpu_torch.parallel.qos.policy import (CLASS_RANK,
                                                            DEFAULT_CLASS)
    cls = getattr(token, "qos_class", None) or DEFAULT_CLASS
    return CLASS_RANK.get(cls, CLASS_RANK[DEFAULT_CLASS])


def pressure_score(catalog: Optional[BufferCatalog]) -> float:
    """Memory-pressure score of one catalog: its device fraction
    dominates (that is what runs out), host and disk occupancy add
    smaller terms so a catalog already spilling reads hotter than one
    merely full. Range [0, 1.35]; each tier's fraction clamps at 1."""
    if catalog is None:
        return 0.0
    dev = min(catalog.device_bytes / max(catalog.device_budget, 1), 1.0)
    host = min(catalog.host_bytes / max(catalog.host_budget, 1), 1.0)
    disk = min(catalog.disk_bytes / max(catalog.host_budget, 1), 1.0)
    return round(dev + 0.25 * host + 0.1 * disk, 4)


def get_tpu_semaphore(permits: int) -> "TpuSemaphore":
    """THE process-wide device semaphore, sized by the FIRST
    ``spark.rapids.sql.concurrentTpuTasks`` seen (the reference sizes one
    GpuSemaphore per executor at startup, GpuSemaphore.scala:63; later
    confs are ignored, so the bound stays global). The device collect
    funnel (``ops/base.py`` ``run_batches``) holds one permit around its
    device work."""
    global _GLOBAL_SEM
    with _GLOBAL_SEM_LOCK:
        if _GLOBAL_SEM is None:
            _GLOBAL_SEM = TpuSemaphore(permits)
        return _GLOBAL_SEM


class TpuSemaphore:
    """The task-admission semaphore (GpuSemaphore.scala:101): at most
    ``spark.rapids.sql.concurrentTpuTasks`` queries issue device work at
    once; the context manager releases the permit.

    With ``scheduler.preemption.enabled`` the same permits become a
    CLASS-RANKED gate: acquisitions with a query token queue in (class
    rank, arrival) order, only the head waiter takes a permit, and a head
    waiter that outranks a running holder asks the WORST-ranked holder to
    yield at its next partition boundary (``QueryToken.request_preempt``;
    cooperative, so the victim's live device state is catalog-registered
    data at rest when the permit comes back). Victims re-enter through
    :meth:`wait_resume`, which queues at their own rank. Off (the
    default), every acquire takes the flat path.

    The acquire is a ``tpu-semaphore-acquire`` span in category
    ``queued``, and it polls the query's cancel event, so a query
    cancelled while it waits for the card unwinds. ``in_use`` and
    ``max_in_use`` (port-only attribution) count the permits held through
    the context manager on either path, now and at most since
    :meth:`reset_peak`."""

    def __init__(self, permits: int = 2):
        self._sem = threading.Semaphore(permits)
        self.permits = permits
        # The classed gate's state (used with preemption on only).
        self._gate_lock = threading.Lock()
        self._seq = 0
        self._waiters: List[list] = []        # [rank, seq, token]
        self._holders: Dict[int, list] = {}   # id(token) -> [tok, rank, n]
        self.preempt_requests = 0
        self.in_use = 0
        self.max_in_use = 0

    def __enter__(self):
        from spark_rapids_tpu_torch import monitoring
        with monitoring.span("tpu-semaphore-acquire", "queued",
                             level=monitoring.LEVEL_QUERY):
            tok = faults.get_query_token()
            if tok is None:
                self._sem.acquire()
            elif _PREEMPT_ENABLED:
                self._acquire_classed(tok)
            else:
                while not self._sem.acquire(timeout=0.05):
                    if tok.cancelled():
                        raise tok.error()
        with self._gate_lock:
            self.in_use += 1
            self.max_in_use = max(self.max_in_use, self.in_use)
        return self

    def reset_peak(self) -> None:
        with self._gate_lock:
            self.max_in_use = self.in_use

    # -- the class-ranked gate (preemption on only) ---------------------------
    def _enqueue(self, tok) -> list:
        with self._gate_lock:
            self._seq += 1
            w = [_class_rank(tok), self._seq, tok]
            self._waiters.append(w)
            return w

    def _head(self, w: list) -> bool:
        """Whether ``w`` is the best-ranked waiter (class rank, then
        arrival): only the head takes a permit."""
        return min(self._waiters, key=lambda x: (x[0], x[1])) is w

    def _request_preempt_locked(self, rank: int) -> None:
        """A head waiter of rank ``rank`` found every permit held: ask
        the worst holder of a strictly lower class to yield. Idempotent
        per victim (the event stays set)."""
        victim = None
        for tok, hrank, _n in self._holders.values():
            if hrank > rank and tok.preempt_enabled \
                    and not tok.preempt.is_set():
                if victim is None or hrank > victim[1]:
                    victim = (tok, hrank)
        if victim is not None:
            from spark_rapids_tpu_torch.parallel.qos.policy import CLASSES
            self.preempt_requests += 1
            victim[0].request_preempt(CLASSES[rank]
                                      if 0 <= rank < len(CLASSES)
                                      else None)

    def _acquire_classed(self, tok) -> None:
        w = self._enqueue(tok)
        rank = w[0]
        try:
            while True:
                if tok.cancelled():
                    raise tok.error()
                with self._gate_lock:
                    if self._head(w):
                        if self._sem.acquire(blocking=False):
                            self._waiters.remove(w)
                            h = self._holders.get(id(tok))
                            if h is None:
                                self._holders[id(tok)] = [tok, rank, 1]
                            else:
                                h[2] += 1
                            return
                        self._request_preempt_locked(rank)
                time.sleep(0.005)
        except BaseException:
            with self._gate_lock:
                if w in self._waiters:
                    self._waiters.remove(w)
            raise

    def wait_resume(self, tok) -> None:
        """Block a preempted query until the gate would grant its class a
        permit again (the preemptor and every better-ranked waiter have
        drained), without keeping the permit: the re-collect acquires it
        as usual. A no-op with preemption off."""
        if not _PREEMPT_ENABLED:
            return
        self._acquire_classed(tok)
        self.release_classed(tok)

    def release_classed(self, tok) -> None:
        with self._gate_lock:
            h = self._holders.get(id(tok))
            if h is not None:
                h[2] -= 1
                if h[2] <= 0:
                    self._holders.pop(id(tok), None)
        self._sem.release()

    def __exit__(self, *exc):
        with self._gate_lock:
            self.in_use -= 1
        tok = faults.get_query_token()
        if tok is not None and _PREEMPT_ENABLED:
            self.release_classed(tok)
            return False
        with self._gate_lock:
            # A holder registered by the classed gate may release after
            # the setting flipped (mixed confs): keep the table honest.
            if tok is not None:
                self._holders.pop(id(tok), None)
        self._sem.release()
        return False

    @property
    def holders(self) -> List[tuple]:
        """(query id, class rank) of the classed gate's holders."""
        with self._gate_lock:
            return [(t.query_id, r) for t, r, _n in
                    self._holders.values()]
