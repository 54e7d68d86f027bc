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
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import faults
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


def _numpy_to_batch(meta: dict, bufs: list) -> DeviceBatch:
    """Inverse of :func:`_batch_to_numpy`, onto the device it came from."""
    device = torch.device(meta["device"])

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


@dataclasses.dataclass
class BufferEntry:
    buffer_id: int
    tier: str
    size_bytes: int
    priority: int
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
                 debug: bool = False):
        from spark_rapids_tpu_torch.memory.compression import CODEC_NAMES
        if (compression_codec or "").lower() not in CODEC_NAMES:
            raise ValueError(
                f"unknown compression codec {compression_codec!r}")
        self.device_budget = int(device_budget_bytes)
        self.host_budget = int(host_budget_bytes)
        self.spill_dir = spill_dir or default_spill_dir()
        self.codec_name = compression_codec
        self.debug = debug
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
                bid, StorageTier.DEVICE, size, priority, device_batch=batch)
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
            self._ensure_device_room(e.size_bytes)
            batch = _numpy_to_batch(meta, bufs)
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
