"""File scans: parquet / ORC / CSV (port of the JAX package's
``io/scan.py``; ref GpuParquetScan.scala:84, GpuOrcScan.scala,
GpuBatchScanExec.scala's CSV path).

Reader strategies (``spark.rapids.sql.format.<fmt>.reader.type``,
RapidsConf.scala:510):

- PERFILE: decode one scan unit at a time and upload its batches.
- MULTITHREADED: a host thread pool decodes, wire-encodes and packs units
  in the background while the consumer uploads earlier ones
  (MultiFileCloudParquetPartitionReader's overlap,
  GpuParquetScan.scala:1144). At most ``multiThreadedRead.numThreads``
  units are in flight.
- COALESCING: decode several units and concatenate their rows into fewer,
  larger uploads (MultiFileParquetPartitionReader:823's stitching).
- AUTO: MULTITHREADED.

A scan unit is one parquet row group, one ORC stripe or one CSV file; the
footer parse that lists them runs on the host. Units are dealt
round-robin over ``min(units, 8)`` partitions, so the port's partitions
hold the reference's rows in the reference's order.

Predicate pushdown: pushed conjuncts (``plan/pruning.pushdown_filters``)
are checked against per-unit min / max / null statistics (parquet footer
statistics; for ORC, whose statistics pyarrow does not expose, the
engine's own stripe index built on first contact), and a unit the stats
prove empty is skipped without reading its data
(``numSkippedRowGroups``). The filter itself still runs above the scan.
A ``>`` or ``>=`` on a float column never skips: NaN ranks above every
float, and neither format's statistics see NaN (the reference skips
there and loses the NaN rows). A date column's statistics compare as day
numbers against a pushed date literal (the reference keeps every unit
there: its date statistics and day numbers do not compare).
A pushed value is a literal or a plan-cache ``BindValue`` slot
(``exprs/bindslots.py``), resolved against each execution's binding
vector (``_resolved_predicates``) wherever units are listed: the host
engine, the pipeline's prefetch threads and the device half. Each unit's
host decode is a ``scan`` fault site (``faults.py``), on whichever thread
decodes it: the consumer, a pipeline prefetch thread or a MULTITHREADED
reader thread, the last two under the consumer's query token, recovery
sink and active catalog; a fault there re-raises where the consumer takes
the unit.

The device half takes the plan's ``device`` as ``InMemorySourceExec``
does: every decoded batch is packed by the wire codec
(``wire.pack_batch``), grouped (``wire.plan_upload_groups``) and uploaded
(``wire.upload_packed_group``) under ``oom.retry_on_oom``, so a run-coded
column reaches the RLE decode kernel (K4) exactly as an in-memory
source's does. Decoded units stay on the device in ``DEVICE_SCAN_CACHE``
(keyed by the file's identity, the unit, the pruned schema, the reader
options and the device), and a repeated scan serves them
(``scanCacheHits``); a device OOM drops the whole cache before anything
spills (``memory/oom.py``). Each unit publishes its path under
``input_file:{id(scan)}:{partition}`` before its first batch, for
``input_file_name()`` (``ops/basic.py`` ``_input_file_key``).

pyarrow is imported inside the functions that read, never at import.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import datetime
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch import (
    DeviceLike, config as C, faults, resolve_device)
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.io.arrow_convert import (
    arrow_to_host_batch, schema_from_arrow)
from spark_rapids_tpu_torch.memory import oom
from spark_rapids_tpu_torch.ops.base import (
    LeafExec, Schema, record_batch, timed)


def infer_schema(fmt: str, paths: Sequence[str], options: Dict) -> Schema:
    """Footer- or header-only schema inference from the first path."""
    path = paths[0]
    if fmt == "parquet":
        import pyarrow.parquet as papq
        return schema_from_arrow(papq.ParquetFile(path).schema_arrow)
    if fmt == "orc":
        import pyarrow.orc as paorc
        return schema_from_arrow(paorc.ORCFile(path).schema)
    if fmt == "csv":
        import pyarrow.csv as pacsv
        # Stream only the first block to infer types (no full-file parse).
        read_opts = _csv_read_options(options, sample=True)
        with pacsv.open_csv(path, **read_opts) as reader:
            return schema_from_arrow(reader.schema)
    raise ValueError(f"unknown format {fmt}")


def _csv_read_options(options: Dict, sample: bool = False) -> Dict:
    """pyarrow CSV options from the reader's ``sep`` / ``delimiter`` and
    ``header`` (default true) options."""
    import pyarrow.csv as pacsv
    kwargs = {}
    parse = pacsv.ParseOptions(
        delimiter=options.get("sep", options.get("delimiter", ",")))
    has_header = str(options.get("header", "true")).lower() in (
        "true", "1", "yes")
    read_kwargs = {"autogenerate_column_names": not has_header}
    if sample:
        read_kwargs["block_size"] = 1 << 20   # schema from first 1MB only
    kwargs["parse_options"] = parse
    kwargs["read_options"] = pacsv.ReadOptions(**read_kwargs)
    return kwargs


@dataclasses.dataclass(frozen=True)
class ScanUnit:
    """One independently readable slice of a file: a parquet row group,
    an ORC stripe, or a whole CSV file (``index is None``)."""

    path: str
    index: Optional[int]        # row group / stripe ordinal
    rows: int                   # 0 = unknown (ORC, CSV)


# (path, mtime, size) -> parquet FileMetaData. Footer parses repeat across
# planning and every partition, so they are memoized; a new entry evicts
# stale entries of the same path (a rewritten file), and the cache is
# FIFO-capped. Locked: prefetch threads probe partitions concurrently.
_PQ_META_CACHE: Dict[Tuple[str, float, int], Any] = {}
_PQ_META_CACHE_MAX = 1024
_PQ_META_LOCK = threading.Lock()


def _parquet_metadata(path: str):
    st = os.stat(path)
    key = (path, st.st_mtime, st.st_size)
    with _PQ_META_LOCK:
        md = _PQ_META_CACHE.get(key)
    if md is None:
        import pyarrow.parquet as papq
        md = papq.ParquetFile(path).metadata
        with _PQ_META_LOCK:
            for stale in [k for k in _PQ_META_CACHE if k[0] == path]:
                del _PQ_META_CACHE[stale]
            while len(_PQ_META_CACHE) >= _PQ_META_CACHE_MAX:
                _PQ_META_CACHE.pop(next(iter(_PQ_META_CACHE)))
            _PQ_META_CACHE[key] = md
    return md


def enumerate_units(fmt: str, paths: Sequence[str]) -> List[ScanUnit]:
    """The scan's split units, from the footers (GpuParquetScan.scala:823
    block enumeration analog)."""
    units: List[ScanUnit] = []
    for path in paths:
        if fmt == "parquet":
            md = _parquet_metadata(path)
            for rg in range(md.num_row_groups):
                units.append(ScanUnit(path, rg, md.row_group(rg).num_rows))
        elif fmt == "orc":
            import pyarrow.orc as paorc
            f = paorc.ORCFile(path)
            for si in range(f.nstripes):
                units.append(ScanUnit(path, si, 0))
        else:
            units.append(ScanUnit(path, None, 0))
    return units


# ORC stripe statistics (OrcFilters.scala:206 pushdown analog): pyarrow
# exposes no ORC column statistics, so the engine builds its own
# per-stripe min / max / null index on first contact with a stripe (one
# decode of the predicate columns) and prunes every later scan from it.
# (path, mtime, size, stripe) -> {col: (min, max, null_count, rows)}. A
# true LRU: hits move to the end, and only a new key evicts.
_ORC_STATS_CACHE: "OrderedDict[Tuple, Dict[str, tuple]]" = OrderedDict()
_ORC_STATS_CACHE_MAX = 4096
_ORC_STATS_LOCK = threading.Lock()


class _Stat:
    """Duck-typed stand-in for a parquet ColumnChunk statistics object."""

    def __init__(self, mn, mx, null_count):
        self.min, self.max = mn, mx
        self.null_count = null_count
        self.has_min_max = mn is not None


def _orc_stripe_stats(unit: ScanUnit, names: Sequence[str]
                      ) -> Tuple[Dict[str, "_Stat"], int]:
    """(per-column stats, stripe row count). A column missing from the
    file caches a no-stats marker so it is never probed again.
    Serialized by a lock: prefetch threads prune partitions concurrently
    and an OrderedDict must never interleave mutations."""
    st = os.stat(unit.path)
    key = (unit.path, st.st_mtime, st.st_size, unit.index)
    with _ORC_STATS_LOCK:
        cached = _ORC_STATS_CACHE.get(key)
        if cached is not None:
            _ORC_STATS_CACHE.move_to_end(key)
            cached = dict(cached)
    need = [n for n in names if cached is None or n not in cached]
    if need:
        import pyarrow.compute as pc
        import pyarrow.orc as paorc
        f = paorc.ORCFile(unit.path)
        have = set(f.schema.names)
        cols = [n for n in need if n in have]
        entry = dict(cached or {})
        if cols:
            tab = f.read_stripe(unit.index, columns=cols)
            for n in cols:
                c = tab.column(n)
                nulls = c.null_count
                if nulls == len(c):
                    entry[n] = (None, None, nulls, len(c))
                else:
                    mm = pc.min_max(c).as_py()
                    entry[n] = (mm["min"], mm["max"], nulls, len(c))
        for n in need:
            if n not in entry:      # absent column: unknown-stats marker
                entry[n] = (None, None, None, -1)
        with _ORC_STATS_LOCK:
            resident = _ORC_STATS_CACHE.get(key)
            if resident is not None:
                # A concurrent prober filled other columns meanwhile:
                # merge instead of clobbering its work.
                entry = {**resident, **entry}
            else:
                while len(_ORC_STATS_CACHE) >= _ORC_STATS_CACHE_MAX:
                    _ORC_STATS_CACHE.popitem(last=False)
            _ORC_STATS_CACHE[key] = entry
            _ORC_STATS_CACHE.move_to_end(key)
        cached = entry
    num_rows = max((rows for (_, _, _, rows) in cached.values()
                    if rows >= 0), default=0)
    return ({n: _Stat(mn, mx, nulls)
             for n, (mn, mx, nulls, rows) in cached.items()
             if rows >= 0}, num_rows)


def _unit_survives(fmt: str, unit: ScanUnit,
                   predicates: Sequence[Tuple[str, str, Any]]) -> bool:
    """False when the unit's statistics prove no row satisfies ALL pushed
    conjuncts (conservative: missing or odd stats keep the unit). A
    comparison is never true for NULL, so bounds over the non-null values
    suffice. Parquet reads footer stats; ORC the engine's stripe index;
    CSV has none."""
    if not predicates or fmt == "csv":
        return True
    if fmt == "orc":
        stats_by_name, num_rows = _orc_stripe_stats(
            unit, [name for name, _, _ in predicates])
        return _stats_survive(stats_by_name, num_rows, predicates)
    rg = _parquet_metadata(unit.path).row_group(unit.index)
    stats_by_name = {}
    for ci in range(rg.num_columns):
        col = rg.column(ci)
        stats_by_name[col.path_in_schema] = col.statistics
    return _stats_survive(stats_by_name, rg.num_rows, predicates)


_EPOCH = datetime.date(1970, 1, 1)


def _as_days(x):
    """A DATE statistic (``datetime.date``, ``numpy.datetime64``) as the
    day number a pushed date literal carries; anything else as is. The
    JAX package compares the two and keeps the unit on the TypeError, so
    a date predicate never skips there; the port's stats skip it."""
    if isinstance(x, datetime.date) and not isinstance(x, datetime.datetime):
        return (x - _EPOCH).days
    if isinstance(x, np.datetime64):
        return int(x.astype("datetime64[D]").astype(np.int64))
    return x


def _stats_survive(stats_by_name, num_rows,
                   predicates: Sequence[Tuple[str, str, Any]]) -> bool:
    for name, op, value in predicates:
        st = stats_by_name.get(name)
        if st is None:
            continue
        try:
            if op == "isnotnull":
                if st.null_count is not None and \
                        st.null_count == num_rows:
                    return False
                continue
            if not st.has_min_max:
                # All-null pages carry no min/max: a comparison can never
                # be true then.
                if st.null_count is not None and \
                        st.null_count == num_rows:
                    return False
                continue
            mn, mx = st.min, st.max
            if op in ("gt", "ge") and isinstance(mx, float):
                # NaN ranks above every float (exprs/predicates.py), so
                # `x > v` keeps NaN rows; parquet and ORC leave NaN out of
                # min / max and count it nowhere: keep the unit.
                continue
            v = value.decode() if isinstance(value, bytes) else value
            mn = mn.decode() if isinstance(mn, bytes) else mn
            mx = mx.decode() if isinstance(mx, bytes) else mx
            if isinstance(v, int):
                mn, mx = _as_days(mn), _as_days(mx)
            if op == "eq" and (v < mn or v > mx):
                return False
            if op == "lt" and mn >= v:
                return False
            if op == "le" and mn > v:
                return False
            if op == "gt" and mx <= v:
                return False
            if op == "ge" and mx < v:
                return False
        except TypeError:
            continue    # incomparable stat/value types: keep the unit
    return True


def _read_unit_batches(fmt: str, unit: ScanUnit, options: Dict,
                       batch_rows: int,
                       columns: Optional[List[str]] = None
                       ) -> Iterator[HostBatch]:
    """Decode one scan unit into host batches of at most ``batch_rows``
    rows; ``columns`` restricts the read to the pruned schema (columns
    nothing reads are never decoded)."""
    if fmt == "parquet":
        import pyarrow.parquet as papq
        pf = papq.ParquetFile(unit.path)
        for rb in pf.iter_batches(batch_size=batch_rows,
                                  row_groups=[unit.index],
                                  columns=columns):
            yield arrow_to_host_batch(rb)
    elif fmt == "orc":
        import pyarrow.orc as paorc
        f = paorc.ORCFile(unit.path)
        yield arrow_to_host_batch(
            f.read_stripe(unit.index, columns=columns))
    elif fmt == "csv":
        import pyarrow.csv as pacsv
        kwargs = _csv_read_options(options)
        if columns:
            kwargs["convert_options"] = pacsv.ConvertOptions(
                include_columns=list(columns))
        tbl = pacsv.read_csv(unit.path, **kwargs)
        for rb in tbl.to_batches(max_chunksize=batch_rows):
            yield arrow_to_host_batch(rb)
    else:
        raise ValueError(fmt)


class DeviceScanCache:
    """Transparent device-resident cache of decoded scan units: a unit's
    device batches stay where they were uploaded, keyed by file identity
    (path, mtime, size), unit ordinal, pruned schema, reader options,
    batch rows and the device, so a repeated query serves them without
    touching the host->device link. The device is in the key because one
    process may run CPU and CUDA sessions: a CPU scan is never served a
    CUDA entry, nor the reverse. LRU-evicted down to the byte budget;
    rewritten files miss through the mtime / size key."""

    def __init__(self):
        self._entries: dict = {}       # key -> [DeviceBatch]
        self._bytes: Dict[Any, int] = {}
        self._total = 0
        # Probed and filled from prefetch threads and the consumer: the
        # LRU reorder and the accounting must be atomic.
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            e = self._entries.pop(key, None)
            if e is not None:
                self._entries[key] = e     # move to MRU position
            return e

    def put(self, key, batches, budget: int):
        size = sum(b.device_size_bytes() for b in batches)
        if size > budget:
            return
        with self._lock:
            if key in self._entries:
                return                     # concurrent filler won
            while self._total + size > budget and self._entries:
                old_key = next(iter(self._entries))
                self._entries.pop(old_key)
                self._total -= self._bytes.pop(old_key)
            self._entries[key] = list(batches)
            self._bytes[key] = size
            self._total += size

    @property
    def nbytes(self) -> int:
        return self._total

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._bytes.clear()
            self._total = 0

    def drop_device_entries(self) -> int:
        """Drop the entries held off the CPU (the OOM ladder's first rung,
        ``memory/oom.py``); returns the bytes they held."""
        with self._lock:
            dropped = 0
            for key in [k for k in self._entries if k[-1] != "cpu"]:
                del self._entries[key]
                dropped += self._bytes.pop(key)
            self._total -= dropped
        return dropped


DEVICE_SCAN_CACHE = DeviceScanCache()


def _pack_unit(fmt: str, unit: ScanUnit, options: Dict, rows: int,
               columns: List[str], m=None) -> list:
    """Decode, wire-encode and pack one unit: the whole host half of its
    upload, on any thread (numpy and pyarrow only, no CUDA). Adds the
    host ns to ``decodeTime`` of ``m`` when given."""
    from spark_rapids_tpu_torch.columnar import wire
    t0 = time.perf_counter_ns()
    encs = [wire.pack_batch(hb)
            for hb in _read_unit_batches(fmt, unit, options, rows, columns)]
    if m is not None:
        m.add("decodeTime", time.perf_counter_ns() - t0)
    return encs


class FileScanExec(LeafExec):
    """Leaf scan over N files of one format, split at scan-unit (row
    group / stripe / CSV file) granularity, with pushed predicates as
    stats skips and the reader strategies of the module doc. Uploads to
    ``device`` (``None`` = the CUDA card, raising when there is none)."""

    def __init__(self, fmt: str, paths: Sequence[str], schema: Schema,
                 options: Optional[Dict] = None,
                 num_partitions: Optional[int] = None,
                 force_perfile: bool = False,
                 predicates: Sequence[Tuple[str, str, Any]] = (),
                 device: DeviceLike = None):
        super().__init__()
        self.fmt = fmt
        self.paths = list(paths)
        self._schema = tuple(schema)
        self.options = dict(options or {})
        self._columns = [n for n, _ in self._schema]
        self.predicates = tuple(predicates)
        self._opts_key = tuple(sorted((str(k), str(v))
                                      for k, v in self.options.items()))
        self._units = enumerate_units(fmt, self.paths)
        self._parts = num_partitions or min(len(self._units), 8) or 1
        # input_file_name() in the plan: batches must not span files.
        self.force_perfile = force_perfile
        self.device = resolve_device(device)

    def __setstate__(self, state) -> None:
        # An unpickled scan (a cluster worker's stage) parsed its footers
        # in another process, so its first arrow allocation would come
        # from a short-lived prefetch thread: under pyarrow's default
        # mimalloc pool, a pool first made on a thread that then exits
        # left later reader threads segfaulting in ``ParquetFile``. Make
        # the pool on the unpickling thread, as a scan built here makes
        # it on the building thread.
        import pyarrow as pa
        pa.default_memory_pool()
        self.__dict__.update(state)

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def name(self) -> str:
        return f"{type(self).__name__}[{self.fmt}]"

    def num_partitions(self, ctx) -> int:
        return self._parts

    def _resolved_predicates(self, ctx) -> Tuple:
        """The pushed conjuncts with plan-cache bind slots resolved against
        THIS execution's binding vector (``ctx.cache['plan_binds']``). A
        slot predicate with no binding in scope is dropped: stats skipping
        is an optimization, and the filter above still runs."""
        from spark_rapids_tpu_torch.exprs.bindslots import BindValue
        if not any(isinstance(v, BindValue) for _, _, v in self.predicates):
            return self.predicates
        binds = None if ctx is None else ctx.cache.get("plan_binds")
        out = []
        for name, op, value in self.predicates:
            if isinstance(value, BindValue):
                if binds is None or value.slot >= len(binds):
                    continue
                value = binds[value.slot]
            out.append((name, op, value))
        return tuple(out)

    def _units_of(self, partition: int, ctx=None,
                  m=None) -> List[ScanUnit]:
        """This partition's units, minus the ones the stats skip under
        this execution's predicates."""
        mine = [u for i, u in enumerate(self._units)
                if i % self._parts == partition]
        predicates = self._resolved_predicates(ctx)
        if not predicates:
            return mine
        kept = [u for u in mine if _unit_survives(self.fmt, u, predicates)]
        if m is not None and len(kept) < len(mine):
            m.add("numSkippedRowGroups", len(mine) - len(kept))
        return kept

    def _reader_type(self, ctx) -> str:
        if self.force_perfile:
            return "PERFILE"
        entry = {"parquet": C.PARQUET_READER_TYPE,
                 "orc": C.ORC_READER_TYPE,
                 "csv": C.CSV_READER_TYPE}[self.fmt]
        rt = str(ctx.conf.get(entry)).upper()
        if rt == "AUTO":
            return "MULTITHREADED"
        return rt

    def _batch_rows(self, ctx) -> int:
        return int(ctx.conf.get(C.MAX_READER_BATCH_SIZE_ROWS))

    def _publish_input_file(self, ctx, partition: int, path: str,
                            host: bool = False) -> None:
        """Publish the current file for input_file_name() above (the
        GpuInputFileBlock analog; per unit, before its first batch)."""
        prefix = "input_file_host" if host else "input_file"
        ctx.cache[f"{prefix}:{id(self)}:{partition}"] = path

    # -- host engine ---------------------------------------------------------
    def execute_host(self, ctx, partition):
        rows = self._batch_rows(ctx)
        for unit in self._units_of(partition, ctx):
            self._publish_input_file(ctx, partition, unit.path, host=True)
            yield from _read_unit_batches(self.fmt, unit, self.options,
                                          rows, self._columns)

    # -- pipelined prefetch (parallel/pipeline.py) ---------------------------
    def host_prefetchable(self) -> bool:
        return True

    def _prefetch_key(self, partition: int) -> str:
        return f"scan-prefetch:{id(self):x}:{partition}"

    def drop_prefetch(self, ctx) -> None:
        for p in range(self._parts):
            ctx.cache.pop(self._prefetch_key(p), None)

    def prefetch_host(self, ctx, partition) -> None:
        """The host half of one partition: stats pruning, unit decode,
        wire encode and pack, everything before the upload. Runs on a
        pipeline prefetch thread; the payload lands in ``ctx.cache`` and
        the ordered consumer's ``execute_device`` pops it and only
        uploads. Payload entries are ``(unit, [EncodedBatch...])``,
        ``(unit, "cached")`` for a device-cache hit, or ``(None, encs)``
        for a COALESCING merge (which has no unit identity)."""
        from spark_rapids_tpu_torch.parallel import pipeline as PL
        m = ctx.metrics_for(self)
        rt = self._reader_type(ctx)
        rows = self._batch_rows(ctx)
        units = self._units_of(partition, ctx, m)
        budget = int(ctx.conf.get(C.SCAN_CACHE_BYTES))
        use_cache = budget > 0 and rt != "COALESCING"
        if rt == "COALESCING":
            payload = [(None, [enc])
                       for enc in self._coalesced(m, units, rows)]
        else:
            payload = []
            for unit in units:
                if use_cache and DEVICE_SCAN_CACHE.get(
                        self._unit_cache_key(unit, rows)) is not None:
                    payload.append((unit, "cached"))
                    continue
                faults.fault_point("scan")
                payload.append((unit, _pack_unit(
                    self.fmt, unit, self.options, rows, self._columns, m)))
        staged = sum(e.nbytes for _, item in payload
                     if item != "cached" for e in item)
        PL.record(ctx, "stagingBytesPrefetched", staged)
        ctx.cache[self._prefetch_key(partition)] = payload

    def _upload_run(self, ctx, m, run, rows, partition, budget):
        """Upload a run of consecutive payload entries ``(unit_or_None,
        [EncodedBatch...])``, members below ``wire.minUploadBytes`` sharing
        one copy (``wire.plan_upload_groups``). The yield order, and so
        every bit downstream, is that of per-batch uploads."""
        from spark_rapids_tpu_torch.columnar import wire
        flat = []                      # (entry index, EncodedBatch)
        for ei, (_unit, encs) in enumerate(run):
            for enc in encs:
                flat.append((ei, enc))
        groups = wire.plan_upload_groups(
            [e.nbytes for _, e in flat],
            int(ctx.conf.get(C.WIRE_MIN_UPLOAD_BYTES)))
        entry_batches: List[List] = [[] for _ in run]
        started = set()
        for g in groups:
            with timed(m, "bufferTime"):
                outs = oom.retry_on_oom(wire.upload_packed_group,
                                        [flat[i][1] for i in g],
                                        self.device)
            for i, b in zip(g, outs):
                ei = flat[i][0]
                unit = run[ei][0]
                if ei not in started:
                    started.add(ei)
                    if unit is not None:
                        self._publish_input_file(ctx, partition,
                                                 unit.path)
                entry_batches[ei].append(b)
                record_batch(m, b)
                yield b
                last_of_entry = i + 1 >= len(flat) or \
                    flat[i + 1][0] != ei
                if last_of_entry and unit is not None and budget > 0:
                    DEVICE_SCAN_CACHE.put(self._unit_cache_key(unit, rows),
                                          entry_batches[ei], budget)

    def _device_prefetched(self, ctx, m, payload, rows, partition,
                           budget):
        """Consume a prefetched partition, upload only, in payload order
        (the serial decode order, so the rows match the serial path bit
        for bit)."""
        run: List[tuple] = []
        for unit, item in payload:
            if unit is not None and item == "cached":
                if run:
                    yield from self._upload_run(ctx, m, run, rows,
                                                partition, budget)
                    run = []
                hit = DEVICE_SCAN_CACHE.get(
                    self._unit_cache_key(unit, rows)) \
                    if budget > 0 else None
                if hit is not None:
                    m.add("scanCacheHits", 1)
                    self._publish_input_file(ctx, partition, unit.path)
                    for b in hit:
                        record_batch(m, b)
                        yield b
                else:
                    # Evicted between prefetch and consume: decode inline.
                    yield from self._device_perfile(ctx, m, [unit], rows,
                                                    partition, budget)
                continue
            run.append((unit, item))
        if run:
            yield from self._upload_run(ctx, m, run, rows, partition,
                                        budget)

    # -- device engine -------------------------------------------------------
    def _unit_cache_key(self, unit: ScanUnit, rows: int):
        try:
            st = os.stat(unit.path)
        except OSError:
            return None
        # Reader options and the schema change how the same bytes decode,
        # and the device where they live: all of them key the cache.
        return (self.fmt, unit.path, st.st_mtime_ns, st.st_size, unit.index,
                self._schema, self._opts_key, rows, str(self.device))

    def execute_device(self, ctx, partition):
        m = ctx.metrics_for(self)
        rt = self._reader_type(ctx)
        rows = self._batch_rows(ctx)
        budget = int(ctx.conf.get(C.SCAN_CACHE_BYTES))
        pre = ctx.cache.pop(self._prefetch_key(partition), None)
        if pre is not None:
            # The pipeline already decoded, encoded and packed this
            # partition on a host thread; this ordered call only uploads.
            yield from self._device_prefetched(ctx, m, pre, rows, partition,
                                               budget)
            return
        units = self._units_of(partition, ctx, m)
        # COALESCING merges units into one upload, so its outputs have no
        # unit identity to cache under; the per-unit strategies cache.
        use_cache = budget > 0 and rt != "COALESCING"
        if not use_cache:
            if rt == "MULTITHREADED":
                yield from self._device_multithreaded(ctx, m, units, rows,
                                                      partition, 0)
            elif rt == "COALESCING":
                yield from self._device_coalescing(ctx, m, units, rows,
                                                   partition)
            else:
                yield from self._device_perfile(ctx, m, units, rows,
                                                partition, 0)
            return
        # Serve cache hits inline; read contiguous miss runs through the
        # configured strategy (which inserts them into the cache).
        read = self._device_multithreaded if rt == "MULTITHREADED" \
            else self._device_perfile
        run: List[ScanUnit] = []
        for unit in units:
            hit = DEVICE_SCAN_CACHE.get(self._unit_cache_key(unit, rows))
            if hit is None:
                run.append(unit)
                continue
            if run:
                yield from read(ctx, m, run, rows, partition, budget)
                run = []
            m.add("scanCacheHits", 1)
            self._publish_input_file(ctx, partition, unit.path)
            for b in hit:
                record_batch(m, b)
                yield b
        if run:
            yield from read(ctx, m, run, rows, partition, budget)

    def _device_perfile(self, ctx, m, units, rows, partition, budget):
        for unit in units:
            faults.fault_point("scan")
            encs = _pack_unit(self.fmt, unit, self.options, rows,
                              self._columns, m)
            yield from self._upload_run(ctx, m, [(unit, encs)], rows,
                                        partition, budget)

    def _device_multithreaded(self, ctx, m, units, rows, partition,
                              budget=0):
        """Background host decode overlapped with the uploads
        (GpuParquetScan.scala:1144's thread-pool overlap), streaming: at
        most ``numThreads`` units are in flight, and each finished unit
        uploads while later ones decode. The reader threads decode,
        encode and pack; only this thread uploads."""
        nthreads = int(ctx.conf.get(
            C.PARQUET_MULTITHREADED_READ_NUM_THREADS))
        if not units:
            return
        window = max(1, min(nthreads, len(units)))
        # Reader threads take over this thread's query token, recovery
        # sink and active catalog (thread-locals do not cross threads).
        token = faults.get_query_token()
        sink = faults.get_recovery_sink()
        catalog = oom.get_active_catalog()

        def read_unit(u):
            faults.set_query_token(token)
            oom.set_active_catalog(catalog, sink)
            try:
                faults.fault_point("scan")
                return _pack_unit(self.fmt, u, self.options, rows,
                                  self._columns, m)
            finally:
                oom.set_active_catalog(None)
                faults.set_query_token(None)

        with concurrent.futures.ThreadPoolExecutor(
                max_workers=window,
                thread_name_prefix="srt-scan-read") as pool:
            inflight = []          # [(unit, future)] bounded by `window`
            it = iter(units)
            for u in it:
                inflight.append((u, pool.submit(read_unit, u)))
                if len(inflight) >= window:
                    break
            while inflight:
                unit, fut = inflight.pop(0)
                encoded = fut.result()
                nxt = next(it, None)
                if nxt is not None:
                    inflight.append((nxt, pool.submit(read_unit, nxt)))
                yield from self._upload_run(ctx, m, [(unit, encoded)],
                                            rows, partition, budget)

    def _coalesced(self, m, units, rows):
        """COALESCING's host half: the units' rows concatenated and packed
        into batches of at least ``rows`` rows, the last one smaller
        (MultiFileParquetPartitionReader:823's stitching). The host time,
        decode included, goes to ``decodeTime``."""
        from spark_rapids_tpu_torch.columnar import wire
        from spark_rapids_tpu_torch.columnar.host import concat_host_batches
        pending: List[HostBatch] = []
        pending_rows = 0
        t0 = time.perf_counter_ns()
        for unit in units:
            faults.fault_point("scan")
            for hb in _read_unit_batches(self.fmt, unit, self.options,
                                         rows, self._columns):
                pending.append(hb)
                pending_rows += hb.num_rows
                if pending_rows >= rows:
                    enc = wire.pack_batch(concat_host_batches(pending))
                    m.add("decodeTime", time.perf_counter_ns() - t0)
                    yield enc
                    pending, pending_rows = [], 0
                    t0 = time.perf_counter_ns()
        if pending:
            enc = wire.pack_batch(concat_host_batches(pending))
            m.add("decodeTime", time.perf_counter_ns() - t0)
            yield enc

    def _device_coalescing(self, ctx, m, units, rows, partition):
        """Fewer, larger uploads of small units' rows, one at a time."""
        for enc in self._coalesced(m, units, rows):
            yield from self._upload_run(ctx, m, [(None, [enc])], rows,
                                        partition, 0)


def make_scan_exec(file_scan, conf, force_perfile: bool = False,
                   device: DeviceLike = None) -> FileScanExec:
    """Planner hook for ``L.FileScan`` nodes."""
    return FileScanExec(file_scan.fmt, file_scan.paths,
                        file_scan.source_schema, file_scan.options,
                        force_perfile=force_perfile,
                        predicates=getattr(file_scan, "predicates", ()),
                        device=device)
