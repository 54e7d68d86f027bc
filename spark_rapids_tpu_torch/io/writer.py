"""Columnar writers: parquet / ORC / CSV output (port of the JAX package's
``io/writer.py``; ref GpuParquetFileFormat.scala, ColumnarOutputWriter.scala,
GpuFileFormatWriter.scala's per-partition files).

Each engine partition writes one ``part-NNNNN-<job>.<fmt>`` file inside
the output directory (Spark's directory of parts), through pyarrow's
chunked writers, one write a batch. ``partition_by`` switches to dynamic
partitioning: the rows split by their partition-column values into
Hive-escaped ``col=value/`` directories (null as
``__HIVE_DEFAULT_PARTITION__``), the partition columns dropped from the
files, one open writer per directory a partition. A partition with no
rows still writes a schema-only parquet file.

The plan runs on its engines as ``collect`` runs it; a device root's
batches are downloaded one by one with ``device_to_host`` on the calling
thread. When the format's write gate
(``spark.rapids.sql.format.{parquet,orc}.write.enabled``) is off, the
whole job runs on the host engine (the reference's CPU FileFormatWriter
fallback).

Every write records ``last_stats`` (BasicColumnarWriteStatsTracker.scala:
180 analog): numFiles, numOutputRows, numOutputBytes, numParts (dynamic
partition directories).

pyarrow and pandas are imported inside the functions that write.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
from spark_rapids_tpu_torch.io.arrow_convert import host_batch_to_arrow

# Characters Hive escapes in partition paths (ExternalCatalogUtils
# escapePathName): anything that could change the directory structure.
_ESCAPE = set('"#%\'*/:=?\\\x7f{[]^') | {chr(c) for c in range(0x20)}


def _part_value(v) -> str:
    """Hive-style partition directory value, escaped for a path."""
    if v is None:
        return "__HIVE_DEFAULT_PARTITION__"
    if isinstance(v, bytes):
        v = v.decode("utf-8", errors="replace")
    elif isinstance(v, float):
        import math
        if math.isfinite(v) and v == int(v):
            v = int(v)
    s = str(v)
    return "".join(f"%{ord(ch):02X}" if ch in _ESCAPE else ch
                   for ch in s)


def _take_rows(hb: HostBatch, idx: np.ndarray,
               keep_cols: List[int]) -> HostBatch:
    cols = []
    names = []
    for ci in keep_cols:
        c = hb.columns[ci]
        if c.dtype.is_string and c.str_matrix is not None:
            # Slice the dense byte matrix; never build the object array.
            cols.append(HostColumn(c.dtype, None, c.validity[idx],
                                   str_matrix=c.str_matrix[idx],
                                   str_lengths=c.str_lengths[idx]))
        else:
            cols.append(HostColumn(c.dtype, c.data[idx], c.validity[idx]))
        names.append(hb.names[ci])
    return HostBatch(tuple(names), cols)


class _Stats:
    def __init__(self):
        self.values = {"numFiles": 0, "numOutputRows": 0,
                       "numOutputBytes": 0, "numParts": 0}

    def file_closed(self, path: str):
        self.values["numFiles"] += 1
        try:
            self.values["numOutputBytes"] += os.path.getsize(path)
        except OSError:
            pass


class DataFrameWriter:
    """``df.write``: ``option``, ``mode`` (error / overwrite / append /
    ignore-like: any other mode writes into an existing directory),
    ``partition_by`` and ``parquet`` / ``orc`` / ``csv``."""

    def __init__(self, df):
        self._df = df
        self._options: Dict = {}
        self._mode = "error"
        self._partition_by: List[str] = []
        self.last_stats: Optional[Dict] = None

    def option(self, key: str, value) -> "DataFrameWriter":
        self._options[key] = value
        return self

    def mode(self, m: str) -> "DataFrameWriter":
        self._mode = m
        return self

    def partition_by(self, *cols: str) -> "DataFrameWriter":
        self._partition_by = list(cols)
        return self

    partitionBy = partition_by

    def _prepare_dir(self, path: str):
        if os.path.exists(path):
            if self._mode == "overwrite":
                import shutil
                shutil.rmtree(path)
            elif self._mode == "error":
                raise FileExistsError(path)
        os.makedirs(path, exist_ok=True)

    @staticmethod
    def _open(fmt: str, out: str, table):
        if fmt == "parquet":
            import pyarrow.parquet as papq
            return papq.ParquetWriter(out, table.schema)
        if fmt == "orc":
            import pyarrow.orc as paorc
            return paorc.ORCWriter(out)
        import pyarrow.csv as pacsv
        return pacsv.CSVWriter(out, table.schema)

    @staticmethod
    def _append(fmt: str, writer, table):
        if fmt == "parquet":
            writer.write_table(table)
        else:
            writer.write(table)

    def _batches(self, phys, ctx, p: int, names):
        """Partition ``p``'s output as host batches; a device root's
        batches download one at a time."""
        from spark_rapids_tpu_torch.columnar.host import device_to_host
        if not phys.root_on_device:
            yield from phys.root.execute_host(ctx, p)
            return
        for b in phys.root.execute_device_recovering(ctx, p):
            yield device_to_host(b, names)

    def _write(self, path: str, fmt: str):
        from spark_rapids_tpu_torch import config as C
        from spark_rapids_tpu_torch.columnar import wire
        from spark_rapids_tpu_torch.memory import oom
        from spark_rapids_tpu_torch.ops import native
        from spark_rapids_tpu_torch.ops.base import (
            ExecContext, query_metrics_entry)
        self._prepare_dir(path)
        conf = self._df._session.conf
        write_gate = {"parquet": C.ENABLE_PARQUET_WRITE,
                      "orc": C.ENABLE_ORC_WRITE}.get(fmt)
        if write_gate is not None and not bool(conf.get(write_gate)):
            # Write gate off: the job runs on the host engine.
            phys = self._df._host_physical()
        else:
            phys = self._df._physical()
        ctx = ExecContext(phys.conf)
        ctx.cache["engine"] = "device" if phys.root_on_device else "host"
        install = getattr(phys, "install", None)
        if install is not None:
            # A plan-cache bound plan: this job's literal bindings.
            install(ctx)
        wire.maybe_configure(ctx.conf)
        native.maybe_configure(ctx.conf)
        oom.reset_degradation()
        oom.set_active_catalog(ctx.catalog,
                               query_metrics_entry(ctx, "Recovery"))
        try:
            return self._write_parts(path, fmt, phys, ctx)
        finally:
            oom.set_active_catalog(None)
            ctx.close()

    def _write_parts(self, path: str, fmt: str, phys, ctx):
        import uuid
        root = phys.root
        names = tuple(n for n, _ in root.schema)
        stats = _Stats()
        n_parts = root.num_partitions(ctx)
        # A job id in the file names, so append mode never clobbers an
        # earlier write's parts (Spark's write-uuid naming).
        job = uuid.uuid4().hex[:8]
        part_ords = []
        for k in self._partition_by:
            if k not in names:
                raise ValueError(f"unknown partitionBy column {k!r}")
            part_ords.append(names.index(k))
        data_ords = [i for i in range(len(names)) if i not in part_ords]
        part_dirs = set()
        for p in range(n_parts):
            out = os.path.join(path, f"part-{p:05d}-{job}.{fmt}")
            writers: Dict = {}      # key -> (writer, path); None = plain
            wrote = False
            for hb in self._batches(phys, ctx, p, names):
                if hb.num_rows == 0 and wrote:
                    continue
                if not self._partition_by:
                    table = host_batch_to_arrow(hb)
                    if None not in writers:
                        writers[None] = (self._open(fmt, out, table), out)
                    self._append(fmt, writers[None][0], table)
                    stats.values["numOutputRows"] += hb.num_rows
                    wrote = True
                    continue
                for k, rows in _partition_groups(hb, part_ords):
                    sub = _take_rows(hb, rows, data_ords)
                    table = host_batch_to_arrow(sub)
                    if k not in writers:
                        sub_dir = os.path.join(path, *[
                            f"{name}={_part_value(v)}"
                            for name, v in zip(self._partition_by, k)])
                        os.makedirs(sub_dir, exist_ok=True)
                        part_dirs.add(sub_dir)
                        f = os.path.join(sub_dir,
                                         f"part-{p:05d}-{job}.{fmt}")
                        writers[k] = (self._open(fmt, f, table), f)
                    self._append(fmt, writers[k][0], table)
                    stats.values["numOutputRows"] += sub.num_rows
                wrote = True
            for w, fpath in writers.values():
                w.close()
                stats.file_closed(fpath)
            if not writers and not wrote and not self._partition_by \
                    and fmt == "parquet":
                # An empty partition still writes a schema-only file.
                import pyarrow.parquet as papq
                empty = host_batch_to_arrow(_empty_host_batch(root.schema))
                papq.write_table(empty, out)
                stats.file_closed(out)
        stats.values["numParts"] = len(part_dirs)
        self.last_stats = dict(stats.values)
        return self.last_stats

    def parquet(self, path: str):
        return self._write(path, "parquet")

    def orc(self, path: str):
        return self._write(path, "orc")

    def csv(self, path: str):
        return self._write(path, "csv")


def _partition_groups(hb: HostBatch, part_ords: List[int]):
    """[(key tuple, row indices)] of one batch's dynamic partitions, in
    the order of their escaped directory names: a vectorized factorize
    a key column (nulls code -1), one group id a row."""
    import pandas as pd
    code_cols = []
    uniq_cols = []
    for o in part_ords:
        c = hb.columns[o]
        codes, uniques = pd.factorize(c.data, sort=False)
        codes = np.asarray(codes).copy()
        codes[~np.asarray(c.validity, np.bool_)] = -1
        code_cols.append(codes)
        uniq_cols.append(list(uniques))
    gid = np.zeros(hb.num_rows, np.int64)
    for codes, uniques in zip(code_cols, uniq_cols):
        gid = gid * (len(uniques) + 1) + (codes + 1)
    order = np.argsort(gid, kind="stable")
    bounds = np.flatnonzero(np.diff(gid[order])) + 1
    groups = np.split(order, bounds)

    def key_of(row_i):
        return tuple(None if codes[row_i] < 0 else uniques[codes[row_i]]
                     for codes, uniques in zip(code_cols, uniq_cols))

    return sorted(((key_of(int(rows[0])), np.asarray(rows, np.int64))
                   for rows in groups if len(rows)),
                  key=lambda kv: tuple(map(_part_value, kv[0])))


def _empty_host_batch(schema) -> HostBatch:
    return HostBatch(tuple(n for n, _ in schema),
                     [HostColumn.from_values(t, []) for _, t in schema])
