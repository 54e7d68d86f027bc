"""Pandas-UDF operator family — host islands inside device plans (port of
the JAX package's ``ops/pandas_exec.py``; ref: GpuArrowEvalPythonExec.scala
:494 and its grouped flavors GpuFlatMapGroupsInPandasExec,
GpuCoGroupedMapInPandasExec, GpuMapInPandasExec, GpuAggregateInPandasExec,
plus the bounded PythonWorkerSemaphore and python/rapids/worker.py:22-67
daemon pool).

The engine and the UDFs share one interpreter, so the "worker" is a
bounded thread pool (at most ``spark.rapids.python.concurrentPythonWorkers``
group functions in flight) and the Arrow hop is a direct HostBatch <->
pandas conversion. Each exec's device half downloads the child's device
batches, runs the user's pandas function on the host and uploads the
results onto the plan's device (never a default one, never the CPU in
its stead). User functions run in the pool's threads; no torch op runs
there, and the upload happens on the calling thread.

The grouped flavors' device halves rely on the planner's co-partitioning
exchange on the keys; their host halves read every child partition and
emit from partition 0 only, as the reference's.

pandas is imported inside the functions that need it: the port imports
without it, and these execs run only where it is installed.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.host import (
    HostBatch, HostColumn, download_batches, host_to_device)
from spark_rapids_tpu_torch.ops.base import (
    Exec, ExecContext, Schema, record_batch, timed)

_POOLS: dict = {}


def worker_pool(ctx: ExecContext) -> ThreadPoolExecutor:
    """Bounded pandas-UDF pool (PythonWorkerSemaphore.scala analog): one
    per pool size, kept for the process."""
    from spark_rapids_tpu_torch import config as C
    n = max(int(ctx.conf.get(C.CONCURRENT_PYTHON_WORKERS)), 1)
    pool = _POOLS.get(n)
    if pool is None:
        pool = ThreadPoolExecutor(max_workers=n,
                                  thread_name_prefix="pandas-udf")
        _POOLS[n] = pool
    return pool


# ---------------------------------------------------------------------------
# HostBatch <-> pandas
# ---------------------------------------------------------------------------

def batches_to_pandas(hbs: Sequence[HostBatch], names: Sequence[str]):
    """Concatenate host batches into one pandas DataFrame. Strings decode
    to str; nulls become None (object) or NaN (float); dates stay as
    days-since-epoch ints (the engine's physical value); an integer
    column with nulls becomes an object Series."""
    import pandas as pd
    cols = {}
    for ci, name in enumerate(names):
        parts = []
        for hb in hbs:
            c = hb.columns[ci]
            if c.dtype.is_string:
                vals = [
                    (v.decode("utf-8") if isinstance(v, bytes) else v)
                    if ok else None
                    for v, ok in zip(c.data, c.validity)]
                parts.append(pd.Series(vals, dtype=object))
            elif c.validity.all():
                parts.append(pd.Series(np.asarray(c.data)))
            elif c.dtype.is_floating:
                parts.append(pd.Series(
                    np.where(c.validity, c.data, np.nan)))
            else:
                vals = [v if ok else None
                        for v, ok in zip(c.data.tolist(), c.validity)]
                parts.append(pd.Series(vals, dtype=object))
        cols[name] = pd.concat(parts, ignore_index=True) if parts \
            else pd.Series([], dtype=object)
    return pd.DataFrame(cols)


def pandas_to_batch(pdf, schema: Schema) -> HostBatch:
    """User-returned DataFrame -> HostBatch, by declared output schema
    (column NAME lookup, Spark's apply_in_pandas contract). A NaN in a
    non-float column (pandas' missing value, the ``str`` dtype's too) is
    a NULL."""
    names = tuple(n for n, _ in schema)
    cols = []
    for name, t in schema:
        if name not in pdf.columns:
            raise ValueError(
                f"pandas UDF output is missing declared column {name!r} "
                f"(has {list(pdf.columns)})")
        s = pdf[name]
        vals = []
        for v in s.tolist():
            if v is None or (isinstance(v, float) and np.isnan(v)
                             and not t.is_floating):
                vals.append(None)
            else:
                vals.append(v)
        cols.append(HostColumn.from_values(t, vals))
    return HostBatch(names, cols)


def _normalize_key(key: tuple) -> tuple:
    """Group-key tuple with every null encoding (None, float NaN)
    collapsed to None. pandas hands back ``nan`` for null keys under
    ``dropna=False``, and two NaN objects from two separate groupbys are
    neither ``==`` nor same-hash — so cogrouping by raw keys would pair
    each side's null group with an EMPTY other side. Normalizing to None
    makes null keys from both sides collide into one cogrouped call
    (Spark's null-key grouping semantics)."""
    return tuple(None if v is None
                 or (isinstance(v, float) and v != v) else v
                 for v in key)


def _group_frames(pdf, key_names: Sequence[str]):
    """(key_tuple, group pdf) in sorted key order; NaN/None keys group
    together (dropna=False, Spark groups null keys)."""
    if not len(pdf):
        return []
    grouped = pdf.groupby(list(key_names), sort=True, dropna=False)
    return [(k if isinstance(k, tuple) else (k,),
             g.reset_index(drop=True)) for k, g in grouped]


def _concat_to_batch(outs: list, schema: Schema) -> HostBatch:
    import pandas as pd
    return pandas_to_batch(pd.concat(outs, ignore_index=True)
                           if len(outs) > 1 else outs[0], schema)


# ---------------------------------------------------------------------------
# Execs
# ---------------------------------------------------------------------------

class _PandasIslandExec(Exec):
    """Shared download -> pandas -> upload plumbing."""

    out_schema: Schema

    @property
    def schema(self) -> Schema:
        return self.out_schema

    def _child_pdf(self, ctx, partition, child_idx: int = 0):
        """One child partition's device batches, downloaded in one
        batched pass, as one frame."""
        child = self.children[child_idx]
        names = tuple(n for n, _ in child.schema)
        hbs = download_batches(list(child.execute_device(ctx, partition)),
                               names)
        return batches_to_pandas(hbs, names)

    def _child_pdf_host_all(self, ctx, child_idx: int = 0):
        """ALL child partitions as one frame: the host engine has no
        co-partitioning exchange, so grouped flavors gather everything
        and emit from partition 0 only."""
        child = self.children[child_idx]
        names = tuple(n for n, _ in child.schema)
        hbs = []
        for p in range(child.num_partitions(ctx)):
            hbs.extend(child.execute_host(ctx, p))
        return batches_to_pandas(hbs, names)

    def _upload(self, hb: HostBatch):
        """``hb`` onto the device the plan's sources upload to."""
        device = self.plan_device()
        if device is None:
            raise RuntimeError(f"{self.name}: the plan names no device "
                               "to upload the pandas results to")
        return host_to_device(hb, device=device)

    def _device_result(self, ctx, compute):
        """The device half of a grouped flavor: ``compute()`` (a host
        batch or None) timed, then uploaded when it has rows."""
        m = ctx.metrics_for(self)
        with timed(m):
            hb = compute()
        if hb is not None and hb.num_rows:
            record_batch(m, hb)
            yield self._upload(hb)


class MapInPandasExec(_PandasIslandExec):
    """df.map_in_pandas(fn, schema): fn(iterator of pandas DataFrames) ->
    iterator of DataFrames (GpuMapInPandasExec analog). Streams one
    input frame per child batch."""

    def __init__(self, child: Exec, fn: Callable, out_schema: Schema):
        super().__init__(child)
        self.fn = fn
        self.out_schema = tuple(out_schema)

    def _run(self, frames):
        for out_pdf in self.fn(iter(frames)):
            yield pandas_to_batch(out_pdf, self.out_schema)

    def execute_device(self, ctx, partition):
        m = ctx.metrics_for(self)
        child = self.children[0]
        names = tuple(n for n, _ in child.schema)

        def frames():
            for b in child.execute_device(ctx, partition):
                yield batches_to_pandas(download_batches([b], names), names)

        with timed(m):
            for hb in self._run(frames()):
                record_batch(m, hb)
                yield self._upload(hb)

    def execute_host(self, ctx, partition):
        child = self.children[0]
        names = tuple(n for n, _ in child.schema)
        frames = (batches_to_pandas([hb], names)
                  for hb in child.execute_host(ctx, partition))
        yield from self._run(frames)


class FlatMapGroupsInPandasExec(_PandasIslandExec):
    """group_by(keys).apply_in_pandas(fn, schema): fn(group pdf) -> pdf
    (GpuFlatMapGroupsInPandasExec analog). The planner co-partitions the
    child by the grouping keys, so each partition owns whole groups; the
    bounded worker pool evaluates groups concurrently."""

    def __init__(self, child: Exec, key_names: Sequence[str],
                 fn: Callable, out_schema: Schema):
        super().__init__(child)
        self.key_names = list(key_names)
        self.fn = fn
        self.out_schema = tuple(out_schema)

    def _apply(self, ctx, pdf) -> Optional[HostBatch]:
        groups = _group_frames(pdf, self.key_names)
        if not groups:
            return None
        outs = list(worker_pool(ctx).map(self.fn, [g for _, g in groups]))
        return _concat_to_batch(outs, self.out_schema)

    def execute_device(self, ctx, partition):
        yield from self._device_result(
            ctx, lambda: self._apply(ctx, self._child_pdf(ctx, partition)))

    def execute_host(self, ctx, partition):
        if partition != 0:
            return
        hb = self._apply(ctx, self._child_pdf_host_all(ctx))
        if hb is not None and hb.num_rows:
            yield hb


class CoGroupedMapInPandasExec(_PandasIslandExec):
    """cogroup(l.group_by(a), r.group_by(b)).apply_in_pandas(fn, schema):
    fn(left group pdf, right group pdf) per key in the UNION of both
    sides' keys, absent side = empty frame (GpuCoGroupedMapInPandas
    analog; both children co-partitioned by key)."""

    def __init__(self, left: Exec, right: Exec,
                 left_keys: Sequence[str], right_keys: Sequence[str],
                 fn: Callable, out_schema: Schema):
        super().__init__(left, right)
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.fn = fn
        self.out_schema = tuple(out_schema)

    def num_partitions(self, ctx) -> int:
        return self.children[0].num_partitions(ctx)

    def _apply(self, ctx, lpdf, rpdf) -> Optional[HostBatch]:
        lg = {_normalize_key(k): g
              for k, g in _group_frames(lpdf, self.left_keys)}
        rg = {_normalize_key(k): g
              for k, g in _group_frames(rpdf, self.right_keys)}
        keys = sorted(set(lg) | set(rg),
                      key=lambda k: tuple(
                          (v is None, 0 if v is None else v)
                          for v in k))
        if not keys:
            return None
        lempty = lpdf.iloc[0:0]
        rempty = rpdf.iloc[0:0]
        outs = list(worker_pool(ctx).map(
            lambda k: self.fn(lg.get(k, lempty), rg.get(k, rempty)),
            keys))
        return _concat_to_batch(outs, self.out_schema)

    def execute_device(self, ctx, partition):
        yield from self._device_result(ctx, lambda: self._apply(
            ctx, self._child_pdf(ctx, partition, 0),
            self._child_pdf(ctx, partition, 1)))

    def execute_host(self, ctx, partition):
        if partition != 0:
            return
        hb = self._apply(ctx, self._child_pdf_host_all(ctx, 0),
                         self._child_pdf_host_all(ctx, 1))
        if hb is not None and hb.num_rows:
            yield hb


class AggregateInPandasExec(_PandasIslandExec):
    """group_by(keys).agg_in_pandas(out=(col, series_fn, dtype), ...):
    each output is series_fn(group's column as a pandas Series) -> scalar
    (GpuAggregateInPandasExec analog: pandas_udf GROUPED_AGG)."""

    def __init__(self, child: Exec, key_names: Sequence[str],
                 aggs: Sequence[Tuple[str, str, Callable, dt.DataType]]):
        super().__init__(child)
        self.key_names = list(key_names)
        self.aggs = list(aggs)
        key_types = dict(child.schema)
        self.out_schema = tuple(
            [(k, key_types[k]) for k in self.key_names]
            + [(name, t) for name, _, _, t in self.aggs])

    def _apply(self, ctx, pdf) -> Optional[HostBatch]:
        groups = _group_frames(pdf, self.key_names)
        if not groups:
            return None

        def one(item):
            key, g = item
            row = list(key)
            for _, colname, fn, _t in self.aggs:
                row.append(fn(g[colname]))
            return tuple(row)

        rows = list(worker_pool(ctx).map(one, groups))
        names = tuple(n for n, _ in self.out_schema)
        cols = []
        for ci, (_, t) in enumerate(self.out_schema):
            vals = []
            for r in rows:
                v = r[ci]
                if v is not None and isinstance(v, float) \
                        and np.isnan(v) and not t.is_floating:
                    v = None
                vals.append(v)
            cols.append(HostColumn.from_values(t, vals))
        return HostBatch(names, cols)

    def execute_device(self, ctx, partition):
        yield from self._device_result(
            ctx, lambda: self._apply(ctx, self._child_pdf(ctx, partition)))

    def execute_host(self, ctx, partition):
        if partition != 0:
            return
        hb = self._apply(ctx, self._child_pdf_host_all(ctx))
        if hb is not None and hb.num_rows:
            yield hb
