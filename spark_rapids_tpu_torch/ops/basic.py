"""Basic physical operators (port of the JAX package's ``ops/basic.py``:
``ProjectExec``, ``FilterExec``, ``UnionExec``, ``CoalescePartitionsExec``,
``RangeExec``, ``LocalLimitExec``, ``GlobalLimitExec``, ``ExpandExec``),
each with its device half and its numpy host half. A project's or
filter's per-batch device step is an OOM retry site (``memory/oom.py``).
The reference's host closure cache is not ported: the host halves
evaluate their expressions directly on every batch.

A projection or filter holding a task-context expression (``rand``,
``monotonically_increasing_id``, ``spark_partition_id``,
``input_file_name``) runs each batch inside an ``EvalContext`` of its
partition and row base (``_contextual_device_loop`` /
``_contextual_host_loop``). On the device the row base is an int64
tensor on the card advanced by each batch's row count, so a partition
pays no host sync a batch; it counts the batch's row-count prefix, as the
reference's does, and the host half counts rows."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import DeviceLike, resolve_device
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, DeviceColumn, bucket_capacity)
from spark_rapids_tpu_torch.columnar.host import (
    HostBatch, HostColumn, all_valid)
from spark_rapids_tpu_torch.exprs.base import (
    Expression, as_device_column, as_host_column, eval_exprs,
    eval_exprs_host)
from spark_rapids_tpu_torch.exprs.nondeterministic import (
    EvalContext, eval_context, needs_eval_context)
from spark_rapids_tpu_torch.memory.oom import retry_on_oom
from spark_rapids_tpu_torch.ops.base import (
    Exec, LeafExec, Schema, record_batch, timed)


def _contextual_device_loop(op: Exec, kernel, ctx, partition: int):
    """Drive ``kernel(batch)`` over the child's device batches, each inside
    an ``EvalContext`` of this partition and the row base so far."""
    m = ctx.metrics_for(op)
    base = None
    for batch in op.children[0].execute_device(ctx, partition):
        if base is None:
            base = torch.zeros((), dtype=torch.int64, device=batch.device)
        with timed(m), eval_context(EvalContext(partition, base)):
            out = retry_on_oom(kernel, batch)
        base = base + batch.num_rows.to(torch.int64)
        record_batch(m, out)
        yield out


def _contextual_host_loop(op: Exec, kernel, ctx, partition: int):
    base = 0
    for hb in op.children[0].execute_host(ctx, partition):
        with eval_context(EvalContext(partition, base)):
            out = kernel(hb)
        yield out
        base += hb.num_rows


class ProjectExec(Exec):
    """Evaluate named expressions per batch."""

    def __init__(self, child: Exec,
                 projections: Sequence[Tuple[str, Expression]]):
        super().__init__(child)
        self.names = tuple(n for n, _ in projections)
        self.exprs = [e for _, e in projections]

    @property
    def schema(self) -> Schema:
        return tuple((n, e.data_type())
                     for n, e in zip(self.names, self.exprs))

    def _kernel(self, batch: DeviceBatch) -> DeviceBatch:
        out = eval_exprs(self.exprs, batch)
        # Projection preserves row count: keep the host-known hint.
        out.rows_hint = batch.rows_hint
        return out

    def _host_kernel(self, hb: HostBatch) -> HostBatch:
        return eval_exprs_host(self.exprs, hb, self.names)

    def execute_device(self, ctx, partition):
        if needs_eval_context(self.exprs):
            yield from _contextual_device_loop(self, self._kernel, ctx,
                                               partition)
            return
        m = ctx.metrics_for(self)
        for batch in self.children[0].execute_device(ctx, partition):
            with timed(m):
                out = retry_on_oom(self._kernel, batch)
            record_batch(m, out)
            yield out

    def execute_host(self, ctx, partition):
        if needs_eval_context(self.exprs):
            yield from _contextual_host_loop(self, self._host_kernel, ctx,
                                             partition)
            return
        for hb in self.children[0].execute_host(ctx, partition):
            yield self._host_kernel(hb)


class FilterExec(Exec):
    """Row filter via selection vector: the condition mask ANDs into the
    batch's ``sel`` and no rows move; materialization happens at
    concats, shrinks and downloads."""

    def __init__(self, child: Exec, condition: Expression):
        super().__init__(child)
        self.condition = condition

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute_device(self, ctx, partition):
        if needs_eval_context([self.condition]):
            yield from _contextual_device_loop(self, self._device_kernel,
                                               ctx, partition)
            return
        m = ctx.metrics_for(self)
        for batch in self.children[0].execute_device(ctx, partition):
            with timed(m):
                out = retry_on_oom(self._device_kernel, batch)
            record_batch(m, out)
            yield out

    def _device_kernel(self, batch):
        cond = as_device_column(self.condition.eval(batch), batch)
        return batch.with_sel(cond.data & cond.validity)

    def _host_kernel(self, hb: HostBatch) -> HostBatch:
        """Evaluate the condition once and gather every column through
        the matrix-preserving ``HostColumn.take``."""
        cond = as_host_column(self.condition.eval_host(hb), hb)
        return hb.filter(np.asarray(cond.data, np.bool_)
                         & np.asarray(cond.validity, np.bool_))

    def execute_host(self, ctx, partition):
        if needs_eval_context([self.condition]):
            yield from _contextual_host_loop(self, self._host_kernel, ctx,
                                             partition)
            return
        for hb in self.children[0].execute_host(ctx, partition):
            yield self._host_kernel(hb)


class UnionExec(Exec):
    """UNION ALL: the children's partitions one after another (partition
    ``p`` of the union is partition ``p`` of the child it falls in,
    counted from that child's first)."""

    def __init__(self, *children: Exec):
        super().__init__(*children)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def num_partitions(self, ctx) -> int:
        return sum(c.num_partitions(ctx) for c in self.children)

    def _locate(self, ctx, partition: int):
        for c in self.children:
            n = c.num_partitions(ctx)
            if partition < n:
                return c, partition
            partition -= n
        raise IndexError(partition)

    def execute_device(self, ctx, partition):
        child, p = self._locate(ctx, partition)
        yield from child.execute_device(ctx, p)

    def execute_host(self, ctx, partition):
        child, p = self._locate(ctx, partition)
        yield from child.execute_host(ctx, p)


class CoalescePartitionsExec(Exec):
    """Reduce the partition count by concatenating partition streams."""

    def __init__(self, child: Exec, num_partitions: int = 1):
        super().__init__(child)
        self._n = num_partitions

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def num_partitions(self, ctx) -> int:
        return min(self._n, self.children[0].num_partitions(ctx))

    def _sources(self, ctx, partition: int) -> List[int]:
        child_n = self.children[0].num_partitions(ctx)
        mine = self.num_partitions(ctx)
        return [p for p in range(child_n) if p % mine == partition]

    def execute_device(self, ctx, partition):
        for p in self._sources(ctx, partition):
            yield from self.children[0].execute_device(ctx, p)

    def execute_host(self, ctx, partition):
        for p in self._sources(ctx, partition):
            yield from self.children[0].execute_host(ctx, p)


class RangeExec(LeafExec):
    """range(start, end, step) as one INT64 column ``id``, split into
    ``num_partitions`` contiguous row ranges. The device half builds each
    batch on the card with ``torch.arange`` at the capacity bucket of
    ``batch_rows`` (or of the partition's rows, when fewer); the host half
    builds it in numpy."""

    def __init__(self, start: int, end: int, step: int = 1,
                 num_partitions: int = 1, batch_rows: int = 1 << 20,
                 name: str = "id", device: DeviceLike = None):
        super().__init__()
        assert step != 0
        self.start, self.end, self.step = int(start), int(end), int(step)
        self._parts = int(num_partitions)
        self.batch_rows = int(batch_rows)
        self._name = name
        self.device = resolve_device(device)

    @property
    def schema(self) -> Schema:
        return ((self._name, dt.INT64),)

    def num_partitions(self, ctx) -> int:
        return self._parts

    def _bounds(self, partition: int) -> Tuple[int, int]:
        total = max(0, -(-(self.end - self.start) // self.step))
        per = -(-total // self._parts)
        lo = min(per * partition, total)
        return lo, min(lo + per, total)

    def execute_device(self, ctx, partition):
        m = ctx.metrics_for(self)
        lo, hi = self._bounds(partition)
        cap = bucket_capacity(min(self.batch_rows, max(hi - lo, 1)))
        idx = lo
        while idx < hi:
            n = min(cap, hi - idx)
            with timed(m):
                pos = torch.arange(cap, dtype=torch.int64,
                                   device=self.device)
                valid = pos < n
                data = torch.where(
                    valid, pos * self.step + (self.start + idx * self.step),
                    torch.zeros((), dtype=torch.int64, device=self.device))
                out = DeviceBatch(
                    (DeviceColumn(dt.INT64, data, valid),),
                    torch.tensor(n, dtype=torch.int32, device=self.device),
                    rows_hint=n)
            record_batch(m, out)
            yield out
            idx += n

    def execute_host(self, ctx, partition):
        lo, hi = self._bounds(partition)
        idx = lo
        while idx < hi:
            n = min(self.batch_rows, hi - idx)
            data = self.start + idx * self.step + \
                np.arange(n, dtype=np.int64) * self.step
            yield HostBatch((self._name,),
                            [HostColumn(dt.INT64, data, all_valid(n))])
            idx += n


class LocalLimitExec(Exec):
    """Per-partition head(n): the first ``limit`` live rows, by selection
    vector."""

    def __init__(self, child: Exec, limit: int):
        super().__init__(child)
        self.limit = int(limit)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute_device(self, ctx, partition):
        remaining = self.limit
        for batch in self.children[0].execute_device(ctx, partition):
            if remaining <= 0:
                break
            out = batch.head(remaining)
            # A host-known live count spares the device row-count pull.
            if batch.rows_hint is not None:
                taken = min(batch.rows_hint, remaining)
                out.rows_hint = taken
            else:
                taken = int(out.live_count())
            remaining -= taken
            yield out

    def execute_host(self, ctx, partition):
        remaining = self.limit
        for hb in self.children[0].execute_host(ctx, partition):
            if remaining <= 0:
                break
            n = min(remaining, hb.num_rows)
            cols = [HostColumn(c.dtype, c.data[:n], c.validity[:n])
                    for c in hb.columns]
            remaining -= n
            yield HostBatch(hb.names, cols)


class GlobalLimitExec(Exec):
    """Global limit over a single-partition child."""

    def __init__(self, child: Exec, limit: int):
        super().__init__(child)
        self.limit = int(limit)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute_device(self, ctx, partition):
        inner = LocalLimitExec(self.children[0], self.limit)
        yield from inner.execute_device(ctx, partition)

    def execute_host(self, ctx, partition):
        inner = LocalLimitExec(self.children[0], self.limit)
        yield from inner.execute_host(ctx, partition)


class ExpandExec(Exec):
    """GROUPING SETS expansion (GpuExpandExec.scala): each input batch is
    emitted once per projection list. An aggregated-out key is a typed
    NULL ``Literal``, which broadcasts to an all-NULL column (strings
    included)."""

    def __init__(self, child: Exec,
                 projections: Sequence[Sequence[Expression]],
                 names: Sequence[str]):
        super().__init__(child)
        self.projections = [list(p) for p in projections]
        self.names = tuple(names)

    @property
    def schema(self) -> Schema:
        return tuple((n, e.data_type())
                     for n, e in zip(self.names, self.projections[0]))

    def execute_device(self, ctx, partition):
        m = ctx.metrics_for(self)
        for batch in self.children[0].execute_device(ctx, partition):
            for proj in self.projections:
                with timed(m):
                    out = eval_exprs(proj, batch)
                out.rows_hint = batch.rows_hint
                record_batch(m, out)
                yield out

    def execute_host(self, ctx, partition):
        for hb in self.children[0].execute_host(ctx, partition):
            for proj in self.projections:
                yield eval_exprs_host(proj, hb, self.names)
