"""Basic physical operators (port of the JAX package's ``ops/basic.py``:
``ProjectExec``, ``FilterExec``, ``UnionExec``, ``CoalescePartitionsExec``,
``RangeExec``, ``LocalLimitExec``, ``GlobalLimitExec``, ``ExpandExec``),
each with its device half and its numpy host half. A project's or
filter's per-batch device step is an OOM retry site (``memory/oom.py``)
with the ``kernel`` fault site (``kernel_cache.call``).

Plan-cache bind slots (``exprs/bindslots.py``) reach a project's or
filter's steps through the context: the device step reads this
execution's binding vector as 0-d tensors (``device_bind_args``), the
host half as python values, and the limits resolve a ``BindValue`` budget
per execution (``resolve_bound``). The JAX package takes those steps from
its kernel and host closure caches; the port builds them where they run,
as an eager closure costs nothing to build (``ops/kernel_cache.py``).

A projection or filter holding a task-context expression (``rand``,
``monotonically_increasing_id``, ``spark_partition_id``,
``input_file_name``) runs each batch inside an ``EvalContext`` of its
partition, row base and input file (``_contextual_device_loop`` /
``_contextual_host_loop``; the file is the one the unique file scan
below published, ``_input_file_key``). On the device the row base is an
int64 tensor on the card advanced by each batch's row count, so a
partition pays no host sync a batch; it counts the batch's row-count
prefix, as the reference's does, and the host half counts rows."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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
from spark_rapids_tpu_torch.exprs.bindslots import (
    BindValue, bound_literals, device_bind_args, has_bind_slots,
    host_bind_args, resolve_bound)
from spark_rapids_tpu_torch.exprs.nondeterministic import (
    EvalContext, eval_context, needs_eval_context)
from spark_rapids_tpu_torch.ops import kernel_cache as kc
from spark_rapids_tpu_torch.ops.base import (
    Exec, LeafExec, Schema, record_batch, timed)


def _project_step(exprs):
    """A projection's per-batch device step, ``step(batch, binds) ->
    batch`` with the bound literals in scope; the row count is unchanged,
    so the host-known hint carries over."""
    def step(b: DeviceBatch, binds=()) -> DeviceBatch:
        with bound_literals(binds):
            out = eval_exprs(exprs, b)
        out.rows_hint = b.rows_hint
        return out
    return step


def _filter_step(condition):
    """A filter's per-batch device step: the condition ANDs into the
    selection vector."""
    def step(b: DeviceBatch, binds=()) -> DeviceBatch:
        with bound_literals(binds):
            cond = as_device_column(condition.eval(b), b)
        return b.with_sel(cond.data & cond.validity)
    return step


def _project_host_closure(exprs, names):
    """A projection's host closure: one numpy pass per batch, the bound
    literals riding as an argument."""
    def closure(hb: HostBatch, binds) -> HostBatch:
        with bound_literals(binds or ()):
            return eval_exprs_host(exprs, hb, names)
    return closure


def _filter_host_closure(condition):
    """A filter's host closure: evaluate the condition once and gather
    every column through the matrix-preserving ``HostColumn.take``."""
    def closure(hb: HostBatch, binds) -> HostBatch:
        with bound_literals(binds or ()):
            cond = as_host_column(condition.eval_host(hb), hb)
        return hb.filter(np.asarray(cond.data, np.bool_)
                         & np.asarray(cond.validity, np.bool_))
    return closure


def _device_loop(op: Exec, step, exprs, ctx, partition):
    """Drive ``step(batch, binds)`` over the child's device batches, each
    call an OOM retry site."""
    m = ctx.metrics_for(op)
    binds = None
    for batch in op.children[0].execute_device(ctx, partition):
        if binds is None:
            binds = device_bind_args(ctx, batch.device) \
                if has_bind_slots(exprs) else ()
        with timed(m):
            out = kc.call(step, batch, binds)
        record_batch(m, out)
        yield out


def _input_file_key(op: Exec, partition: int, host: bool = False
                    ) -> Optional[str]:
    """The cache key under which this operator's unique descendant file
    scan publishes the current file's path (scans scope their keys by
    instance, so two scans of one partition never clobber each other).
    With no scan below, or two, there is no current input file and
    input_file_name() gives "" (GpuInputFileBlock.scala)."""
    scans = []

    def walk(node):
        if type(node).__name__ == "FileScanExec":
            scans.append(node)
            return
        # An exchange breaks the batch <-> file association: a
        # post-shuffle batch mixes every map partition's files, so
        # input_file_name() above one is "" (Spark's behavior).
        if "Exchange" in type(node).__name__:
            return
        for ch in getattr(node, "children", ()):
            walk(ch)

    walk(op)
    if len(scans) != 1:
        return None
    prefix = "input_file_host" if host else "input_file"
    return f"{prefix}:{id(scans[0])}:{partition}"


def _contextual_device_loop(op: Exec, exprs, step, ctx, partition: int):
    """Drive ``step(batch, binds)`` over the child's device batches, each
    inside an ``EvalContext`` of this partition, the row base so far and
    the file the batch was scanned from (read after the scan yields it),
    each call an OOM retry site."""
    m = ctx.metrics_for(op)
    base = binds = None
    key = _input_file_key(op, partition)
    for batch in op.children[0].execute_device(ctx, partition):
        if base is None:
            base = torch.zeros((), dtype=torch.int64, device=batch.device)
            binds = device_bind_args(ctx, batch.device) \
                if has_bind_slots(exprs) else ()
        ec = EvalContext(partition, base,
                         ctx.cache.get(key) if key else None)
        with timed(m), eval_context(ec):
            out = kc.call(step, batch, binds)
        base = base + batch.num_rows.to(torch.int64)
        record_batch(m, out)
        yield out


def _contextual_host_loop(op: Exec, kernel, ctx, partition: int, exprs=()):
    base = 0
    key = _input_file_key(op, partition, host=True)
    binds = host_bind_args(ctx) if has_bind_slots(exprs) else ()
    for hb in op.children[0].execute_host(ctx, partition):
        ec = EvalContext(partition, base,
                         ctx.cache.get(key) if key else None)
        with eval_context(ec), bound_literals(binds):
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

    def _host_kernel(self, hb: HostBatch) -> HostBatch:
        return eval_exprs_host(self.exprs, hb, self.names)

    def execute_device(self, ctx, partition):
        exprs = list(self.exprs)
        step = _project_step(exprs)
        if needs_eval_context(exprs):
            yield from _contextual_device_loop(self, exprs, step, ctx,
                                               partition)
            return
        yield from _device_loop(self, step, exprs, ctx, partition)

    def execute_host(self, ctx, partition):
        if needs_eval_context(self.exprs):
            yield from _contextual_host_loop(self, self._host_kernel, ctx,
                                             partition, self.exprs)
            return
        binds = host_bind_args(ctx) if has_bind_slots(self.exprs) else None
        fn = _project_host_closure(list(self.exprs), tuple(self.names))
        for hb in self.children[0].execute_host(ctx, partition):
            yield fn(hb, binds)


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
        exprs = [self.condition]
        step = _filter_step(self.condition)
        if needs_eval_context(exprs):
            yield from _contextual_device_loop(self, exprs, step, ctx,
                                               partition)
            return
        yield from _device_loop(self, step, exprs, ctx, partition)

    def _host_kernel(self, hb: HostBatch) -> HostBatch:
        return _filter_host_closure(self.condition)(hb, None)

    def execute_host(self, ctx, partition):
        exprs = [self.condition]
        if needs_eval_context(exprs):
            yield from _contextual_host_loop(self, self._host_kernel, ctx,
                                             partition, exprs)
            return
        binds = host_bind_args(ctx) if has_bind_slots(exprs) else None
        fn = _filter_host_closure(self.condition)
        for hb in self.children[0].execute_host(ctx, partition):
            yield fn(hb, binds)


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

    def prefetch_host(self, ctx, partition):
        # The union concatenates its children's partition spaces, so the
        # prefetch translates the partition before descending. A child
        # holding an exchange is skipped whole: _locate's num_partitions
        # could otherwise materialize it (AQE sizing) on a prefetch
        # thread.
        from spark_rapids_tpu_torch.parallel.stages import \
            is_stage_boundary

        def boundary_free(op):
            return not is_stage_boundary(op) and \
                all(boundary_free(c) for c in op.children)

        if not all(boundary_free(c) for c in self.children):
            return
        child, p = self._locate(ctx, partition)
        child.prefetch_host(ctx, p)


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
    vector. ``limit`` is an int or a plan-cache ``BindValue`` slot,
    resolved per execution."""

    def __init__(self, child: Exec, limit):
        super().__init__(child)
        self.limit = limit if isinstance(limit, BindValue) else int(limit)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute_device(self, ctx, partition):
        remaining = int(resolve_bound(self.limit, ctx))
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
        remaining = int(resolve_bound(self.limit, ctx))
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

    def __init__(self, child: Exec, limit):
        super().__init__(child)
        self.limit = limit if isinstance(limit, BindValue) else int(limit)

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
