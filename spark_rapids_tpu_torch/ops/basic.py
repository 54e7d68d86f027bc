"""Basic physical operators (port of the JAX package's ``ops/basic.py``:
``ProjectExec``, ``FilterExec``, ``CoalescePartitionsExec``,
``LocalLimitExec``, ``GlobalLimitExec``, ``ExpandExec``), each with its
device half and its numpy host half. The reference's host closure cache
is not ported: the host halves evaluate their expressions directly on
every batch."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
from spark_rapids_tpu_torch.exprs.base import (
    Expression, as_device_column, as_host_column, eval_exprs,
    eval_exprs_host)
from spark_rapids_tpu_torch.ops.base import Exec, Schema, record_batch, timed


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

    def execute_device(self, ctx, partition):
        m = ctx.metrics_for(self)
        for batch in self.children[0].execute_device(ctx, partition):
            with timed(m):
                out = eval_exprs(self.exprs, batch)
            # Projection preserves row count: keep the host-known hint.
            out.rows_hint = batch.rows_hint
            record_batch(m, out)
            yield out

    def execute_host(self, ctx, partition):
        for hb in self.children[0].execute_host(ctx, partition):
            yield eval_exprs_host(self.exprs, hb, self.names)


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
        m = ctx.metrics_for(self)
        for batch in self.children[0].execute_device(ctx, partition):
            with timed(m):
                cond = as_device_column(self.condition.eval(batch), batch)
                out = batch.with_sel(cond.data & cond.validity)
            record_batch(m, out)
            yield out

    def _host_kernel(self, hb: HostBatch) -> HostBatch:
        """Evaluate the condition once and gather every column through
        the matrix-preserving ``HostColumn.take``."""
        cond = as_host_column(self.condition.eval_host(hb), hb)
        return hb.filter(np.asarray(cond.data, np.bool_)
                         & np.asarray(cond.validity, np.bool_))

    def execute_host(self, ctx, partition):
        for hb in self.children[0].execute_host(ctx, partition):
            yield self._host_kernel(hb)


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
