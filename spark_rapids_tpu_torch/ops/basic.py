"""Basic physical operators (port of the JAX package's ``ops/basic.py``:
``ProjectExec``, ``FilterExec``, ``CoalescePartitionsExec``,
``LocalLimitExec``, ``GlobalLimitExec``)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

from spark_rapids_tpu_torch.exprs.base import (
    Expression, as_device_column, eval_exprs)
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
