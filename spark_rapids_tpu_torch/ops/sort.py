"""Sort operator (port of the JAX package's ``ops/sort.py``: ``SortOrder``,
``coalesce_to_single_batch``, ``sort_batch`` and an in-core ``SortExec``).

The device sort is the LSD radix over orderable u32 words
(``kernels.lex_sort_perm``), every pass of which is kernel K1 on the card.
The host sort (``host_sort_indices``) is one ``np.lexsort`` over each
key's null-rank plane and its ``encode_sort_key`` codes.

Out of core (the JAX package's sample-sort, beyond the reference's
RequireSingleBatch, GpuSortExec.scala:50): ``out_of_core_partition``
stages a partition's batches as catalog spillables; a partition above a
third of the device budget range-splits through a staged exchange
(``RangePartitioning``, whose map side sorts partition ids with K1) into
bounded spillable buckets, each sorted on its own and streamed in range
order. Peak device memory is about one bucket; the rest rides the spill
tiers. The partition-chunked window uses the same scaffold.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, bucket_capacity, concat_batches)
from spark_rapids_tpu_torch.columnar.host import (
    HostBatch, concat_host_batches, encode_sort_key)
from spark_rapids_tpu_torch.exprs.base import (
    Expression, as_device_column, as_host_column)
from spark_rapids_tpu_torch.ops import kernels
from spark_rapids_tpu_torch.ops import kernel_cache as kc
from spark_rapids_tpu_torch.memory.stores import (
    PRIORITY_SHUFFLE_OUTPUT, SpillableBatch)
from spark_rapids_tpu_torch.ops.base import Exec, Schema, record_batch, timed


@dataclasses.dataclass
class SortOrder:
    """One sort key. Defaults: ascending, nulls first (Spark's ASC NULLS
    FIRST)."""

    child: Expression
    ascending: bool = True
    nulls_first: bool = True


def coalesce_to_single_batch(batches: Sequence[DeviceBatch]) -> DeviceBatch:
    """Concatenate a partition's batches into one (the RequireSingleBatch
    goal): capacity is the bucket of the members' summed capacities."""
    if len(batches) == 1:
        return batches[0]
    return concat_batches(batches,
                          bucket_capacity(sum(b.capacity for b in batches)))


def sort_batch(batch: DeviceBatch, orders: Sequence[SortOrder],
               stable: bool = True) -> DeviceBatch:
    """Fully sort one batch by the sort orders. Live rows sort to the
    front, so the output is dense (the selection vector is discharged by
    the gather)."""
    passes = []
    for o in orders:
        col = as_device_column(o.child.eval(batch), batch)
        passes.extend(kernels.sort_key_passes(col, o.ascending,
                                              o.nulls_first))
    perm = kernels.lex_sort_perm(passes, batch.row_mask(), batch.capacity,
                                 stable=stable)
    return batch.gather(perm, batch.live_count())


class _SpillableListSource(Exec):
    """Leaf serving an already-staged list of catalog spillables, one
    partition each (so a range exchange's bound sampler reads every
    staged batch, not only the first)."""

    def __init__(self, schema: Schema, spillables):
        super().__init__()
        self._schema = tuple(schema)
        self._spillables = spillables

    @property
    def schema(self) -> Schema:
        return self._schema

    def num_partitions(self, ctx) -> int:
        return len(self._spillables)

    def execute_device(self, ctx, partition):
        sb = self._spillables[partition]
        try:
            yield sb.get()
        finally:
            # The bound sampler abandons this stream after one batch: the
            # staged entry turns spillable again either way.
            sb.release(PRIORITY_SHUFFLE_OUTPUT)

    def execute_host(self, ctx, partition):    # pragma: no cover
        raise AssertionError("device-only staging source")


def stage_spillables(ctx, child_iter):
    """Register a batch stream as catalog spillables (the staging step of
    out-of-core sorts, windows and grace joins). Returns (spillables,
    their total device bytes). A stream that fails part way closes what
    it had registered before the error propagates."""
    spillables = []
    total_bytes = 0
    try:
        for b in child_iter:
            total_bytes += b.device_size_bytes()
            spillables.append(SpillableBatch(ctx.catalog, b,
                                             PRIORITY_SHUFFLE_OUTPUT))
    except BaseException:
        for sb in spillables:
            sb.close()
        raise
    return spillables, total_bytes


def staged_exchange(spillables, schema, partitioning):
    """An exchange over staged spillables: sorts and windows give it a
    ``RangePartitioning`` (equal keys share a bucket, buckets stream in
    range order), grace joins a ``HashPartitioning`` over the join keys
    (both sides bucket alike). It never coalesces: bucket identity
    matters to every caller."""
    from spark_rapids_tpu_torch.parallel.exchange import ShuffleExchangeExec
    return ShuffleExchangeExec(_SpillableListSource(schema, spillables),
                               partitioning)


def out_of_core_partition(ctx, metrics, child_iter, schema,
                          split_orders: Sequence[SortOrder], batch_fn):
    """The out-of-core scaffold of sorts and partition-chunked windows:
    stage the partition's batches as spillables; a partition within a
    third of the device budget (or with no ``split_orders``) runs
    ``batch_fn`` over one coalesced batch, a larger one range-splits by
    ``split_orders`` into ``ceil(bytes / (budget / 3))`` buckets (at
    least 2, counted in ``outOfCoreBuckets``) and runs ``batch_fn`` per
    bucket, in range order. Each ``batch_fn`` call is an OOM retry
    site."""
    from spark_rapids_tpu_torch.parallel.partitioning import \
        RangePartitioning
    m = metrics
    spillables, total_bytes = stage_spillables(ctx, child_iter)
    if not spillables:
        return
    m.add("stagedBytes", total_bytes)
    bucket_budget = max(ctx.catalog.device_budget // 3, 1 << 16)
    if total_bytes <= bucket_budget or not split_orders:
        try:
            single = coalesce_to_single_batch([sb.get() for sb in spillables])
        finally:
            for sb in spillables:
                sb.close()
        with timed(m):
            out = kc.call(batch_fn, single)
        del single
        record_batch(m, out)
        yield out
        return
    nb = max(2, -(-total_bytes // bucket_budget))
    m.add("outOfCoreBuckets", nb)
    ex = staged_exchange(spillables, schema,
                         RangePartitioning(list(split_orders), nb))
    try:
        for p in range(nb):
            bucket = list(ex.execute_device(ctx, p))
            if not bucket:
                continue
            single = coalesce_to_single_batch(bucket)
            del bucket
            ex.release(ctx, p)
            with timed(m):
                out = kc.call(batch_fn, single)
            del single
            record_batch(m, out)
            yield out
    finally:
        ex.release(ctx)
        for sb in spillables:
            sb.close()


class SortExec(Exec):
    """Per-partition full sort (a global order needs a range exchange
    upstream, as in Spark), out of core past a third of the device
    budget (see the module doc)."""

    def __init__(self, child: Exec, orders: Sequence[SortOrder]):
        super().__init__(child)
        self.orders = list(orders)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute_device(self, ctx, partition):
        stable = bool(ctx.conf.get(C.STABLE_SORT))
        orders = self.orders
        yield from out_of_core_partition(
            ctx, ctx.metrics_for(self),
            self.children[0].execute_device(ctx, partition), self.schema,
            orders, lambda b: sort_batch(b, orders, stable=stable))

    def execute_host(self, ctx, partition):
        hbs = list(self.children[0].execute_host(ctx, partition))
        if not hbs:
            return
        yield sort_host_batch(concat_host_batches(hbs), self.orders)


def host_sort_indices(hb: HostBatch,
                      orders: Sequence[SortOrder]) -> np.ndarray:
    """Stable row permutation sorting ``hb`` under Spark semantics (every
    NaN canonical and greatest, -0.0 < 0.0, per-key null placement).
    Each key gives two ``np.lexsort`` planes: the null rank (ascending
    whatever the key's direction) and the ``encode_sort_key`` code,
    bit-inverted for descending (``~x`` reverses int64 order with no
    overflow)."""
    planes = []
    for o in orders:
        col = as_host_column(o.child.eval_host(hb), hb)
        valid = np.asarray(col.validity, np.bool_)
        null_rank = (valid if o.nulls_first else ~valid).astype(np.int8)
        code = encode_sort_key(col)
        if not o.ascending:
            code = np.where(valid, ~code, np.int64(0))
        planes.append((null_rank, code))
    # np.lexsort keys run last to first: least significant first.
    lex = []
    for null_rank, code in reversed(planes):
        lex.append(code)
        lex.append(null_rank)
    return np.lexsort(lex)


def sort_host_batch(hb: HostBatch, orders: Sequence[SortOrder]) -> HostBatch:
    """Host sort with Spark semantics (NaN greatest, null ordering)."""
    return hb.take(host_sort_indices(hb, orders))
