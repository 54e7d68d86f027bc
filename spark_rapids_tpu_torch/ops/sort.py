"""Sort operator (port of the JAX package's ``ops/sort.py``: ``SortOrder``,
``coalesce_to_single_batch``, ``sort_batch`` and an in-core ``SortExec``).

The device sort is the LSD radix over orderable u32 words
(``kernels.lex_sort_perm``), every pass of which is kernel K1 on the card.
The host sort (``host_sort_indices``) is one ``np.lexsort`` over each
key's null-rank plane and its ``encode_sort_key`` codes. The JAX
package's out-of-core range split comes in a later slice; this
``SortExec`` sorts each partition as one batch.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, bucket_capacity, concat_batches)
from spark_rapids_tpu_torch.columnar.host import (
    HostBatch, concat_host_batches, encode_sort_key)
from spark_rapids_tpu_torch.exprs.base import (
    Expression, as_device_column, as_host_column)
from spark_rapids_tpu_torch.ops import kernels
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


class SortExec(Exec):
    """Per-partition full sort, in core: the partition's batches
    concatenate into one, which sorts as a whole."""

    def __init__(self, child: Exec, orders: Sequence[SortOrder]):
        super().__init__(child)
        self.orders = list(orders)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute_device(self, ctx, partition):
        m = ctx.metrics_for(self)
        batches: List[DeviceBatch] = list(
            self.children[0].execute_device(ctx, partition))
        if not batches:
            return
        stable = bool(ctx.conf.get(C.STABLE_SORT))
        with timed(m):
            out = sort_batch(coalesce_to_single_batch(batches), self.orders,
                             stable=stable)
        record_batch(m, out)
        yield out

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
