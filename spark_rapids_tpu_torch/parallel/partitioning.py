"""Partitioning strategies (port of the JAX package's
``parallel/partitioning.py``: ``SinglePartitioning``,
``HashPartitioning``, ``RoundRobinPartitioning``, ``RangePartitioning``,
``split_batch`` and ``split_host_batch``; ref GpuHashPartitioning.scala,
GpuRangePartitioning.scala, GpuRoundRobinPartitioning.scala,
GpuSinglePartitioning.scala).

Each strategy maps rows to partition ids: ``partition_ids`` over a device
batch (torch, int32 per capacity slot), ``partition_ids_host`` over a
host batch (int32 per row). Both give the reference's ids bit for bit.

- Hash: ``pmod(murmur3(keys), n)`` with Spark's murmur3, the seed 42
  chained across the keys (``exprs/hash.py`` ``Murmur3Hash``): shuffle
  partitions line up with CPU Spark's. The device half hashes f64
  subnormals as zeros, the host half by their bits, as the reference's
  two halves do.
- Round robin: row position modulo n, starting at partition 0 (the
  reference starts at 0 for determinism; Spark starts at a random one).
- Range: a row goes above every bound it is greater than, comparing the
  ``kernels.sort_key_passes`` words of its keys lexicographically
  against the bounds' words (bounds are inclusive upper bounds: a key
  equal to a bound stays in the lower partition). The host half runs the
  same torch words over CPU tensors, as the reference's runs its jnp
  words over host arrays; like the reference's numpy compare there, it
  orders f64 subnormals by value where the device half flushes them. A
  string key's rows and bounds are padded to one width first, so each
  key's words line up (the reference zips words of unequal counts when
  the widths differ).

``split_batch`` packs each destination's rows into its own batch by one
compaction per destination; the exchange's map side moves every row once
instead (``parallel/exchange.py``). ``split_host_batch`` is one stable
argsort of the ids and one gather per destination.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, string_repad
from spark_rapids_tpu_torch.columnar.host import (
    HostBatch, HostColumn, stable_code_argsort)
from spark_rapids_tpu_torch.exprs.base import (
    Expression, as_device_column, as_host_column)
from spark_rapids_tpu_torch.exprs.hash import Murmur3Hash, host_as_tensors
from spark_rapids_tpu_torch.ops import kernels
from spark_rapids_tpu_torch.ops.sort import SortOrder, sort_host_batch


class Partitioning:
    """Maps each row to a partition id in [0, num_partitions)."""

    num_partitions: int

    def partition_ids(self, batch: DeviceBatch) -> torch.Tensor:
        raise NotImplementedError

    def partition_ids_host(self, hb: HostBatch) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass
class SinglePartitioning(Partitioning):
    num_partitions: int = 1

    def partition_ids(self, batch):
        return torch.zeros(batch.capacity, dtype=torch.int32,
                           device=batch.device)

    def partition_ids_host(self, hb):
        return np.zeros(hb.num_rows, np.int32)


class HashPartitioning(Partitioning):
    """pmod(murmur3(keys), n): Spark's HashPartitioning."""

    def __init__(self, keys: Sequence[Expression], num_partitions: int):
        self.keys = list(keys)
        self.num_partitions = num_partitions
        self._hash = Murmur3Hash(self.keys)

    def partition_ids(self, batch):
        h = as_device_column(self._hash.eval(batch), batch).data
        # torch.remainder floors, so a positive modulus gives pmod.
        return torch.remainder(h.to(torch.int64),
                               self.num_partitions).to(torch.int32)

    def partition_ids_host(self, hb):
        h = as_host_column(self._hash.eval_host(hb), hb).data
        n = self.num_partitions
        return (((h.astype(np.int64) % n) + n) % n).astype(np.int32)


class RoundRobinPartitioning(Partitioning):
    """Position-based distribution from partition ``start``."""

    def __init__(self, num_partitions: int, start: int = 0):
        self.num_partitions = num_partitions
        self.start = start

    def partition_ids(self, batch):
        pos = torch.arange(batch.capacity, dtype=torch.int64,
                           device=batch.device)
        return torch.remainder(self.start + pos,
                               self.num_partitions).to(torch.int32)

    def partition_ids_host(self, hb):
        return ((self.start + np.arange(hb.num_rows)) %
                self.num_partitions).astype(np.int32)


class RangePartitioning(Partitioning):
    """Range partitioning by sort orders against sampled bounds
    (GpuRangePartitioning.scala: a host sample picks the bounds, the
    device compares every row against them). ``bounds`` is a HostBatch
    of the key columns, positionally, with at most num_partitions - 1
    ascending rows."""

    def __init__(self, orders: Sequence[SortOrder], num_partitions: int,
                 bounds: Optional[HostBatch] = None):
        self.orders = list(orders)
        self.num_partitions = num_partitions
        self.bounds = bounds

    @staticmethod
    def compute_bounds(sample: HostBatch, orders,
                       num_partitions: int) -> HostBatch:
        """num_partitions - 1 bounds from a host sample of the keys (the
        reservoir-sample half of GpuRangePartitioner.scala)."""
        sorted_sample = sort_host_batch(sample, orders)
        n = sorted_sample.num_rows
        idxs = [min(n - 1, max(0, (i + 1) * n // num_partitions))
                for i in range(num_partitions - 1)] if n else []
        cols = [HostColumn(c.dtype, c.data[idxs], c.validity[idxs])
                for c in sorted_sample.columns]
        return HostBatch(sorted_sample.names, cols)

    def _ids(self, row_cols, n: int, device, flush: bool) -> torch.Tensor:
        assert self.bounds is not None, "range bounds not computed"
        bound_cols = [_to(host_as_tensors(c), device)
                      for c in self.bounds.columns]
        rows, bounds = [], []
        for rc, bc, o in zip(row_cols, bound_cols, self.orders):
            if rc.dtype.is_string:
                w = max(rc.string_width, bc.string_width)
                rc, bc = string_repad(rc, w), string_repad(bc, w)
            rows += kernels.sort_key_passes(rc, o.ascending, o.nulls_first,
                                            flush)
            bounds += kernels.sort_key_passes(bc, o.ascending,
                                              o.nulls_first, flush)
        pid = torch.zeros(n, dtype=torch.int32, device=device)
        for bi in range(self.bounds.num_rows):
            # row > bound <=> lexicographic compare over the word passes.
            gt = torch.zeros(n, dtype=torch.bool, device=device)
            eq = torch.ones(n, dtype=torch.bool, device=device)
            for rw, bw in zip(rows, bounds):
                b = bw[bi]
                gt = gt | (eq & (rw > b))
                eq = eq & (rw == b)
            pid = pid + gt.to(torch.int32)
        return torch.clamp(pid, max=self.num_partitions - 1)

    def partition_ids(self, batch):
        cols = [as_device_column(o.child.eval(batch), batch)
                for o in self.orders]
        return self._ids(cols, batch.capacity, batch.device, flush=True)

    def partition_ids_host(self, hb):
        cols = [host_as_tensors(as_host_column(o.child.eval_host(hb), hb))
                for o in self.orders]
        return self._ids(cols, hb.num_rows, torch.device("cpu"),
                         flush=False).numpy()


def _to(col, device):
    """A column of CPU tensors moved to ``device``."""
    if device.type == "cpu":
        return col
    return type(col)(col.dtype, col.data.to(device),
                     col.validity.to(device),
                     None if col.lengths is None else col.lengths.to(device))


# ---------------------------------------------------------------------------
# Splitting (Table.contiguousSplit analog)
# ---------------------------------------------------------------------------

def split_batch(batch: DeviceBatch, pids: torch.Tensor,
                num_partitions: int) -> List[DeviceBatch]:
    """Pack each destination's rows into its own batch (stable order)."""
    live = batch.row_mask()
    return [batch.compact((pids == p) & live) for p in range(num_partitions)]


def split_host_batch(hb: HostBatch, pids: np.ndarray,
                     num_partitions: int) -> List[HostBatch]:
    """One stable argsort of the ids, then one gather per destination of
    its slice of the order (``take`` keeps dense string layouts and
    carries key codes)."""
    order = stable_code_argsort(np.asarray(pids, np.int64))
    counts = np.bincount(np.asarray(pids)[order], minlength=num_partitions)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return [hb.take(order[offsets[p]:offsets[p + 1]])
            for p in range(num_partitions)]
