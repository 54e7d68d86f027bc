"""Device-resident columnar batches as dataclasses of torch tensors.

Port of the JAX package's ``columnar/batch.py``. A batch is a
*fixed-capacity* set of device tensors plus a ``num_rows`` 0-d tensor; rows
past ``num_rows`` are padding. Capacities come from the same bucket ladder
(``bucket_capacity``) so buffers compare one for one with the reference.

Layout per column:
- fixed-width type T: ``data (capacity,) T`` + ``validity (capacity,) bool``
- string: ``data (capacity, width) uint8`` (zero-padded) +
  ``lengths (capacity,) int32`` + validity.

Null semantics: ``validity[i]`` True means non-null. Padding rows have
validity False and zeroed data.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType

MIN_CAPACITY = 8

_TORCH_DTYPES = {
    "bool": torch.bool, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "float32": torch.float32,
    "float64": torch.float64, "date": torch.int32, "timestamp": torch.int64,
    "string": torch.uint8,
}


def torch_dtype(t: DataType) -> torch.dtype:
    """Physical torch element type backing a SQL type."""
    return _TORCH_DTYPES[t.name]


def bucket_capacity(n: int) -> int:
    """Round a row count up to the capacity ladder: rungs at 2^k and
    3*2^(k-1) (8, 12, 16, 24, 32, ...), which caps padding at ~33%."""
    cap = MIN_CAPACITY
    while cap < n:
        if cap * 3 // 2 >= n:
            return cap * 3 // 2
        cap *= 2
    return cap


def zero_dead(data: torch.Tensor, validity: torch.Tensor) -> torch.Tensor:
    """Zero data where validity is False (keeps padding deterministic)."""
    mask = validity[:, None] if data.dim() == 2 else validity
    return torch.where(mask, data, torch.zeros((), dtype=data.dtype,
                                               device=data.device))


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """Subnormal floats as a zero of their sign (NaN and the rest as is).

    The JAX package's device path compares floats with denormals as zero
    (XLA:CPU, like the TPU, flushes them), so its comparisons, join-key
    equality, grouping fingerprints and f64 sort order all see 1e-310 as
    +0.0 and -1e-310 as -0.0. Every float comparison of the port goes
    through here first to give the same answers."""
    tiny = torch.finfo(x.dtype).tiny
    return torch.where(x.abs() < tiny, x * 0, x)


@dataclasses.dataclass
class DeviceColumn:
    """One column of a device batch."""

    dtype: DataType
    data: torch.Tensor              # (cap,) or (cap, width) uint8 strings
    validity: torch.Tensor          # (cap,) bool, True = non-null
    lengths: Optional[torch.Tensor] = None   # (cap,) int32, strings only

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def string_width(self) -> int:
        assert self.dtype.is_string
        return int(self.data.shape[1])

    @classmethod
    def full_null(cls, dtype: DataType, capacity: int, string_width: int = 8,
                  device=None) -> "DeviceColumn":
        """An all-NULL column (zeroed data)."""
        validity = torch.zeros(capacity, dtype=torch.bool, device=device)
        if dtype.is_string:
            return cls(dtype, torch.zeros((capacity, string_width),
                                          dtype=torch.uint8, device=device),
                       validity, torch.zeros(capacity, dtype=torch.int32,
                                             device=device))
        return cls(dtype, torch.zeros(capacity, dtype=torch_dtype(dtype),
                                      device=device), validity)

    def gather(self, indices: torch.Tensor,
               valid_dst: torch.Tensor) -> "DeviceColumn":
        """Take rows at ``indices`` (clipped); ``valid_dst`` masks live
        destination rows."""
        idx = indices.long().clamp(0, max(self.capacity - 1, 0))
        validity = self.validity.index_select(0, idx) & valid_dst
        data = zero_dead(self.data.index_select(0, idx), validity)
        if self.dtype.is_string:
            lengths = torch.where(validity, self.lengths.index_select(0, idx),
                                  torch.zeros_like(self.lengths))
            return DeviceColumn(self.dtype, data, validity, lengths)
        return DeviceColumn(self.dtype, data, validity)

    def with_validity(self, validity: torch.Tensor) -> "DeviceColumn":
        """The same column under ``validity``, data of new nulls zeroed."""
        lengths = None
        if self.dtype.is_string:
            lengths = torch.where(validity, self.lengths,
                                  torch.zeros_like(self.lengths))
        return DeviceColumn(self.dtype, zero_dead(self.data, validity),
                            validity, lengths)


@dataclasses.dataclass
class DeviceBatch:
    """A fixed-capacity columnar batch on the device.

    ``num_rows`` is a 0-d int32 device tensor so data-dependent row counts
    (filter/groupby outputs) need no host sync. ``rows_hint`` is the
    host-known live row count where the producer knows it (uploads do).
    ``sel`` is an optional (capacity,) bool selection vector: rows inside
    the ``num_rows`` prefix with sel False are deleted (lazy filter)."""

    columns: Tuple[DeviceColumn, ...]
    num_rows: torch.Tensor
    rows_hint: Optional[int] = dataclasses.field(default=None, compare=False)
    sel: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        if self.columns:
            return self.columns[0].capacity
        if self.sel is not None:
            return int(self.sel.shape[0])
        return 0

    @property
    def device(self) -> torch.device:
        return self.num_rows.device

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def row_mask(self) -> torch.Tensor:
        """(capacity,) bool: True for live (non-padding, selected) rows."""
        mask = torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.num_rows
        if self.sel is not None:
            mask = mask & self.sel
        return mask

    def live_count(self) -> torch.Tensor:
        """0-d int32: number of live rows (== num_rows when no sel)."""
        if self.sel is None:
            return self.num_rows.to(torch.int32)
        return self.row_mask().sum(dtype=torch.int32)

    def with_sel(self, keep: torch.Tensor) -> "DeviceBatch":
        """Restrict live rows by ``keep`` without moving data."""
        sel = keep if self.sel is None else (self.sel & keep)
        return DeviceBatch(self.columns, self.num_rows, sel=sel)

    def gather(self, indices: torch.Tensor,
               new_num_rows: torch.Tensor) -> "DeviceBatch":
        from spark_rapids_tpu_torch.columnar.rowmove import gather_rows
        return gather_rows(self, indices, new_num_rows)

    def compact(self, keep: Optional[torch.Tensor] = None) -> "DeviceBatch":
        """Materialize rows where ``keep`` (ANDed with row_mask) as a
        packed prefix at the same capacity."""
        from spark_rapids_tpu_torch.columnar.rowmove import compact_batch
        return compact_batch(self, keep)

    def head(self, n: int) -> "DeviceBatch":
        """The first min(n, live) live rows, by selection vector only."""
        live = self.row_mask()
        keep = torch.cumsum(live.to(torch.int32), 0) <= n
        return self.with_sel(keep & live)

    def select(self, indices: Sequence[int]) -> "DeviceBatch":
        return DeviceBatch(tuple(self.columns[i] for i in indices),
                           self.num_rows, sel=self.sel)

    def device_size_bytes(self) -> int:
        total = 4
        for c in self.columns:
            total += c.data.numel() * c.data.element_size()
            total += c.validity.numel()
            if c.lengths is not None:
                total += c.lengths.numel() * 4
        if self.sel is not None:
            total += self.sel.numel()
        return total


def concat_batches(batches: Sequence[DeviceBatch],
                   capacity: int) -> DeviceBatch:
    """Concatenate the live rows of ``batches`` into one dense batch of
    ``capacity`` rows (selection vectors compact away here)."""
    assert batches, "concat of zero batches"
    total_cap = sum(b.capacity for b in batches)
    assert total_cap <= capacity, (
        f"concat overflow: member capacities sum to {total_cap} > {capacity}")
    from spark_rapids_tpu_torch.columnar.rowmove import concat_compact
    return concat_compact(batches, capacity)


# Below this device size a shrink cannot repay its row-count sync.
MIN_SHRINK_BYTES = 4 << 20


def shrink_to_capacity(batch: DeviceBatch, capacity: int) -> DeviceBatch:
    """Re-bucket a batch whose live rows fit ``capacity``; requires
    ``live_count <= capacity``. Selection vectors compact away."""
    if capacity >= batch.capacity and batch.sel is None:
        return batch
    from spark_rapids_tpu_torch.columnar.rowmove import compact_to
    hint = batch.rows_hint
    if batch.sel is not None:
        out = compact_to(batch, capacity, batch.live_count())
    else:
        idx = torch.arange(capacity, dtype=torch.int64, device=batch.device)
        out = batch.gather(idx, batch.num_rows)
    out.rows_hint = hint
    return out


def shrink_all(batches: Sequence[DeviceBatch], min_bytes: int = 0
               ) -> Tuple[List[DeviceBatch], List[Optional[int]]]:
    """Two-phase sizes-then-shrink: pull every unknown live count in ONE
    batched host copy, then re-bucket each batch to its live capacity.
    ``min_bytes`` skips batches too small to repay the pull. Returns
    (shrunk batches, live counts — None where the pull was skipped)."""
    batches = list(batches)
    counts: List[Optional[int]] = [b.rows_hint for b in batches]
    unknown = [i for i, b in enumerate(batches)
               if counts[i] is None and b.device_size_bytes() > min_bytes]
    if unknown:
        pulled = torch.stack([batches[i].live_count().to(torch.int64)
                              for i in unknown]).cpu().tolist()
        for i, c in zip(unknown, pulled):
            counts[i] = int(c)
    out = []
    for b, c in zip(batches, counts):
        if c is not None:
            b = shrink_to_capacity(b, bucket_capacity(max(c, 1)))
            b.rows_hint = c
        out.append(b)
    return out, counts


def coalesce_iter(batches: Iterator[DeviceBatch], target_rows: int,
                  target_bytes: int) -> Iterator[DeviceBatch]:
    """Group a batch stream into ~``target_rows``-capacity batches,
    compacting sparse members first (the JAX package's
    ``coalesce_iter(..., shrink=True)``, which the aggregate's update
    stage runs its input through)."""
    group: List[DeviceBatch] = []
    group_cap = 0
    group_bytes = 0

    def flush():
        g, _ = shrink_all(group, min_bytes=MIN_SHRINK_BYTES)
        if len(g) == 1:
            return g[0]
        out = concat_batches(g, bucket_capacity(sum(b.capacity for b in g)))
        hints = [b.rows_hint for b in g]
        if all(h is not None for h in hints):
            out.rows_hint = sum(hints)
        return out

    for b in batches:
        bb = b.device_size_bytes()
        if group and (group_cap + b.capacity > target_rows
                      or group_bytes + bb > target_bytes):
            yield flush()
            group, group_cap, group_bytes = [], 0, 0
        group.append(b)
        group_cap += b.capacity
        group_bytes += bb
        if group_cap >= target_rows or group_bytes >= target_bytes:
            yield flush()
            group, group_cap, group_bytes = [], 0, 0
    if group:
        yield flush()


def string_repad(col: DeviceColumn, width: int) -> DeviceColumn:
    """Widen a string column's byte matrix to ``width`` bytes."""
    assert col.dtype.is_string
    cur = col.string_width
    if cur == width:
        return col
    assert cur < width, "string_repad only widens"
    pad = torch.zeros((col.capacity, width - cur), dtype=torch.uint8,
                      device=col.data.device)
    return DeviceColumn(col.dtype, torch.cat([col.data, pad], dim=1),
                        col.validity, col.lengths)
