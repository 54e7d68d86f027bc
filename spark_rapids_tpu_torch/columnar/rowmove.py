"""Row movement: gather, compaction and concatenation of device batches.

Port of the JAX package's ``columnar/rowmove.py``. The JAX package packs
all columns into a few 2-D slabs so one TPU gather moves every column; on
the GPU a per-column ``index_select`` is already a coalesced copy, so the
port moves column by column. The contract is the same: dead destination
slots are zeroed whole (data, validity and lengths), and live rows keep
their data as is, null rows included.

``.at[pos].set(..., mode="drop")`` becomes a write into a buffer one slot
longer, with that slot sliced off.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, DeviceColumn, string_repad)


def _take(t: torch.Tensor, idx: torch.Tensor,
          valid_dst: torch.Tensor) -> torch.Tensor:
    g = t.index_select(0, idx)
    mask = valid_dst[:, None] if g.dim() == 2 else valid_dst
    return torch.where(mask, g, torch.zeros((), dtype=g.dtype,
                                            device=g.device))


def gather_rows(batch: DeviceBatch, indices: torch.Tensor,
                new_num_rows: torch.Tensor,
                valid_dst: Optional[torch.Tensor] = None) -> DeviceBatch:
    """Take rows at ``indices`` (clipped) into a dense batch of
    ``len(indices)`` capacity. ``valid_dst`` masks live destination slots
    (defaults to ``arange < new_num_rows``); dead slots are zeroed whole."""
    cap = int(indices.shape[0])
    new_num_rows = torch.as_tensor(new_num_rows, dtype=torch.int32,
                                   device=indices.device)
    if valid_dst is None:
        valid_dst = torch.arange(cap, dtype=torch.int32,
                                 device=indices.device) < new_num_rows
    idx = indices.long().clamp(0, max(batch.capacity - 1, 0))
    cols: List[DeviceColumn] = []
    for c in batch.columns:
        data = _take(c.data, idx, valid_dst)
        validity = _take(c.validity, idx, valid_dst)
        lengths = _take(c.lengths, idx, valid_dst) \
            if c.dtype.is_string else None
        cols.append(DeviceColumn(c.dtype, data, validity, lengths))
    return DeviceBatch(tuple(cols), new_num_rows)


def _scatter(t: torch.Tensor, positions: torch.Tensor,
             capacity: int) -> torch.Tensor:
    """``zeros(capacity).at[positions].set(t, mode="drop")``: positions
    >= capacity land in one extra slot that is sliced off."""
    out = torch.zeros((capacity + 1,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[positions.long().clamp(max=capacity)] = t
    return out[:capacity]


def scatter_rows(batch: DeviceBatch, positions: torch.Tensor, capacity: int,
                 num_rows: torch.Tensor) -> DeviceBatch:
    """Write row i to ``positions[i]``; positions >= capacity are dropped.
    Callers route dead rows to ``capacity``."""
    cols = []
    for c in batch.columns:
        lengths = _scatter(c.lengths, positions, capacity) \
            if c.dtype.is_string else None
        cols.append(DeviceColumn(c.dtype, _scatter(c.data, positions, capacity),
                                 _scatter(c.validity, positions, capacity),
                                 lengths))
    return DeviceBatch(tuple(cols), num_rows.to(torch.int32))


def compact_batch(batch: DeviceBatch,
                  keep: Optional[torch.Tensor] = None) -> DeviceBatch:
    """Materialize live rows (optionally ANDed with ``keep``) as a packed
    prefix at the same capacity."""
    live = batch.row_mask() if keep is None else (keep & batch.row_mask())
    positions = torch.cumsum(live.to(torch.int32), 0, dtype=torch.int32) - 1
    positions = torch.where(live, positions,
                            torch.full((), batch.capacity, dtype=torch.int32,
                                       device=live.device))
    new_rows = live.sum(dtype=torch.int32)
    return scatter_rows(batch, positions, batch.capacity, new_rows)


def compact_to(batch: DeviceBatch, capacity: int,
               live_count: torch.Tensor) -> DeviceBatch:
    """Compact live rows into a batch of (smaller) ``capacity``: an int
    scatter builds the live-row index list, then a gather at the target
    capacity moves the data."""
    live = batch.row_mask()
    rank = torch.cumsum(live.to(torch.int32), 0, dtype=torch.int32) - 1
    dst = torch.where(live, rank, torch.full((), capacity, dtype=torch.int32,
                                             device=live.device))
    src = torch.arange(batch.capacity, dtype=torch.int32, device=live.device)
    idx = _scatter(src, dst, capacity)
    return gather_rows(batch, idx, live_count)


def concat_compact(batches: Sequence[DeviceBatch],
                   capacity: int) -> DeviceBatch:
    """Concatenate the LIVE rows of ``batches`` into one dense batch:
    each member's live rows are packed by a cumsum offset by the running
    live total; every destination slot is written once."""
    assert batches, "concat of zero batches"
    widths = []
    for ci in range(batches[0].num_columns):
        if batches[0].columns[ci].dtype.is_string:
            widths.append(max(b.columns[ci].string_width for b in batches))
        else:
            widths.append(None)
    dev = batches[0].device
    acc: List[List[Optional[torch.Tensor]]] = [
        [None, None, None] for _ in widths]
    off = torch.zeros((), dtype=torch.int32, device=dev)
    for b in batches:
        live = b.row_mask()
        pos = torch.cumsum(live.to(torch.int32), 0, dtype=torch.int32) - 1 \
            + off
        pos = torch.where(live, pos, torch.full((), capacity,
                                                dtype=torch.int32,
                                                device=dev)).long()
        for ci, (c, w) in enumerate(zip(b.columns, widths)):
            if w is not None:
                c = string_repad(c, w)
            parts = (c.data, c.validity, c.lengths)
            for k, t in enumerate(parts):
                if t is None:
                    continue
                if acc[ci][k] is None:
                    acc[ci][k] = torch.zeros(
                        (capacity + 1,) + tuple(t.shape[1:]), dtype=t.dtype,
                        device=dev)
                acc[ci][k][pos] = t
        off = off + live.sum(dtype=torch.int32)
    cols = []
    for c, parts in zip(batches[0].columns, acc):
        data, validity, lengths = (None if p is None else p[:capacity]
                                   for p in parts)
        cols.append(DeviceColumn(c.dtype, data, validity, lengths))
    return DeviceBatch(tuple(cols), off)
