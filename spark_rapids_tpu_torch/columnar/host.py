"""Host-resident columnar batches and host<->device transitions.

Port of the JAX package's ``columnar/host.py``, cut to what the port's
slice needs. Host data is numpy (fixed width) or, for strings, either a
numpy object array of ``bytes`` or the dense device layout (``str_matrix``
(n, w) uint8 + ``str_lengths`` int32).

The upload goes through the wire codec (``columnar/wire.py``, default
``v2``, as in the reference). The download pulls every batch's buffers
with one batched copy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import DeviceLike, resolve_device
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (
    MIN_SHRINK_BYTES, DeviceBatch, DeviceColumn, shrink_all)
from spark_rapids_tpu_torch.columnar.dtypes import DataType


class HostColumn:
    """One host column: values + validity. Strings are ``object`` arrays of
    python ``bytes`` (None entries mean null), or the dense matrix layout
    (``str_matrix`` + ``str_lengths``) with ``data`` None."""

    def __init__(self, dtype: DataType, data: Optional[np.ndarray],
                 validity: np.ndarray,
                 str_matrix: Optional[np.ndarray] = None,
                 str_lengths: Optional[np.ndarray] = None):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.str_matrix = str_matrix
        self.str_lengths = str_lengths

    @property
    def num_rows(self) -> int:
        return len(self.validity)

    @classmethod
    def from_values(cls, dtype: DataType, values: Sequence) -> "HostColumn":
        """Build from a python sequence; None means null."""
        n = len(values)
        validity = np.array([v is not None for v in values], dtype=np.bool_)
        if dtype.is_string:
            data = np.empty(n, dtype=object)
            data[:] = [b"" if v is None else
                       (v.encode("utf-8") if isinstance(v, str) else bytes(v))
                       for v in values]
        else:
            data = np.zeros(n, dtype=dtype.np_dtype)
            idx = np.nonzero(validity)[0]
            if len(idx):
                data[idx] = np.asarray([values[i] for i in idx],
                                       dtype=dtype.np_dtype)
        return cls(dtype, data, validity)

    def to_list(self) -> list:
        """Python values with None for nulls."""
        val = np.asarray(self.validity, dtype=np.bool_)
        if self.dtype.is_string:
            m, lens = strings_to_matrix(self)
            w = m.shape[1]
            buf = np.ascontiguousarray(m).tobytes()
            lens_l = lens.tolist()
            return [buf[i * w:i * w + lens_l[i]].decode("utf-8", "replace")
                    if v else None for i, v in enumerate(val.tolist())]
        out = np.asarray(self.data)[:len(val)].tolist()
        for i in np.flatnonzero(~val).tolist():
            out[i] = None
        return out


@dataclasses.dataclass
class HostBatch:
    names: Tuple[str, ...]
    columns: List[HostColumn]

    @property
    def num_rows(self) -> int:
        return self.columns[0].num_rows if self.columns else 0

    def to_pylist(self) -> List[tuple]:
        cols = [c.to_list() for c in self.columns]
        return list(zip(*cols)) if cols else []

    @classmethod
    def from_pydict(cls, schema: Sequence[Tuple[str, DataType]],
                    data: dict) -> "HostBatch":
        names = tuple(n for n, _ in schema)
        return cls(names, [HostColumn.from_values(t, data[n])
                           for n, t in schema])


def strings_to_matrix(col: HostColumn) -> Tuple[np.ndarray, np.ndarray]:
    """Host string column -> ((n, w) uint8 byte matrix, (n,) int32
    lengths). ``None`` entries become empty strings."""
    if col.str_matrix is not None:
        return col.str_matrix, col.str_lengths
    n = col.num_rows
    vals = [b"" if b is None else bytes(b) for b in col.data]
    if not n:
        return np.zeros((0, 1), np.uint8), np.zeros(0, np.int32)
    lens = np.fromiter(map(len, vals), dtype=np.int64, count=n)
    w = max(int(lens.max()), 1)
    m = np.zeros((n, w), dtype=np.uint8)
    total = int(lens.sum())
    if total:
        flat = np.frombuffer(b"".join(vals), dtype=np.uint8)
        rows = np.repeat(np.arange(n, dtype=np.int64), lens)
        starts = np.cumsum(lens) - lens
        pos = np.arange(total, dtype=np.int64) - np.repeat(starts, lens)
        m[rows, pos] = flat
    return m, lens.astype(np.int32)


def matrix_to_strings(data: np.ndarray, lengths: np.ndarray,
                      validity: np.ndarray) -> HostColumn:
    """Inverse of strings_to_matrix; the object array stays lazy."""
    return HostColumn(dt.STRING, None, np.asarray(validity, np.bool_),
                      str_matrix=np.asarray(data),
                      str_lengths=np.asarray(lengths, np.int32))


# ---------------------------------------------------------------------------
# Transitions (host -> device -> host)
# ---------------------------------------------------------------------------

def host_to_device(batch: HostBatch, capacity: Optional[int] = None,
                   string_widths: Optional[dict] = None,
                   device: DeviceLike = None) -> DeviceBatch:
    """Upload a host batch into a fresh fixed-capacity device batch on
    ``device`` (``None`` = the CUDA card, raising when there is none).

    The upload goes through the wire codec (``columnar/wire.py``): narrow
    lossless wire dtypes and packed or absent validity in one staging
    buffer, one host->device copy, and an on-device widen back to the
    logical layout, as the JAX package's ``host_to_device`` does."""
    from spark_rapids_tpu_torch.columnar import wire
    return wire.upload(batch, capacity, string_widths, device)


def download_batches(batches: Sequence[DeviceBatch],
                     names: Optional[Sequence[str]] = None
                     ) -> List[HostBatch]:
    """Download device batches with one batched copy: large batches first
    shrink to their live bucket (one batched row-count pull), then every
    remaining buffer is copied to the host in one pass and synchronized
    once; selection vectors filter on the host."""
    batches, _ = shrink_all(batches, min_bytes=MIN_SHRINK_BYTES)
    leaves: List[torch.Tensor] = []
    for b in batches:
        leaves.append(b.num_rows)
        if b.sel is not None:
            leaves.append(b.sel)
        for c in b.columns:
            leaves.append(c.data)
            leaves.append(c.validity)
            if c.dtype.is_string:
                leaves.append(c.lengths)
    fetched = [t.to("cpu", non_blocking=True) for t in leaves]
    if any(t.is_cuda for t in leaves):
        torch.cuda.synchronize()
    it = iter(fetched)
    out = []
    for b in batches:
        n = int(next(it))
        keep = next(it).numpy()[:n] if b.sel is not None else None
        cols = []
        for c in b.columns:
            data_h = next(it).numpy()[:n]
            validity = next(it).numpy()[:n]
            lengths = next(it).numpy()[:n] if c.dtype.is_string else None
            if keep is not None:
                data_h, validity = data_h[keep], validity[keep]
                if lengths is not None:
                    lengths = lengths[keep]
            if c.dtype.is_string:
                cols.append(matrix_to_strings(data_h, lengths, validity))
            else:
                data = data_h.copy()
                data[~validity] = np.zeros(1, c.dtype.np_dtype)
                cols.append(HostColumn(c.dtype, data, validity))
        batch_names = tuple(names) if names is not None else \
            tuple(f"c{i}" for i in range(b.num_columns))
        out.append(HostBatch(batch_names, cols))
    return out


def device_to_host(batch: DeviceBatch,
                   names: Optional[Sequence[str]] = None) -> HostBatch:
    """Download one device batch, trimming padding rows."""
    return download_batches([batch], names)[0]


def from_jax_batch_arrays(dtypes: Sequence[DataType],
                          columns: Sequence[Tuple[np.ndarray, np.ndarray,
                                                  Optional[np.ndarray]]],
                          num_rows: int, device: DeviceLike = None,
                          sel: Optional[np.ndarray] = None) -> DeviceBatch:
    """The JAX package's device batch, as numpy arrays — each column's
    ``(data, validity, lengths-or-None)`` plus ``num_rows`` (and ``sel``
    where it has one) — turned into this package's ``DeviceBatch``
    buffer for buffer, so a test can feed both engines identical device
    state."""
    dev = resolve_device(device)
    cols = []
    for t, (data, validity, lengths) in zip(dtypes, columns):
        lens = None if lengths is None else \
            torch.from_numpy(np.asarray(lengths, np.int32).copy()).to(dev)
        cols.append(DeviceColumn(
            t, torch.from_numpy(np.asarray(data, t.np_dtype).copy()).to(dev),
            torch.from_numpy(np.asarray(validity, np.bool_).copy()).to(dev),
            lens))
    sel_t = None if sel is None else \
        torch.from_numpy(np.asarray(sel, np.bool_).copy()).to(dev)
    return DeviceBatch(tuple(cols),
                       torch.tensor(int(num_rows), dtype=torch.int32,
                                    device=dev), sel=sel_t)
