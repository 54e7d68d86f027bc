"""Spark-compatible Murmur3 hash (port of the JAX package's
``exprs/hash.py`` murmur3 half: ``hash_int``, ``hash_long``,
``_double_bits``, ``hash_string_matrix``, ``hash_column`` and the
``Murmur3Hash`` expression, ``hash(c1, c2, ...)``).

Implements org.apache.spark.unsafe.hash.Murmur3_x86_32 exactly. torch's
uint32 lacks ``+``, ``>>`` and comparisons, so every u32 word here is an
int64 tensor holding a value in [0, 2^32): products are masked back to 32
bits after each multiply (int64 multiply wraps, and the low 32 bits of the
wrapped product are the u32 product), shifts act on non-negative values.

- bool/byte/short/int/date -> hashInt
- long/timestamp -> hashLong (two 4-byte blocks, low then high)
- float -> hashInt(floatToIntBits), NaN canonicalized
- double -> hashLong(doubleToLongBits), NaN canonicalized; on the device
  half subnormals hash as +/-0.0 like the JAX device path (its
  flush-to-zero), on the host half by their own bits like its numpy half
- string -> hashUnsafeBytes: 4-byte little-endian blocks, then a per-byte
  tail with SIGNED bytes (JVM)
- NULL rows pass the running seed through unchanged
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import DeviceColumn, flush_subnormal
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.columnar.host import StringMatrixView, all_valid
from spark_rapids_tpu_torch.exprs.base import (
    Expression, as_device_column, as_host_column, make_column,
    make_host_column)

DEFAULT_SEED = 42

M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_NAN_F64_BITS = 0x7FF8000000000000


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    k1 = (k1 * _C1) & M32
    k1 = _rotl(k1, 15)
    return (k1 * _C2) & M32


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = _rotl(h1 ^ k1, 13)
    return (h1 * 5 + 0xE6546B64) & M32


def fmix(h1: torch.Tensor, length) -> torch.Tensor:
    """Murmur3 finalizer; ``length`` is an int or a per-row tensor."""
    if isinstance(length, torch.Tensor):
        length = length.to(torch.int64) & M32
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = (h1 * 0x85EBCA6B) & M32
    h1 = h1 ^ (h1 >> 13)
    h1 = (h1 * 0xC2B2AE35) & M32
    return h1 ^ (h1 >> 16)


def hash_int(value_i32: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Murmur3 of one 4-byte value per row (any int dtype, taken as its
    low 32 bits)."""
    k1 = _mix_k1(value_i32.to(torch.int64) & M32)
    return fmix(_mix_h1(seed, k1), 4)


def hash_long(value_i64: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    v = value_i64.to(torch.int64)
    low = v & M32
    high = (v >> 32) & M32
    h1 = _mix_h1(seed, _mix_k1(low))
    h1 = _mix_h1(h1, _mix_k1(high))
    return fmix(h1, 8)


def _float_bits(data: torch.Tensor) -> torch.Tensor:
    """Java floatToIntBits: canonicalize NaN to 0x7FC00000."""
    bits = data.to(torch.float32).view(torch.int32)
    return torch.where(torch.isnan(data),
                       torch.full((), 0x7FC00000, dtype=torch.int32,
                                  device=data.device), bits)


def _double_bits(data: torch.Tensor, flush: bool = True) -> torch.Tensor:
    """Java doubleToLongBits as a real 64-bit bitcast, NaN canonicalized.

    For bit parity with the JAX device path (which decomposes the double
    arithmetically and flushes subnormals to zero), subnormals keep only
    their sign bit with ``flush``: they hash as +0.0 or -0.0."""
    x = data.to(torch.float64)
    bits = (flush_subnormal(x) if flush else x).view(torch.int64)
    return torch.where(torch.isnan(x),
                       torch.full((), _NAN_F64_BITS, dtype=torch.int64,
                                  device=x.device), bits)


def hash_string_matrix(data: torch.Tensor, lengths: torch.Tensor,
                       seed: torch.Tensor) -> torch.Tensor:
    """hashUnsafeBytes over a (N, W) byte matrix with per-row lengths."""
    n, w = data.shape
    h1 = seed
    lengths = lengths.to(torch.int64)
    nblocks_row = lengths // 4
    d = data.to(torch.int64)
    for bi in range(w // 4):
        word = d[:, bi * 4] | (d[:, bi * 4 + 1] << 8) | \
            (d[:, bi * 4 + 2] << 16) | (d[:, bi * 4 + 3] << 24)
        mixed = _mix_h1(h1, _mix_k1(word))
        h1 = torch.where(bi < nblocks_row, mixed, h1)
    aligned = nblocks_row * 4
    signed = data.view(torch.int8).to(torch.int64) & M32
    for off in range(w):
        mixed = _mix_h1(h1, _mix_k1(signed[:, off]))
        in_tail = (off >= aligned) & (off < lengths)
        h1 = torch.where(in_tail, mixed, h1)
    return fmix(h1, lengths)


def hash_column(col, dtype: DataType, seed: torch.Tensor,
                flush: bool = True) -> torch.Tensor:
    """Hash one column (int64-carried u32 per row), passing the seed
    through for NULL rows; ``flush`` hashes f64 subnormals as zeros."""
    if dtype.is_string:
        h = hash_string_matrix(col.data, col.lengths, seed)
    elif dtype.name in ("int64", "timestamp"):
        h = hash_long(col.data, seed)
    elif dtype.name == "float64":
        h = hash_long(_double_bits(col.data, flush), seed)
    elif dtype.name == "float32":
        h = hash_int(_float_bits(col.data), seed)
    else:   # bool/int8/16/32/date widen to int
        h = hash_int(col.data.to(torch.int32), seed)
    return torch.where(col.validity, h, seed)


class Murmur3Hash(Expression):
    """hash(c1, c2, ...) -> int32, the seed chained across columns from
    ``seed``. The device half's result is valid on every live row; the
    host half computes in torch on the CPU without the subnormal flush,
    as the reference's numpy half hashes raw bits."""

    def __init__(self, children: Sequence[Expression],
                 seed: int = DEFAULT_SEED):
        self._children = tuple(children)
        self.seed = seed

    @property
    def children(self):
        return self._children

    def data_type(self) -> DataType:
        return dt.INT32

    def _run(self, cols, n: int, device, flush: bool) -> torch.Tensor:
        h = torch.full((n,), self.seed & M32, dtype=torch.int64,
                       device=device)
        for col, dtype in cols:
            h = hash_column(col, dtype, h, flush)
        return h.to(torch.int32)

    def eval(self, batch):
        cols = [(as_device_column(c.eval(batch), batch), c.data_type())
                for c in self._children]
        data = self._run(cols, batch.capacity, batch.device, flush=True)
        return make_column(dt.INT32, data, batch.row_mask())

    def eval_host(self, batch):
        cols = [(host_as_tensors(as_host_column(c.eval_host(batch), batch)),
                 c.data_type()) for c in self._children]
        data = self._run(cols, batch.num_rows, "cpu", flush=False)
        return make_host_column(dt.INT32, data.numpy(),
                                all_valid(batch.num_rows))


def host_as_tensors(hc) -> DeviceColumn:
    """A host column's arrays as a column of CPU tensors (strings in the
    dense byte-matrix layout), for the torch kernels a host half shares
    with its device half."""
    if hc.dtype.is_string:
        v = StringMatrixView.of(hc)
        return DeviceColumn(
            hc.dtype, torch.from_numpy(np.ascontiguousarray(v.data)),
            torch.from_numpy(np.array(v.validity, np.bool_)),
            torch.from_numpy(np.array(v.lengths, np.int32)))
    return DeviceColumn(hc.dtype,
                        torch.from_numpy(np.array(hc.data, copy=True)),
                        torch.from_numpy(np.array(hc.validity, np.bool_)))
