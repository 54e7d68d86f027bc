"""Spark-compatible Murmur3 hash and MD5 (port of the JAX package's
``exprs/hash.py``: ``hash_int``, ``hash_long``, ``_double_bits``,
``hash_string_matrix``, ``hash_column``, the ``Murmur3Hash`` expression,
``hash(c1, c2, ...)``, and ``md5_hex_matrix`` with the ``Md5``
expression, ``md5(str)``).

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

MD5 (RFC 1321) runs over the (N, W) byte matrix with each row's own
length, in int64 lanes holding 32-bit words (the device half in torch,
the host half in numpy, one implementation): sums are masked to 32 bits
before each rotate and at the end of each chunk, ``~x`` is ``x ^ M32``.
Each chunk's sixteen message words come from one padded byte matrix
(message, 0x80, zeros, the little-endian bit length) viewed four bytes
at a time, so a chunk costs a few hundred launches.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import DeviceColumn, flush_subnormal
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.columnar.host import (
    HostColumn, StringMatrixView, all_valid)
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


# ---------------------------------------------------------------------------
# MD5 over the string byte matrix
# ---------------------------------------------------------------------------

_MD5_K = tuple(int(abs(math.sin(i + 1)) * (1 << 32)) & M32
               for i in range(64))
_MD5_S = (7, 12, 17, 22) * 4 + (5, 9, 14, 20) * 4 + \
    (4, 11, 16, 23) * 4 + (6, 10, 15, 21) * 4
_MD5_INIT = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)


def _md5_words(xp, data, lengths, chunks: int):
    """(chunks, 16, N) int64 message words of each row's padded stream:
    the message, 0x80, zeros, then the 64-bit little-endian bit length
    (its high word zero: lengths are far below 2^29) ending the row's
    last chunk."""
    n, w = data.shape
    total = chunks * 64
    if xp is torch:
        pad = torch.zeros((n, total), dtype=torch.int64, device=data.device)
        pad[:, :w] = data.to(torch.int64)
        j = torch.arange(total, dtype=torch.int64, device=data.device)[None]
        ln = lengths.to(torch.int64)[:, None]
    else:
        pad = np.zeros((n, total), np.int64)
        pad[:, :w] = data
        j = np.arange(total, dtype=np.int64)[None]
        ln = lengths.astype(np.int64)[:, None]
    padded_len = ((ln + 8) // 64 + 1) * 64
    pad = xp.where(j < ln, pad, 0)
    pad = xp.where(j == ln, 0x80, pad)
    k = j - (padded_len - 8)
    in_len = (k >= 0) & (k < 4)
    shift = xp.where(in_len, k, 0) * 8
    pad = pad | xp.where(in_len, ((ln * 8) >> shift) & 0xFF, 0)
    b = pad.reshape(n, chunks, 16, 4)
    words = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | \
        (b[..., 3] << 24)
    if xp is torch:
        return words.permute(1, 2, 0).contiguous()
    return np.ascontiguousarray(words.transpose(1, 2, 0))


def md5_hex_matrix(xp, data, lengths):
    """MD5 of each row of a (N, W) byte matrix (its first ``lengths[i]``
    bytes), as an (N, 32) lowercase-hex uint8 matrix; ``xp`` is ``torch``
    (the device half) or ``np`` (the host half)."""
    n, w = data.shape
    chunks = (w + 8) // 64 + 1
    words = _md5_words(xp, data, lengths, chunks)
    if xp is torch:
        ln = lengths.to(torch.int64)
        state = [torch.full((n,), v, dtype=torch.int64, device=data.device)
                 for v in _MD5_INIT]
    else:
        ln = lengths.astype(np.int64)
        state = [np.full(n, v, np.int64) for v in _MD5_INIT]
    row_chunks = (ln + 8) // 64 + 1
    for chunk in range(chunks):
        m = words[chunk]
        a, b, c, d = state
        # Words may carry bits above 32 between masks: only the low 32
        # bits of a sum depend on them, and every rotate reads a masked
        # sum (int64 cannot overflow: 64 rounds add below 2^61).
        for i in range(64):
            if i < 16:
                f, g = d ^ (b & (c ^ d)), i
            elif i < 32:
                f, g = c ^ (d & (b ^ c)), (5 * i + 1) % 16
            elif i < 48:
                f, g = b ^ c ^ d, (3 * i + 5) % 16
            else:
                f, g = c ^ (b | (d ^ M32)), (7 * i) % 16
            t = (f + a + m[g] + _MD5_K[i]) & M32
            s = _MD5_S[i]
            a, d, c = d, c, b
            b = b + ((t << s) | (t >> (32 - s)))
        live = chunk < row_chunks
        state = [xp.where(live, (x + y) & M32, x)
                 for x, y in zip(state, (a, b, c, d))]
    # Digest: a | b | c | d little-endian, two lowercase hex digits a byte.
    dig = xp.stack(state, 1) if xp is np else torch.stack(state, dim=1)
    byte_shift = _arange_like(xp, 4, dig) * 8
    byts = (dig[:, :, None] >> byte_shift) & 0xFF          # (N, 4, 4)
    nib = xp.stack([byts >> 4, byts & 0xF], -1).reshape(n, 32) \
        if xp is np else torch.stack([byts >> 4, byts & 0xF],
                                     dim=-1).reshape(n, 32)
    hexd = xp.where(nib < 10, nib + 48, nib + 87)
    return hexd.to(torch.uint8) if xp is torch else hexd.astype(np.uint8)


def _arange_like(xp, k: int, like):
    if xp is torch:
        return torch.arange(k, dtype=torch.int64, device=like.device)
    return np.arange(k, dtype=np.int64)


class Md5(Expression):
    """md5(string) -> the 32-character lowercase hex digest of its UTF-8
    bytes (Spark Md5; NULL in, NULL out)."""

    def __init__(self, child: Expression):
        self._children = (child,)

    @property
    def children(self):
        return self._children

    def data_type(self) -> DataType:
        return dt.STRING

    def eval(self, batch):
        col = as_device_column(self._children[0].eval(batch), batch)
        hexm = md5_hex_matrix(torch, col.data, col.lengths)
        validity = col.validity & batch.row_mask()
        lengths = torch.where(validity, 32, 0).to(torch.int32)
        return make_column(dt.STRING, hexm, validity, lengths)

    def eval_host(self, batch):
        hc = as_host_column(self._children[0].eval_host(batch), batch)
        v = StringMatrixView.of(hc)
        validity = np.asarray(hc.validity, np.bool_)
        hexm = md5_hex_matrix(np, v.data, v.lengths) * \
            validity[:, None].astype(np.uint8)
        return HostColumn(dt.STRING, None, validity, str_matrix=hexm,
                          str_lengths=np.where(validity, 32, 0)
                          .astype(np.int32))
