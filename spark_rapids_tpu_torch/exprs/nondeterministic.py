"""Nondeterministic and task-context expressions (port of the JAX
package's ``exprs/nondeterministic.py``): ``SparkPartitionID``,
``MonotonicallyIncreasingID``, ``Rand`` and ``InputFileName``.

Their value depends on the task context (the partition index, the row's
position in the partition, the current input file) rather than only on
column inputs. The evaluating operator (``ProjectExec`` / ``FilterExec``)
sets an ``EvalContext`` around each batch through ``eval_context``; on the
device half the row base is an int64 tensor on the card, advanced by each
batch's row count with no host sync.

``Rand`` is the reference's counter-based stream: a premixed seed plus
the partition and the row index, through the SplitMix64 finalizer, top 53
bits scaled into [0, 1). It equals the reference bit for bit on both
halves. The device half computes the uint64 arithmetic in int64 (torch has
no unsigned 64-bit multiply or shift on the card): multiplies wrap the
same way, constants above 2^63 are written as their signed values, and a
logical right shift is an arithmetic one with the sign-extended bits
masked off. After the final shift by 11 the value is below 2^53, so its
float64 conversion is exact.

There is no file scan in the port yet, so ``InputFileName`` is "".
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.columnar.host import all_valid
from spark_rapids_tpu_torch.exprs.base import (
    Expression, Scalar, make_column, make_host_column)


@dataclasses.dataclass
class EvalContext:
    """Per-batch task context seen by contextual expressions.
    ``partition_id`` is a python int; ``row_base`` (the rows of the
    partition before this batch) is a python int on the host half and an
    int64 tensor or an int on the device half."""

    partition_id: Any = 0
    row_base: Any = 0
    input_file: Optional[str] = None


_EVAL_CTX: contextvars.ContextVar[Optional[EvalContext]] = \
    contextvars.ContextVar("spark_rapids_tpu_torch_eval_ctx", default=None)


@contextlib.contextmanager
def eval_context(ctx: EvalContext):
    token = _EVAL_CTX.set(ctx)
    try:
        yield ctx
    finally:
        _EVAL_CTX.reset(token)


def current_eval_context() -> EvalContext:
    ctx = _EVAL_CTX.get()
    return ctx if ctx is not None else EvalContext()


class ContextualExpression(Expression):
    """Marker base: evaluation reads the EvalContext."""


def needs_eval_context(exprs) -> bool:
    """True when any expression tree holds a contextual node."""
    def rec(e: Expression) -> bool:
        return isinstance(e, ContextualExpression) or \
            any(rec(c) for c in e.children)
    return any(rec(e) for e in exprs)


def _device_base(ctx: EvalContext, device) -> torch.Tensor:
    return torch.as_tensor(ctx.row_base, dtype=torch.int64, device=device)


class SparkPartitionID(ContextualExpression):
    """spark_partition_id()."""

    def data_type(self) -> DataType:
        return dt.INT32

    def eval(self, batch):
        ctx = current_eval_context()
        mask = batch.row_mask()
        data = torch.full((batch.capacity,), int(ctx.partition_id),
                          dtype=torch.int32, device=mask.device)
        return make_column(dt.INT32, data, mask)

    def eval_host(self, batch):
        n = batch.num_rows
        return make_host_column(
            dt.INT32, np.full(n, int(current_eval_context().partition_id),
                              np.int32), all_valid(n))

    def pretty(self) -> str:
        return "spark_partition_id()"


class MonotonicallyIncreasingID(ContextualExpression):
    """monotonically_increasing_id(): ``(partition_id << 33)`` + the row's
    index in the partition (Spark's layout: upper 31 bits the partition,
    lower 33 the row). On the device half the index counts the batch's
    live rows from the row base."""

    def data_type(self) -> DataType:
        return dt.INT64

    def eval(self, batch):
        ctx = current_eval_context()
        mask = batch.row_mask()
        base = _device_base(ctx, mask.device)
        idx = base + torch.cumsum(mask.to(torch.int64), 0) - 1
        val = int(ctx.partition_id) * (1 << 33) + idx.clamp(min=0)
        return make_column(dt.INT64, val, mask)

    def eval_host(self, batch):
        ctx = current_eval_context()
        n = batch.num_rows
        idx = int(ctx.row_base) + np.arange(n, dtype=np.int64)
        val = (np.int64(int(ctx.partition_id)) << np.int64(33)) + idx
        return make_host_column(dt.INT64, val, all_valid(n))

    def pretty(self) -> str:
        return "monotonically_increasing_id()"


# -- the counter-based uniform stream ----------------------------------------

_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB
_U64 = 0xFFFFFFFFFFFFFFFF


def _signed(v: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _premix_seed(seed: int) -> int:
    """SplitMix64 over python ints: decorrelates seeds before they meet
    the row counter (else seed s+1's stream is a shift of seed s's)."""
    x = (seed * _GOLDEN) & _U64
    x = ((x ^ (x >> 30)) * _MIX1) & _U64
    x = ((x ^ (x >> 27)) * _MIX2) & _U64
    return x ^ (x >> 31)


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits by a constant ``k`` in 1..63."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _uniform_device(seed: int, pid: int, idx: torch.Tensor) -> torch.Tensor:
    """int64 row indexes -> float64 in [0, 1), bit for bit the
    reference's uint64 stream."""
    ctr = (idx * _signed(_GOLDEN)
           + _signed((_premix_seed(seed) + pid * _MIX1) & _U64))
    x = (ctr ^ _srl(ctr, 30)) * _signed(_MIX1)
    x = (x ^ _srl(x, 27)) * _signed(_MIX2)
    x = x ^ _srl(x, 31)
    return _srl(x, 11).to(torch.float64) * (2.0 ** -53)


def _uniform_host(seed: int, pid: int, idx: np.ndarray) -> np.ndarray:
    """The same stream in numpy uint64 (wrapping is the point)."""
    with np.errstate(over="ignore"):
        ctr = (np.uint64(_premix_seed(seed))
               + np.uint64(pid) * np.uint64(_MIX1)
               + idx.astype(np.uint64) * np.uint64(_GOLDEN))
        x = (ctr ^ (ctr >> np.uint64(30))) * np.uint64(_MIX1)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(_MIX2)
        x = x ^ (x >> np.uint64(31))
        return (x >> np.uint64(11)).astype(np.float64) * np.float64(2.0 ** -53)


class Rand(ContextualExpression):
    """rand(seed): a uniform [0, 1) double, seeded per (seed, partition)
    and stable per row index (the index counts batch positions from the
    row base on the device half, rows on the host half)."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def data_type(self) -> DataType:
        return dt.FLOAT64

    def eval(self, batch):
        ctx = current_eval_context()
        mask = batch.row_mask()
        idx = _device_base(ctx, mask.device) + torch.arange(
            batch.capacity, dtype=torch.int64, device=mask.device)
        return make_column(dt.FLOAT64, _uniform_device(
            self.seed, int(ctx.partition_id), idx), mask)

    def eval_host(self, batch):
        ctx = current_eval_context()
        n = batch.num_rows
        idx = int(ctx.row_base) + np.arange(n, dtype=np.int64)
        return make_host_column(dt.FLOAT64, _uniform_host(
            self.seed, int(ctx.partition_id), idx), all_valid(n))

    def pretty(self) -> str:
        return f"rand({self.seed})"


class InputFileName(ContextualExpression):
    """input_file_name(): the path the current batch was scanned from, ""
    for a batch that did not come straight from one file (every batch,
    until the port has a file scan)."""

    def data_type(self) -> DataType:
        return dt.STRING

    @property
    def self_jittable(self) -> bool:
        # A per-batch host string.
        return False

    def _scalar(self) -> Scalar:
        return Scalar(dt.STRING, current_eval_context().input_file or "")

    def eval(self, batch):
        return self._scalar()

    def eval_host(self, batch):
        return self._scalar()

    def pretty(self) -> str:
        return "input_file_name()"
