"""Literal bind slots: runtime-bound literals for the parameterized plan
cache (port of the JAX package's ``exprs/bindslots.py``;
``plan/plan_cache.py``).

A ``Literal`` carries its value, and the structural fingerprint
(``ops/kernel_cache.py``) folds that value in. A :class:`BindSlotExpr` is
the value-free leaf the plan cache hoists bindable literals into: it
carries only ``(slot, dtype)``, and the value arrives at execution time
through :func:`bound_literals`, as a 0-d tensor on the batch's device on
the device path and as a plain python value on the host path. One plan
template, and one fingerprint, then serve every binding of the same
dtype.

Plumbing contract (as ``exprs/nondeterministic.EvalContext``'s):

- The execution's binding vector lives in ``ctx.cache["plan_binds"]``
  (python values) and ``ctx.cache["plan_bind_dtypes"]``, installed by
  ``PhysicalPlan.collect`` from the bound plan, so it reaches the
  pipeline's prefetch threads with the context.
- Device call sites (Project, Filter, the fused stage and the contextual
  loop, ``ops/``) fetch :func:`device_bind_args` and run their step under
  ``with bound_literals(binds)``, so :meth:`BindSlotExpr.eval` reads its
  slot as a 0-d tensor (no ``.item()``, no host sync). Host paths wrap
  their eval in ``bound_literals(host_bind_args(ctx))``.
- Plan attributes that stay host-side python ints (limit budgets, scan
  pushdown predicate values) use :class:`BindValue` markers resolved by
  :func:`resolve_bound`.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import DeviceColumn, torch_dtype
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exprs.base import Expression, Scalar

_BOUND: contextvars.ContextVar[Optional[Tuple]] = \
    contextvars.ContextVar("srt_bound_literals", default=None)


@contextlib.contextmanager
def bound_literals(values: Sequence[Any]):
    """Install the execution's binding vector for the enclosed eval."""
    token = _BOUND.set(tuple(values))
    try:
        yield
    finally:
        _BOUND.reset(token)


def current_bound_literals() -> Optional[Tuple]:
    return _BOUND.get()


@dataclasses.dataclass
class BindSlotExpr(Expression):
    """A hoisted literal: a dtype-typed, value-free leaf. Two bindings of
    the same dtype share one structural fingerprint."""

    slot: int
    dtype: DataType

    def data_type(self) -> DataType:
        return self.dtype

    def _value(self):
        vals = _BOUND.get()
        if vals is None or self.slot >= len(vals):
            raise RuntimeError(
                f"bind slot {self.slot} evaluated without bound literals "
                "(plan-cache template executed outside a bound collect?)")
        return vals[self.slot]

    def eval(self, batch) -> DeviceColumn:
        """A full column of the slot's value on live rows, 0 elsewhere:
        what ``expand_scalar`` makes of a literal, from a 0-d tensor."""
        val = self._value()
        mask = batch.row_mask()
        tdt = torch_dtype(self.dtype)
        if isinstance(val, torch.Tensor):
            val = val.to(device=mask.device, dtype=tdt)
        else:
            val = torch.tensor(val, dtype=tdt, device=mask.device)
        data = torch.where(mask, val, torch.zeros((), dtype=tdt,
                                                  device=mask.device))
        return DeviceColumn(self.dtype, data, mask)

    def eval_host(self, batch) -> Scalar:
        v = self._value()
        if isinstance(v, torch.Tensor):     # device scalar on a host path
            v = v.item()
        if self.dtype is dt.BOOL:
            v = bool(v)
        elif self.dtype.is_integral or self.dtype.is_datetime:
            v = int(v)
        elif self.dtype.is_floating:
            v = float(v)
        return Scalar(self.dtype, v)

    def pretty(self) -> str:
        return f"?{self.slot}:{self.dtype.name}"


@dataclasses.dataclass(frozen=True)
class BindValue:
    """Slot marker for host-side python plan attributes (limit budgets,
    scan pushdown predicate values), resolved per execution by
    :func:`resolve_bound`."""

    slot: int


def resolve_bound(v: Any, ctx) -> Any:
    """A possibly slot-bound plan attribute's value for THIS execution
    (``ctx.cache['plan_binds']``)."""
    if not isinstance(v, BindValue):
        return v
    binds = None if ctx is None else ctx.cache.get("plan_binds")
    if binds is None:
        binds = current_bound_literals()
    if binds is None or v.slot >= len(binds):
        raise RuntimeError(
            f"bind value slot {v.slot} resolved without bound literals")
    return binds[v.slot]


def has_bind_slots(exprs: Sequence[Expression]) -> bool:
    """True when any expression tree holds a bind slot (the call-site test
    for passing the binding vector)."""
    def rec(e: Expression) -> bool:
        if isinstance(e, BindSlotExpr):
            return True
        return any(rec(c) for c in e.children)
    return any(rec(e) for e in exprs)


def device_bind_args(ctx, device) -> Tuple:
    """This execution's binding vector as 0-d tensors of the slots' dtypes
    on ``device`` (the plan's), built once per context and device."""
    per_device = ctx.cache.setdefault("plan_binds_dev", {})
    key = str(torch.device(device))
    cached = per_device.get(key)
    if cached is None:
        vals = ctx.cache.get("plan_binds") or ()
        dts = ctx.cache.get("plan_bind_dtypes") or ()
        cached = tuple(torch.tensor(v, dtype=torch_dtype(t), device=device)
                       for v, t in zip(vals, dts))
        per_device[key] = cached
    return cached


def host_bind_args(ctx) -> Tuple:
    """The raw python binding vector for host-engine eval."""
    return tuple(ctx.cache.get("plan_binds") or ())
