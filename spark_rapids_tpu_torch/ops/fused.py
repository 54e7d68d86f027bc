"""Stage fusion (port of the JAX package's ``ops/fused.py``; the
WholeStageCodegen analog).

A ``FusedStageExec`` replaces a maximal run of contiguous row-local
device operators (Project, Filter, LocalLimit, Expand; ``plan/fusion.py``
draws the stage breaks) with ONE exec whose per-batch step is the
composition of the members' steps, built once per stage. A Project ->
Filter -> Project chain is one call instead of three, and no batch
materializes between the steps: the filter's selection vector flows
straight into the next projection. Until the step is captured as a CUDA
graph the members' torch launches are the same; what fusion saves is the
per-operator host work between them.

The composed step is built from specs (expression lists, limit slots),
never from the exec objects, so the step pins no plan subtree.
LocalLimit keeps a per-partition row budget: the step takes the
remaining budgets and returns them, so one entry serves the whole
partition stream; a budget is a host int advanced by the batch's
host-known row count where there is one (a device count otherwise), as
``LocalLimitExec`` advances it, and once a budget is spent the stage
pulls no further batch. Expand is 1 -> K: the step flat-maps, so a stage
holding an Expand returns K output batches per input batch. The stage's
rows (and batches) are those of the unfused chain, bit for bit.

The call is an OOM retry site with the ``kernel`` fault site
(``kernel_cache.call``), as each member's step is. The member execs keep their original child links: the host
engine runs the outermost member's ``execute_host`` over the unfused
chain, and ``spark.rapids.sql.stageFusion.enabled`` off restores the
unfused plan shape exactly.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.exprs.base import as_device_column, eval_exprs
from spark_rapids_tpu_torch.exprs.bindslots import (
    bound_literals, device_bind_args, has_bind_slots, resolve_bound)
from spark_rapids_tpu_torch.ops import kernel_cache as kc
from spark_rapids_tpu_torch.ops.base import (
    Exec, ExecContext, Schema, record_batch, timed)


def _stage_specs(ops: Sequence[Exec]) -> List[Tuple[str, object]]:
    """Pure step descriptors of the member execs (expression lists, limit
    slots): the composed step closes over these, never over the execs."""
    from spark_rapids_tpu_torch.ops.basic import (
        ExpandExec, FilterExec, LocalLimitExec, ProjectExec)
    specs: List[Tuple[str, object]] = []
    nlimits = 0
    for op in ops:
        if isinstance(op, ProjectExec):
            specs.append(("project", tuple(op.exprs)))
        elif isinstance(op, FilterExec):
            specs.append(("filter", op.condition))
        elif isinstance(op, LocalLimitExec):
            specs.append(("limit", nlimits))
            nlimits += 1
        elif isinstance(op, ExpandExec):
            specs.append(("expand", tuple(tuple(p)
                                          for p in op.projections)))
        else:  # pragma: no cover - the planner guards the member set
            raise TypeError(f"unfusible op {type(op).__name__}")
    return specs


def _spec_exprs(specs: Sequence[Tuple[str, object]]):
    """Every expression the stage evaluates (the bind-slot probe)."""
    out = []
    for kind, payload in specs:
        if kind == "project":
            out.extend(payload)
        elif kind == "filter":
            out.append(payload)
        elif kind == "expand":
            out.extend(e for proj in payload for e in proj)
    return out


def _head(b: DeviceBatch, remaining: int) -> Tuple[DeviceBatch, int]:
    """``LocalLimitExec``'s step: the first ``remaining`` live rows, and
    how many were taken (host-known where the batch's count is)."""
    out = b.head(remaining)
    if b.rows_hint is not None:
        taken = min(b.rows_hint, remaining)
        out.rows_hint = taken
    else:
        taken = int(out.live_count())
    return out, taken


def _build_fused(specs: Sequence[Tuple[str, object]]):
    """Compose the members' steps into one ``fused(batch, rems, binds) ->
    (outputs, rems)``: ``rems`` holds one remaining-row budget per
    LocalLimit member, ``binds`` the execution's bound literals (empty
    when the stage has no bind slot)."""

    def fused(batch: DeviceBatch, rems, binds=()):
        with bound_literals(binds):
            return _fused_body(batch, list(rems))

    def _fused_body(batch: DeviceBatch, rems):
        outs = [batch]
        for kind, payload in specs:
            if kind == "project":
                nxt = []
                for b in outs:
                    o = eval_exprs(payload, b)
                    o.rows_hint = b.rows_hint
                    nxt.append(o)
                outs = nxt
            elif kind == "filter":
                nxt = []
                for b in outs:
                    cond = as_device_column(payload.eval(b), b)
                    nxt.append(b.with_sel(cond.data & cond.validity))
                outs = nxt
            elif kind == "expand":
                nxt = []
                for b in outs:
                    for proj in payload:
                        o = eval_exprs(proj, b)
                        o.rows_hint = b.rows_hint
                        nxt.append(o)
                outs = nxt
            else:  # limit
                r = rems[payload]
                nxt = []
                for b in outs:
                    if r <= 0:
                        break
                    o, taken = _head(b, r)
                    r -= taken
                    nxt.append(o)
                rems[payload] = r
                outs = nxt
        return tuple(outs), tuple(rems)

    return fused


class FusedStageExec(Exec):
    """One fused device stage. ``ops`` are the member execs in execution
    order (ops[0] innermost, applied first); ``source`` feeds the stage
    and is also ops[0]'s (original) child."""

    def __init__(self, ops: Sequence[Exec], source: Exec):
        super().__init__(source)
        self.ops = list(ops)
        self._specs = _stage_specs(self.ops)
        from spark_rapids_tpu_torch.ops.basic import LocalLimitExec
        self._limits = [op.limit for op in self.ops
                        if isinstance(op, LocalLimitExec)]
        self._fused = _build_fused(self._specs)
        self._has_binds = has_bind_slots(_spec_exprs(self._specs))

    def __getstate__(self):
        # The fused closure is rebuilt from the specs: a plan shipped to
        # a cluster worker pickles without it.
        state = dict(self.__dict__)
        state.pop("_fused", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._fused = _build_fused(self._specs)

    @property
    def schema(self) -> Schema:
        return self.ops[-1].schema

    @property
    def name(self) -> str:
        inner = "->".join(type(o).__name__ for o in self.ops)
        return f"FusedStageExec[{inner}]"

    def execute_device(self, ctx: ExecContext, partition: int):
        m = ctx.metrics_for(self)
        m.values.setdefault("numFusedStages", 1)
        m.values.setdefault("numFusedOps", len(self.ops))
        rems = tuple(int(resolve_bound(n, ctx)) for n in self._limits)
        binds = None
        for batch in self.children[0].execute_device(ctx, partition):
            if rems and min(rems) <= 0:
                break           # a spent budget: no further rows
            if binds is None:
                binds = device_bind_args(ctx, batch.device) \
                    if self._has_binds else ()
            with timed(m):
                outs, rems = kc.call(self._fused, batch, rems, binds)
            for out in outs:
                record_batch(m, out)
                yield out

    def execute_host(self, ctx: ExecContext, partition: int):
        # The member chain is intact (fusion rewires only the stage's
        # source link), so the host engine runs the outermost member.
        yield from self.ops[-1].execute_host(ctx, partition)
