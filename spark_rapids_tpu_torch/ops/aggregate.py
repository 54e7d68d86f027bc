"""Hash aggregate (port of the JAX package's ``ops/aggregate.py``, cut to
Count, CountStar, Sum, Average, Min and Max in modes partial, final and
complete).

Device algorithm per batch, as in the JAX package:

  project grouping keys + aggregate inputs
  group_ids (fingerprint radix sort) + one gather to group-sorted order
  every sum-decomposable aggregate (Count, Sum, Average) exposes masked
  value streams; the streams of all specs stack per dtype class and ALL
  group sums come from one cumsum + boundary difference per class
  (``_segment_sums``)
  Min/Max reduce on their own ("raw" specs): ``kernels.segment_reduce``,
  whose min/max and integer sums are the sorted-segment reduce (kernel K2
  on the card), or, over strings, ``kernels.segment_minmax_string``
  -> buffer batch [keys..., buffers...] at the group leaders

Zero-key aggregates skip the sort: whole-batch masked reductions
(``_global_stage``), except a string Min/Max, which groups its single
group through the sorted path. First/Last and the partial-skip decision
come in a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, DeviceColumn, bucket_capacity, coalesce_iter,
    concat_batches, shrink_all, torch_dtype)
from spark_rapids_tpu_torch.columnar.rowmove import gather_rows
from spark_rapids_tpu_torch.exprs.base import (
    Expression, as_device_column, project_batch)
from spark_rapids_tpu_torch.ops import kernels
from spark_rapids_tpu_torch.ops.base import Exec, Schema, record_batch, timed


@dataclasses.dataclass
class SortedCol:
    """One column's tensors permuted to group-sorted order."""

    data: torch.Tensor
    validity: torch.Tensor
    lengths: Optional[torch.Tensor] = None   # strings only


Buf = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def _zeros_like_f64(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float64, device=t.device)


def _ones(capacity: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones((capacity,), dtype=torch.bool, device=like.device)


# ---------------------------------------------------------------------------
# Aggregate function descriptors
# ---------------------------------------------------------------------------

class AggFunction:
    """One aggregate: an input expression plus its buffer layout, and
    either the masked value streams the cumsum path sums per group or its
    own segmented update/merge."""

    def __init__(self, child: Optional[Expression]):
        self.child = child

    @property
    def buffer_types(self) -> Tuple[dt.DataType, ...]:
        raise NotImplementedError

    @property
    def result_type(self) -> dt.DataType:
        raise NotImplementedError

    def update(self, col: SortedCol, gid: torch.Tensor,
               capacity: int) -> List[Buf]:
        raise NotImplementedError

    def merge(self, bufs: List[SortedCol], gid: torch.Tensor,
              capacity: int) -> List[Buf]:
        raise NotImplementedError

    def finalize(self, bufs: List[SortedCol]) -> Buf:
        raise NotImplementedError

    # -- segmented-sum plan (cumsum path) --------------------------------
    # Streams are (dtype class, (cap,) tensor) pairs; ``has_nans`` mirrors
    # spark.rapids.sql.hasNans (float sums carry NaN/inf occurrence counts
    # out of band unless the user asserts finite data). None: not
    # sum-decomposable, the spec runs its own update/merge.
    def sum_terms_update(self, col: SortedCol,
                         has_nans: bool = True) -> Optional[List[Tuple]]:
        return None

    def sum_terms_merge(self, bufs: List[SortedCol],
                        has_nans: bool = True) -> Optional[List[Tuple]]:
        return None

    def bufs_from_sums(self, sums: List[torch.Tensor], capacity: int,
                       has_nans: bool = True) -> List[Buf]:
        raise NotImplementedError

    # -- global (zero-key) path ------------------------------------------
    # One value per buffer as (0-d data, 0-d valid, None).
    def update_global(self, col: SortedCol) -> List[Tuple]:
        raise NotImplementedError

    def merge_global(self, bufs: List[SortedCol]) -> List[Tuple]:
        raise NotImplementedError


class Count(AggFunction):
    """count(x): non-null count; see CountStar for count(*)."""

    @property
    def buffer_types(self):
        return (dt.INT64,)

    @property
    def result_type(self):
        return dt.INT64

    def finalize(self, bufs):
        b, = bufs
        return b.data, b.validity, None

    def sum_terms_update(self, col, has_nans=True):
        return [("i32", col.validity.to(torch.int32))]

    def sum_terms_merge(self, bufs, has_nans=True):
        b, = bufs
        return [("i64", torch.where(b.validity, b.data,
                                    torch.zeros_like(b.data)))]

    def bufs_from_sums(self, sums, capacity, has_nans=True):
        s, = sums
        return [(s.to(torch.int64), _ones(capacity, s), None)]

    def update_global(self, col):
        return [(col.validity.sum(dtype=torch.int64), True, None)]

    def merge_global(self, bufs):
        b, = bufs
        return [(torch.where(b.validity, b.data,
                             torch.zeros_like(b.data)).sum(), True, None)]


class CountStar(Count):
    pass


def _sum_result_type(t: dt.DataType) -> dt.DataType:
    return dt.FLOAT64 if t.is_floating else dt.INT64


def _reapply_nonfinite(s, nan_cnt, pinf_cnt, ninf_cnt):
    """IEEE sum semantics from a finite-only sum plus per-group NaN/+-inf
    occurrence counts."""
    bad = (nan_cnt > 0) | ((pinf_cnt > 0) & (ninf_cnt > 0))
    inf = torch.full((), float("inf"), dtype=torch.float64, device=s.device)
    s = torch.where(pinf_cnt > 0, inf, s)
    s = torch.where(ninf_cnt > 0, -inf, s)
    return torch.where(bad, torch.full((), float("nan"), dtype=torch.float64,
                                       device=s.device), s)


def _f64_nonfinite_terms(v: torch.Tensor) -> List[Tuple]:
    return [("i32", torch.isnan(v).to(torch.int32)),
            ("i32", (v == float("inf")).to(torch.int32)),
            ("i32", (v == float("-inf")).to(torch.int32))]


class Sum(AggFunction):
    @property
    def buffer_types(self):
        return (_sum_result_type(self.child.data_type()),)

    @property
    def result_type(self):
        return _sum_result_type(self.child.data_type())

    def finalize(self, bufs):
        b, = bufs
        return b.data, b.validity, None

    @property
    def _cls(self) -> str:
        return "f64" if self.result_type.is_floating else "i64"

    def _terms(self, data, validity, has_nans):
        """Masked value stream + count; float streams also carry NaN/inf
        occurrence counts, or one group's NaN would poison every later
        group's prefix-difference sum."""
        t = torch_dtype(self.result_type)
        v = torch.where(validity, data.to(t),
                        torch.zeros((), dtype=t, device=data.device))
        cnt = ("i32", validity.to(torch.int32))
        if self._cls != "f64":
            return [("i64", v), cnt]
        if not has_nans:
            return [("f64", v), cnt]
        clean = torch.where(torch.isfinite(v), v, _zeros_like_f64(v))
        return [("f64", clean), cnt] + _f64_nonfinite_terms(v)

    def sum_terms_update(self, col, has_nans=True):
        return self._terms(col.data, col.validity, has_nans)

    def sum_terms_merge(self, bufs, has_nans=True):
        b, = bufs
        return self._terms(b.data, b.validity, has_nans)

    def bufs_from_sums(self, sums, capacity, has_nans=True):
        if self._cls != "f64" or not has_nans:
            s, c = sums
            return [(s, c > 0, None)]
        s, c, nan, pinf, ninf = sums
        return [(_reapply_nonfinite(s, nan, pinf, ninf), c > 0, None)]

    def _global(self, data, validity):
        t = torch_dtype(self.result_type)
        v = torch.where(validity, data.to(t),
                        torch.zeros((), dtype=t, device=data.device))
        return [(v.sum(), validity.sum(dtype=torch.int32) > 0, None)]

    def update_global(self, col):
        return self._global(col.data, col.validity)

    def merge_global(self, bufs):
        return self._global(bufs[0].data, bufs[0].validity)


class Average(AggFunction):
    """avg: partial buffer = (sum double, count long); result double."""

    @property
    def buffer_types(self):
        return (dt.FLOAT64, dt.INT64)

    @property
    def result_type(self):
        return dt.FLOAT64

    def finalize(self, bufs):
        sb, cb = bufs
        safe = torch.where(cb.data > 0, cb.data, torch.ones_like(cb.data))
        return sb.data / safe.to(torch.float64), cb.data > 0, None

    @staticmethod
    def _f64_terms(v, has_nans):
        if not has_nans:
            return [("f64", v)]
        return [("f64", torch.where(torch.isfinite(v), v,
                                    _zeros_like_f64(v)))] + \
            _f64_nonfinite_terms(v)

    def sum_terms_update(self, col, has_nans=True):
        masked = torch.where(col.validity, col.data.to(torch.float64),
                             _zeros_like_f64(col.data))
        return self._f64_terms(masked, has_nans) + \
            [("i32", col.validity.to(torch.int32))]

    def sum_terms_merge(self, bufs, has_nans=True):
        sb, cb = bufs
        return self._f64_terms(torch.where(sb.validity, sb.data,
                                           _zeros_like_f64(sb.data)),
                               has_nans) + \
            [("i64", torch.where(cb.validity, cb.data,
                                 torch.zeros_like(cb.data)))]

    def bufs_from_sums(self, sums, capacity, has_nans=True):
        if has_nans:
            s, nan, pinf, ninf, c = sums
            s = _reapply_nonfinite(s, nan, pinf, ninf)
        else:
            s, c = sums
        c = c.to(torch.int64)
        return [(s, c > 0, None), (c, _ones(capacity, c), None)]

    def update_global(self, col):
        s = torch.where(col.validity, col.data.to(torch.float64),
                        _zeros_like_f64(col.data)).sum()
        c = col.validity.sum(dtype=torch.int64)
        return [(s, c > 0, None), (c, True, None)]

    def merge_global(self, bufs):
        sb, cb = bufs
        s = torch.where(sb.validity, sb.data, _zeros_like_f64(sb.data)).sum()
        c = torch.where(cb.validity, cb.data, torch.zeros_like(cb.data)).sum()
        return [(s, c > 0, None), (c, True, None)]


class Min(AggFunction):
    """min(x); Max below is its mirror. Numeric buffers reduce through
    ``kernels.segment_reduce`` (NaN greatest, -0.0 below 0.0, subnormals
    kept), strings through ``kernels.segment_minmax_string``."""

    kind = "min"

    @property
    def buffer_types(self):
        return (self.child.data_type(),)

    @property
    def result_type(self):
        return self.child.data_type()

    def update(self, col, gid, capacity):
        if col.lengths is not None:
            return [kernels.segment_minmax_string(
                col.data, col.lengths, col.validity, gid, capacity,
                want_max=self.kind == "max")]
        agg, counts = kernels.segment_reduce(col.data, col.validity, gid,
                                             capacity, self.kind)
        return [(agg, counts > 0, None)]

    def merge(self, bufs, gid, capacity):
        return self.update(bufs[0], gid, capacity)

    def finalize(self, bufs):
        b, = bufs
        return b.data, b.validity, b.lengths

    def _global(self, col: SortedCol) -> List[Tuple]:
        """Whole-batch min/max in ``_seg_minmax``'s order, with Spark's NaN
        rules as in ``kernels.segment_reduce``."""
        v, val = col.data, col.validity
        isnan = torch.isnan(v) if v.is_floating_point() else None
        real = val if isnan is None else val & ~isnan
        m = kernels.global_minmax(
            torch.where(real, v, kernels._identity_for(v, self.kind)),
            self.kind)
        if isnan is not None:
            nanv = torch.full((), float("nan"), dtype=v.dtype,
                              device=v.device)
            m = torch.where(real.any(), m, nanv) if self.kind == "min" \
                else torch.where((val & isnan).any(), nanv, m)
        return [(m, val.any(), None)]

    def update_global(self, col):
        return self._global(col)

    def merge_global(self, bufs):
        return self._global(bufs[0])


class Max(Min):
    kind = "max"


@dataclasses.dataclass
class AggSpec:
    """A named aggregate in the output (result column)."""

    name: str
    fn: AggFunction


# ---------------------------------------------------------------------------
# The exec
# ---------------------------------------------------------------------------

class HashAggregateExec(Exec):
    """Groupby aggregate. ``mode``:
    - 'partial': emits [keys..., buffers...] for a downstream exchange
    - 'final': consumes partial buffers, emits finalized results
    - 'complete': update+merge+finalize in one node
    """

    _has_nans = True      # set from conf.hasNans in execute_device
    # Max batches concatenated per merge step (bounds a consolidation's
    # transient device memory).
    _CONSOLIDATE_CHUNK = 12

    def __init__(self, child: Exec,
                 group_by: Sequence[Tuple[str, Expression]],
                 aggregates: Sequence[AggSpec],
                 mode: str = "complete"):
        super().__init__(child)
        assert mode in ("partial", "final", "complete"), mode
        self.group_names = tuple(n for n, _ in group_by)
        self.group_exprs = [e for _, e in group_by]
        self.aggs = list(aggregates)
        self.mode = mode

    # -- schemas -------------------------------------------------------------
    @property
    def buffer_schema(self) -> Schema:
        cols: List[Tuple[str, dt.DataType]] = [
            (n, e.data_type()) for n, e in zip(self.group_names,
                                                self.group_exprs)]
        for spec in self.aggs:
            for bi, bt in enumerate(spec.fn.buffer_types):
                cols.append((f"{spec.name}#buf{bi}", bt))
        return tuple(cols)

    @property
    def schema(self) -> Schema:
        if self.mode == "partial":
            return self.buffer_schema
        cols = [(n, e.data_type())
                for n, e in zip(self.group_names, self.group_exprs)]
        cols += [(s.name, s.fn.result_type) for s in self.aggs]
        return tuple(cols)

    @property
    def _nkeys(self) -> int:
        return len(self.group_exprs)

    # -- device path ---------------------------------------------------------
    def _project_inputs(self, batch: DeviceBatch
                        ) -> Tuple[DeviceBatch, List[Optional[int]]]:
        """[keys..., agg inputs...] working batch + per-agg input ordinal."""
        cols = [as_device_column(e.eval(batch), batch)
                for e in self.group_exprs]
        ords: List[Optional[int]] = []
        for spec in self.aggs:
            if spec.fn.child is None:   # count(*)
                ords.append(None)
            else:
                cols.append(as_device_column(spec.fn.child.eval(batch),
                                             batch))
                ords.append(len(cols) - 1)
        return project_batch(cols, batch), ords

    @staticmethod
    def _buf_column(buf: Buf, bt: dt.DataType,
                    gmask: torch.Tensor) -> DeviceColumn:
        data, valid, lens = buf
        valid = valid & gmask
        if bt.is_string:
            data = torch.where(valid[:, None], data.to(torch.uint8),
                               torch.zeros((), dtype=torch.uint8,
                                           device=valid.device))
            lens = torch.where(valid, lens, torch.zeros_like(lens))
            return DeviceColumn(bt, data, valid, lens)
        t = torch_dtype(bt)
        data = torch.where(valid, data.to(t),
                           torch.zeros((), dtype=t, device=valid.device))
        return DeviceColumn(bt, data, valid)

    def _group_sorted(self, work: DeviceBatch):
        """Group, then ONE gather of the whole batch to group-sorted
        order."""
        g = kernels.group_ids(work, range(self._nkeys))
        live = work.live_count()
        sorted_b = gather_rows(work, g.perm, live)
        slive = torch.arange(work.capacity, dtype=torch.int32,
                             device=live.device) < live
        return g, sorted_b, slive

    @staticmethod
    def _segment_sums(stacks: Dict[str, List[torch.Tensor]],
                      gid: torch.Tensor, slive: torch.Tensor,
                      capacity: int) -> Dict[str, torch.Tensor]:
        """ALL group sums with one cumsum + boundary shift-difference per
        dtype class. Values arrive pre-masked (dead/null rows add 0).
        Groups are contiguous ascending runs of ``gid`` in sorted order,
        so group g's sum = prefix(end_g) - prefix(end_{g-1}).

        The streams stack as rows of a (k, capacity) matrix and scan along
        the inner dimension: torch's CUDA scan over the OUTER dimension of
        a (capacity, k) matrix parallelizes over the k columns only, and
        took 97.5% of q1's device time that way."""
        dev = gid.device
        idx = torch.arange(capacity, dtype=torch.int64, device=dev)
        nxt_gid = torch.cat([gid[1:], gid[-1:]])
        nxt_live = torch.cat([slive[1:],
                              torch.zeros(1, dtype=torch.bool, device=dev)])
        last = slive & ((idx == capacity - 1) | (nxt_gid != gid)
                        | ~nxt_live)
        ends = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
        ends[torch.where(last, gid, torch.full((), capacity,
                                               dtype=torch.int64,
                                               device=dev))] = idx
        ends = ends[:capacity]
        out = {}
        for cls, arrs in stacks.items():
            m = torch.stack(arrs, dim=0)
            if cls == "i32":
                m = m.to(torch.int64)
            s = torch.cumsum(m, dim=1)
            se = s.index_select(1, ends)
            out[cls] = torch.cat([se[:, :1], se[:, 1:] - se[:, :-1]], dim=1)
        return out

    def _run_specs(self, spec_inputs, gid, slive, capacity,
                   has_nans: bool = True) -> List[List[Buf]]:
        """``spec_inputs`` holds per spec ("update", SortedCol) or
        ("merge", [SortedCol...]). Sum-decomposable specs stack their
        streams per dtype class, one cumsum each; the rest ("raw") run
        their own segmented update/merge. Returns the buffer list per
        spec."""
        stacks: Dict[str, List[torch.Tensor]] = {}
        plans = []      # per spec: ("sum", [(cls, pos)...]) | ("raw", bufs)
        for spec, (kind, arg) in zip(self.aggs, spec_inputs):
            terms = spec.fn.sum_terms_update(arg, has_nans) \
                if kind == "update" \
                else spec.fn.sum_terms_merge(arg, has_nans)
            if terms is None:
                bufs = spec.fn.update(arg, gid, capacity) \
                    if kind == "update" else spec.fn.merge(arg, gid, capacity)
                plans.append(("raw", bufs))
                continue
            slots = []
            for cls, values in terms:
                stacks.setdefault(cls, []).append(values)
                slots.append((cls, len(stacks[cls]) - 1))
            plans.append(("sum", slots))
        sums = self._segment_sums(stacks, gid, slive, capacity) \
            if stacks else {}
        return [spec.fn.bufs_from_sums([sums[cls][pos] for cls, pos in plan],
                                       capacity, has_nans)
                if how == "sum" else plan
                for spec, (how, plan) in zip(self.aggs, plans)]

    def _assemble(self, work: DeviceBatch, g, all_bufs) -> DeviceBatch:
        """Key columns at the group leaders + buffer columns."""
        cap = work.capacity
        gmask = torch.arange(cap, dtype=torch.int32,
                             device=g.perm.device) < g.num_groups
        out_cols: List[DeviceColumn] = []
        if self._nkeys:
            keys = gather_rows(work.select(range(self._nkeys)),
                               g.group_leader, g.num_groups)
            out_cols.extend(keys.columns)
        for spec, bufs in zip(self.aggs, all_bufs):
            for buf, bt in zip(bufs, spec.fn.buffer_types):
                out_cols.append(self._buf_column(buf, bt, gmask))
        return DeviceBatch(tuple(out_cols), g.num_groups)

    @staticmethod
    def _sorted_view(sorted_b: DeviceBatch, ord_: int) -> SortedCol:
        c = sorted_b.columns[ord_]
        return SortedCol(c.data, c.validity, c.lengths)

    def _update_batch(self, batch: DeviceBatch, offset=0) -> DeviceBatch:
        """One input batch -> partial buffer batch. ``offset`` (the
        arrival index of row 0, which orders First/Last in the JAX
        package) is unused by the aggregates ported so far."""
        work, ords = self._project_inputs(batch)
        if self._global_ok:
            return self._global_stage(work, ords, update=True)
        cap = work.capacity
        g, sorted_b, slive = self._group_sorted(work)
        inputs = []
        for ord_ in ords:
            if ord_ is None:
                inputs.append(("update", SortedCol(
                    torch.zeros(cap, dtype=torch.int64, device=slive.device),
                    slive)))
            else:
                inputs.append(("update", self._sorted_view(sorted_b, ord_)))
        bufs = self._run_specs(inputs, g.group_of_sorted, slive, cap,
                               self._has_nans)
        return self._assemble(work, g, bufs)

    def _merge_batch(self, batch: DeviceBatch) -> DeviceBatch:
        """Merge a buffer batch (re-group by keys, merge buffers)."""
        if self._global_ok:
            return self._global_stage(batch, None, update=False)
        cap = batch.capacity
        g, sorted_b, slive = self._group_sorted(batch)
        ci = self._nkeys
        inputs = []
        for spec in self.aggs:
            nbuf = len(spec.fn.buffer_types)
            inputs.append(("merge", [self._sorted_view(sorted_b, ci + b)
                                     for b in range(nbuf)]))
            ci += nbuf
        bufs = self._run_specs(inputs, g.group_of_sorted, slive, cap,
                               self._has_nans)
        return self._assemble(batch, g, bufs)

    # -- zero-key path --------------------------------------------------------
    @property
    def _global_ok(self) -> bool:
        """Zero grouping keys and every function reduces a whole batch
        with masked reductions; a string Min/Max takes the sorted path."""
        return self._nkeys == 0 and not any(
            isinstance(s.fn, Min) and s.fn.child.data_type().is_string
            for s in self.aggs)

    def _global_stage(self, work: DeviceBatch, ords,
                      update: bool) -> DeviceBatch:
        live = work.row_mask()
        all_bufs = []
        if update:
            for spec, ord_ in zip(self.aggs, ords):
                if ord_ is None:
                    col = SortedCol(torch.zeros(work.capacity,
                                                dtype=torch.int64,
                                                device=live.device), live)
                else:
                    c = work.columns[ord_]
                    col = SortedCol(c.data, c.validity & live, c.lengths)
                all_bufs.append(spec.fn.update_global(col))
        else:
            ci = self._nkeys
            for spec in self.aggs:
                nbuf = len(spec.fn.buffer_types)
                bufs = [SortedCol(work.columns[ci + b].data,
                                  work.columns[ci + b].validity & live)
                        for b in range(nbuf)]
                ci += nbuf
                all_bufs.append(spec.fn.merge_global(bufs))
        return self._global_assemble(all_bufs, live.device)

    def _global_assemble(self, all_bufs, device) -> DeviceBatch:
        cap = 8
        first = torch.arange(cap, dtype=torch.int32, device=device) < 1
        out_cols: List[DeviceColumn] = []
        for spec, bufs in zip(self.aggs, all_bufs):
            for (val, ok, _), bt in zip(bufs, spec.fn.buffer_types):
                valid = first & torch.as_tensor(ok, dtype=torch.bool,
                                                device=device)
                data = torch.zeros(cap, dtype=torch_dtype(bt), device=device)
                data[0] = torch.as_tensor(val, device=device) \
                    .to(torch_dtype(bt))
                out_cols.append(self._buf_column((data, valid, None), bt,
                                                 first))
        return DeviceBatch(tuple(out_cols),
                           torch.ones((), dtype=torch.int32, device=device))

    def _finalize_batch(self, batch: DeviceBatch) -> DeviceBatch:
        out_cols = list(batch.columns[:self._nkeys])
        ci = self._nkeys
        gmask = batch.row_mask()
        for spec in self.aggs:
            nbuf = len(spec.fn.buffer_types)
            bufs = [SortedCol(batch.columns[ci + b].data,
                              batch.columns[ci + b].validity,
                              batch.columns[ci + b].lengths)
                    for b in range(nbuf)]
            out_cols.append(self._buf_column(spec.fn.finalize(bufs),
                                             spec.fn.result_type, gmask))
            ci += nbuf
        return DeviceBatch(tuple(out_cols), batch.num_rows)

    def _empty_result(self, device) -> DeviceBatch:
        """Zero-key aggregate over no input: one row, counts 0, rest null."""
        cap = 8
        cols = []
        for spec in self.aggs:
            col = DeviceColumn.full_null(spec.fn.result_type, cap,
                                         device=device)
            if isinstance(spec.fn, Count):
                col.validity[0] = True
            cols.append(col)
        return DeviceBatch(tuple(cols),
                           torch.ones((), dtype=torch.int32, device=device))

    def _consolidate(self, pending: List[DeviceBatch],
                     final_stage: bool = False) -> DeviceBatch:
        """Chunked tree of shrink + concat + merge over the pending list;
        one batched row-count pull per level."""
        first_stage = self._merge_batch if self.mode == "final" else None
        level = 0
        batches = pending
        while True:
            batches, _ = shrink_all(batches)
            if len(batches) == 1:
                single = batches[0]
                if level == 0 and first_stage is not None:
                    single = first_stage(single)
                break
            stage = first_stage if (level == 0 and first_stage is not None) \
                else self._merge_batch
            nxt = []
            for i in range(0, len(batches), self._CONSOLIDATE_CHUNK):
                grp = batches[i:i + self._CONSOLIDATE_CHUNK]
                if len(grp) == 1:
                    nxt.append(stage(grp[0]) if level == 0 else grp[0])
                    continue
                cap = bucket_capacity(sum(b.capacity for b in grp))
                nxt.append(stage(concat_batches(grp, cap)))
            batches = nxt
            level += 1
            if len(batches) == 1:
                single = batches[0]
                break
        if final_stage and self.mode in ("final", "complete"):
            single = self._finalize_batch(single)
        return single

    def execute_device(self, ctx, partition):
        from spark_rapids_tpu_torch import config as C
        m = ctx.metrics_for(self)
        self._has_nans = bool(ctx.conf.get(C.HAS_NANS))
        pending: List[DeviceBatch] = []
        update_stage = self.mode in ("partial", "complete")
        child_iter = self.children[0].execute_device(ctx, partition)
        if update_stage and not self._global_ok:
            # Coalesce (and compact) the input: one sort-based update over
            # a large batch beats several over small ones, and a filtered
            # batch compacts before the capacity-scaled sort.
            child_iter = coalesce_iter(
                child_iter, int(ctx.conf.get(C.BATCH_SIZE_ROWS)),
                int(ctx.conf.get(C.BATCH_SIZE_BYTES)))
        for batch in child_iter:
            if update_stage:
                with timed(m):
                    partial = self._update_batch(batch)
                if self.mode == "partial":
                    record_batch(m, partial)
                    yield partial
                    continue
                pending.append(partial)
            else:
                pending.append(batch)
        if self.mode == "partial":
            return
        if not pending:
            if self._nkeys == 0:
                yield self._empty_result(self.plan_device())
            return
        with timed(m):
            acc = self._consolidate(pending, final_stage=True)
        record_batch(m, acc)
        yield acc
