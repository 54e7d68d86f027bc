"""Hash aggregate (port of the JAX package's ``ops/aggregate.py``, cut to
Count, CountStar, Sum, Average, Min, Max, First and Last in modes partial,
final, complete, merge and mixed_final).

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
(``_global_stage``), except a string Min/Max and the mixed_final stage,
which group their single group through the sorted path. Each batch's
update and the final consolidation are OOM retry sites
(``memory/oom.py``); an update whose OOM the ladder leaves unmet splits
its batch (``split_on_oom``: a partial a half). The input coalesces
toward ``effective_batch_target``.

The adaptive partial skip (``spark.rapids.sql.agg.skipAggPassReductionRatio``,
default 0.85): a keyed partial stage whose every function has
``update_row`` reads its first batch's groups and live rows in one sync;
when groups reach the ratio of the rows, the decision (kept as
``aggskip:<id>`` in the context, counted as ``partialSkip``) sends every
later batch of the query through ``_passthrough_batch``, which projects
each row into the buffer layout without a sort, and the final stage
groups once. The planner keeps the partial pass of a grouping-set plan
(``allow_partial_skip``).

First/Last pick by arrival: their buffers are (value, arrival index). The
update stage numbers each row of a partition's stream (the batch's
offset, the capacities of the partition's earlier batches, plus its row
in the batch) and each group keeps the least (First) or greatest (Last)
eligible index; the stable fingerprint sort keeps arrival order inside a
group, so that is the group's first (last) sorted position, which one
``kernels.segment_reduce`` over the positions finds (K2 on the card, as
for Min/Max). Merging buffers keeps the least (greatest) index, ties to
the earliest buffer row, two more segment reduces. The picks stay right
through concatenation, merge and mixed_final because indexes never
depend on batch boundaries after the update.

DISTINCT aggregates run as three execs (the planner's
``_convert_distinct_aggregate``): a partial keyed by (keys..., x), a
'merge' keyed by (keys..., x), which is 'final' without the result
projection and leaves (keys, x) unique, and a 'mixed_final' keyed by the
keys over the layout [keys..., x, other buffers...], whose DISTINCT
specs (``AggSpec.distinct``) UPDATE over x while the others MERGE their
buffers (``_mixed_batch``). The mixed stage reads the raw x column, which
its own output no longer has, so it runs once, as the first stage of the
consolidation; later levels are plain merges.

Host algorithm (``execute_host``, numpy over the partition's host
batches, as in the JAX package's host engine): one stable lexsort over
each key's ``encode_key_concat`` codes segments the groups, and every
aggregate reduces its segments with one ``reduceat``
(``_host_seg_agg``); groups come out in first-seen order. A string
Min/Max or an empty input takes the python-row path instead
(``host_update`` / ``host_merge`` / ``host_finalize`` per group), as the
reference does; its integer sums wrap as int64, its float sums are
``np.sum``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, DeviceColumn, bucket_capacity, coalesce_iter,
    concat_batches, shrink_all, torch_dtype)
from spark_rapids_tpu_torch.columnar.host import (
    HostBatch, HostColumn, concat_host_batches, encode_key_concat,
    stable_code_argsort)
from spark_rapids_tpu_torch.columnar.rowmove import gather_rows
from spark_rapids_tpu_torch.exprs.base import (
    Expression, as_device_column, as_host_column, project_batch)
from spark_rapids_tpu_torch.memory.oom import (
    effective_batch_target, split_on_oom)
from spark_rapids_tpu_torch.ops import kernel_cache as kc
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
    own segmented update/merge. The planner marks a DISTINCT one
    (``is_distinct``, with ``distinct_key`` the structural key of its
    unresolved input)."""

    is_distinct = False
    distinct_key = None

    def __init__(self, child: Optional[Expression]):
        self.child = child

    @property
    def buffer_types(self) -> Tuple[dt.DataType, ...]:
        raise NotImplementedError

    @property
    def result_type(self) -> dt.DataType:
        raise NotImplementedError

    def update(self, col: SortedCol, gid: torch.Tensor, capacity: int,
               row_index: Optional[torch.Tensor] = None) -> List[Buf]:
        """``row_index``: each sorted row's arrival index (First/Last)."""
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
    # One value per buffer as (0-d data, 0-d valid, None). ``row_index``
    # and ``live`` (each row's arrival index, the batch's live rows) serve
    # First/Last.
    def update_global(self, col: SortedCol, row_index=None,
                      live=None) -> List[Tuple]:
        raise NotImplementedError

    def merge_global(self, bufs: List[SortedCol]) -> List[Tuple]:
        raise NotImplementedError

    # -- partial-skip passthrough ----------------------------------------
    # Each input ROW becomes its own one-row group buffer: an elementwise
    # projection into the buffer layout, for a partial stage whose first
    # batch barely reduced (skipAggPassReductionRatio); grouping then
    # happens once, after the exchange. None: not supported.
    def update_row(self, col: SortedCol,
                   row_index: torch.Tensor) -> Optional[List[Buf]]:
        return None

    # -- host python-row path ---------------------------------------------
    def host_update(self, values: list) -> tuple:
        """A group's python values (None = null) -> buffer value tuple."""
        raise NotImplementedError

    def host_merge(self, buf_tuples: List[tuple]) -> tuple:
        raise NotImplementedError

    def host_finalize(self, buf: tuple):
        raise NotImplementedError

    def host_agg(self, values: list):
        return self.host_finalize(self.host_merge([self.host_update(values)]))


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

    def update_global(self, col, row_index=None, live=None):
        return [(col.validity.sum(dtype=torch.int64), True, None)]

    def merge_global(self, bufs):
        b, = bufs
        return [(torch.where(b.validity, b.data,
                             torch.zeros_like(b.data)).sum(), True, None)]

    def update_row(self, col, row_index):
        return [(col.validity.to(torch.int64),
                 torch.ones_like(col.validity), None)]

    def host_update(self, values):
        return (sum(1 for v in values if v is not None),)

    def host_merge(self, buf_tuples):
        return (sum(b[0] for b in buf_tuples if b[0] is not None),)

    def host_finalize(self, buf):
        return buf[0]


class CountStar(Count):
    def update_row(self, col, row_index):
        ones = torch.ones_like(col.validity)
        return [(ones.to(torch.int64), ones, None)]

    def host_update(self, values):
        return (len(values),)


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

    def update_global(self, col, row_index=None, live=None):
        return self._global(col.data, col.validity)

    def merge_global(self, bufs):
        return self._global(bufs[0].data, bufs[0].validity)

    def update_row(self, col, row_index):
        return [(col.data.to(torch_dtype(self.result_type)), col.validity,
                 None)]

    def host_update(self, values):
        vs = [v for v in values if v is not None]
        if not vs:
            return (None,)
        if self.result_type.is_floating:
            return (float(np.sum(np.asarray(vs, np.float64))),)
        acc = np.int64(0)
        with np.errstate(over="ignore"):
            for v in vs:
                acc = np.int64(acc + np.int64(v))   # JVM wrap
        return (int(acc),)

    def host_merge(self, buf_tuples):
        return self.host_update([b[0] for b in buf_tuples])

    def host_finalize(self, buf):
        return buf[0]


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

    def update_global(self, col, row_index=None, live=None):
        s = torch.where(col.validity, col.data.to(torch.float64),
                        _zeros_like_f64(col.data)).sum()
        c = col.validity.sum(dtype=torch.int64)
        return [(s, c > 0, None), (c, True, None)]

    def merge_global(self, bufs):
        sb, cb = bufs
        s = torch.where(sb.validity, sb.data, _zeros_like_f64(sb.data)).sum()
        c = torch.where(cb.validity, cb.data, torch.zeros_like(cb.data)).sum()
        return [(s, c > 0, None), (c, True, None)]

    def update_row(self, col, row_index):
        return [(col.data.to(torch.float64), col.validity, None),
                (col.validity.to(torch.int64),
                 torch.ones_like(col.validity), None)]

    def host_update(self, values):
        vs = [v for v in values if v is not None]
        if not vs:
            return (None, 0)
        return (float(np.sum(np.asarray(vs, np.float64))), len(vs))

    def host_merge(self, buf_tuples):
        s = [b[0] for b in buf_tuples if b[0] is not None]
        c = sum(b[1] for b in buf_tuples)
        return (float(np.sum(s)) if s else None, c)

    def host_finalize(self, buf):
        s, c = buf
        return None if c == 0 else s / c


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

    def update(self, col, gid, capacity, row_index=None):
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

    def update_global(self, col, row_index=None, live=None):
        return self._global(col)

    def merge_global(self, bufs):
        return self._global(bufs[0])

    def update_row(self, col, row_index):
        return [(col.data, col.validity, col.lengths)]

    def host_update(self, values):
        vs = [v for v in values if v is not None]
        if not vs:
            return (None,)
        if self.child.data_type().is_floating:
            non_nan = [v for v in vs if not np.isnan(v)]
            if self.kind == "min":
                return (min(non_nan) if non_nan else float("nan"),)
            return (float("nan") if len(non_nan) < len(vs)
                    else max(vs),)
        return (min(vs) if self.kind == "min" else max(vs),)

    def host_merge(self, buf_tuples):
        return self.host_update([b[0] for b in buf_tuples])

    def host_finalize(self, buf):
        return buf[0]


class Max(Min):
    kind = "max"


_NO_FIRST = 2 ** 62     # the index buffer of a First with no pick yet


class First(AggFunction):
    """first(x[, ignoreNulls]): the value of the group's earliest row in
    arrival order within the partition stream (Last: the latest), NULL
    rows skipped unless ``ignore_nulls`` is off; after an exchange the
    order is the order buffers arrive in, as in Spark."""

    pick = "min"

    def __init__(self, child, ignore_nulls: bool = True):
        super().__init__(child)
        self.ignore_nulls = ignore_nulls

    @property
    def buffer_types(self):
        return (self.child.data_type(), dt.INT64)

    @property
    def result_type(self):
        return self.child.data_type()

    @property
    def _bad(self) -> int:
        return _NO_FIRST if self.pick == "min" else -1

    @staticmethod
    def _gather(col: SortedCol, pos: torch.Tensor, ok: torch.Tensor) -> Buf:
        safe = pos.clamp(0, pos.shape[0] - 1)
        val = col.data.index_select(0, safe)
        vval = col.validity.index_select(0, safe) & ok
        if col.lengths is not None:
            lens = torch.where(vval, col.lengths.index_select(0, safe),
                               torch.zeros((), dtype=col.lengths.dtype,
                                           device=ok.device))
            return torch.where(vval[:, None], val,
                               torch.zeros((), dtype=val.dtype,
                                           device=ok.device)), vval, lens
        return torch.where(vval, val, torch.zeros((), dtype=val.dtype,
                                                  device=ok.device)), \
            vval, None

    def update(self, col, gid, capacity, row_index=None):
        pos = torch.arange(capacity, dtype=torch.int64, device=gid.device)
        eligible = col.validity if self.ignore_nulls \
            else torch.ones_like(col.validity)
        # Arrival order within a group is sorted order (stable sort), so
        # the least / greatest eligible position carries the pick (K2).
        picked, counts = kernels.segment_reduce(pos, eligible, gid,
                                                capacity, self.pick)
        ok = counts > 0
        val, vval, lens = self._gather(col, picked, ok)
        idx = pos if row_index is None else row_index
        gidx = idx.index_select(0, picked.clamp(0, capacity - 1))
        bad = torch.full((), self._bad, dtype=torch.int64, device=ok.device)
        return [(val, vval, lens), (torch.where(ok, gidx, bad), ok, None)]

    def merge(self, bufs, gid, capacity):
        vcol, icol = bufs
        bad = torch.full((), self._bad, dtype=torch.int64,
                         device=gid.device)
        keyed = torch.where(icol.validity, icol.data, bad)
        best, _ = kernels.segment_reduce(keyed, icol.validity, gid,
                                         capacity, self.pick)
        # The winner holds the best index; ties go to the earliest row.
        row = torch.arange(capacity, dtype=torch.int64, device=gid.device)
        winner = icol.validity & (keyed == best.index_select(0, gid))
        first_row, counts = kernels.segment_reduce(row, winner, gid,
                                                   capacity, "min")
        ok = counts > 0
        val, vval, lens = self._gather(vcol, first_row, ok)
        iv = icol.data.index_select(0, first_row.clamp(0, capacity - 1))
        return [(val, vval, lens), (torch.where(ok, iv, bad), ok, None)]

    def finalize(self, bufs):
        vcol, _ = bufs
        return vcol.data, vcol.validity, vcol.lengths

    def update_global(self, col, row_index=None, live=None):
        cap = col.validity.shape[0]
        pos = torch.arange(cap, dtype=torch.int64, device=col.data.device)
        # With ignore_nulls off a NULL row still wins; dead rows never do.
        eligible = col.validity if self.ignore_nulls else \
            (live if live is not None else torch.ones_like(col.validity))
        if self.pick == "min":
            picked = torch.where(eligible, pos, torch.full_like(pos, cap)) \
                .min()
            ok = picked < cap
        else:
            picked = torch.where(eligible, pos, torch.full_like(pos, -1)) \
                .max()
            ok = picked >= 0
        safe = picked.clamp(0, cap - 1)
        gidx = picked if row_index is None else row_index[safe]
        return [(col.data[safe], ok & col.validity[safe], None),
                (torch.where(ok, gidx, torch.full_like(gidx, self._bad)),
                 ok, None)]

    def update_row(self, col, row_index):
        eligible = col.validity if self.ignore_nulls \
            else torch.ones_like(col.validity)
        idx = torch.where(eligible, row_index.to(torch.int64),
                          torch.full((), self._bad, dtype=torch.int64,
                                     device=eligible.device))
        return [(col.data, col.validity, col.lengths),
                (idx, eligible, None)]

    def merge_global(self, bufs):
        vcol, icol = bufs
        cap = icol.validity.shape[0]
        bad = torch.full((), self._bad, dtype=torch.int64,
                         device=icol.data.device)
        keyed = torch.where(icol.validity, icol.data, bad)
        best = keyed.min() if self.pick == "min" else keyed.max()
        pos = torch.arange(cap, dtype=torch.int64, device=keyed.device)
        row = torch.where(icol.validity & (keyed == best), pos,
                          torch.full_like(pos, cap)).min()
        ok = (row < cap) & (best != bad)
        safe = row.clamp(0, cap - 1)
        return [(vcol.data[safe], ok & vcol.validity[safe], None),
                (torch.where(ok, icol.data[safe], bad), ok, None)]

    def host_update(self, values):
        seq = [(i, v) for i, v in enumerate(values)
               if not (self.ignore_nulls and v is None)]
        if not seq:
            return (None, None)
        i, v = seq[0] if self.pick == "min" else seq[-1]
        return (v, i)

    def host_merge(self, buf_tuples):
        cands = [b for b in buf_tuples if b[1] is not None]
        if not cands:
            return (None, None)
        pickf = min if self.pick == "min" else max
        return pickf(cands, key=lambda b: b[1])

    def host_finalize(self, buf):
        return buf[0]


class Last(First):
    pick = "max"


@dataclasses.dataclass
class AggSpec:
    """A named aggregate in the output (result column). ``distinct`` is
    read by the mixed_final mode: the function runs UPDATE over the
    deduplicated distinct input instead of MERGE over partial buffers."""

    name: str
    fn: AggFunction
    distinct: bool = False


# ---------------------------------------------------------------------------
# The exec
# ---------------------------------------------------------------------------

class HashAggregateExec(Exec):
    """Groupby aggregate. ``mode``:
    - 'partial': emits [keys..., buffers...] for a downstream exchange
    - 'final': consumes partial buffers, emits finalized results
    - 'complete': update+merge+finalize in one node
    - 'merge': 'final' without the result projection (emits buffers)
    - 'mixed_final': the DISTINCT stage over [keys..., x, buffers...]:
      distinct specs update over x, the others merge their buffers
    """

    _has_nans = True      # set from conf.hasNans in execute_device
    # The planner's grouping-set path keeps the partial pass: its expand
    # multiplies the rows, and the coarse levels reduce even where the
    # finest does not.
    allow_partial_skip = True
    # Max batches concatenated per merge step (bounds a consolidation's
    # transient device memory).
    _CONSOLIDATE_CHUNK = 12

    def __init__(self, child: Exec,
                 group_by: Sequence[Tuple[str, Expression]],
                 aggregates: Sequence[AggSpec],
                 mode: str = "complete"):
        super().__init__(child)
        assert mode in ("partial", "final", "complete", "merge",
                        "mixed_final"), mode
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
        if self.mode in ("partial", "merge"):
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
                   has_nans: bool = True,
                   row_index: Optional[torch.Tensor] = None
                   ) -> List[List[Buf]]:
        """``spec_inputs`` holds per spec ("update", SortedCol) or
        ("merge", [SortedCol...]). Sum-decomposable specs stack their
        streams per dtype class, one cumsum each; the rest ("raw") run
        their own segmented update/merge (``row_index``, each sorted row's
        arrival index, orders First/Last). Returns the buffer list per
        spec."""
        stacks: Dict[str, List[torch.Tensor]] = {}
        plans = []      # per spec: ("sum", [(cls, pos)...]) | ("raw", bufs)
        for spec, (kind, arg) in zip(self.aggs, spec_inputs):
            terms = spec.fn.sum_terms_update(arg, has_nans) \
                if kind == "update" \
                else spec.fn.sum_terms_merge(arg, has_nans)
            if terms is None:
                bufs = spec.fn.update(arg, gid, capacity, row_index) \
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

    def _update_batch(self, batch: DeviceBatch, offset: int = 0
                      ) -> DeviceBatch:
        """One input batch -> partial buffer batch. ``offset`` is the
        arrival index of the batch's row 0 in its partition (orders
        First/Last)."""
        work, ords = self._project_inputs(batch)
        if self._global_ok:
            return self._global_stage(work, ords, update=True,
                                      offset=offset)
        cap = work.capacity
        g, sorted_b, slive = self._group_sorted(work)
        row_index = g.perm + offset
        inputs = []
        for ord_ in ords:
            if ord_ is None:
                inputs.append(("update", SortedCol(
                    torch.zeros(cap, dtype=torch.int64, device=slive.device),
                    slive)))
            else:
                inputs.append(("update", self._sorted_view(sorted_b, ord_)))
        bufs = self._run_specs(inputs, g.group_of_sorted, slive, cap,
                               self._has_nans, row_index)
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

    def _mixed_batch(self, batch: DeviceBatch) -> DeviceBatch:
        """The DISTINCT stage: input [keys..., x, other buffers...] with
        (keys, x) already unique, grouped by the keys only; distinct specs
        update over x, the others merge their buffers. Emits the standard
        buffer layout [keys..., all buffers...]."""
        cap = batch.capacity
        g, sorted_b, slive = self._group_sorted(batch)
        x_ord = self._nkeys
        ci = self._nkeys + 1            # the other buffers follow x
        inputs = []
        for spec in self.aggs:
            if spec.distinct:
                inputs.append(("update", self._sorted_view(sorted_b, x_ord)))
            else:
                nbuf = len(spec.fn.buffer_types)
                inputs.append(("merge", [self._sorted_view(sorted_b, ci + b)
                                         for b in range(nbuf)]))
                ci += nbuf
        bufs = self._run_specs(inputs, g.group_of_sorted, slive, cap,
                               row_index=g.perm)
        return self._assemble(batch, g, bufs)

    def _passthrough_batch(self, batch: DeviceBatch, offset: int = 0
                           ) -> DeviceBatch:
        """The partial skip: project each ROW into the buffer layout with
        no grouping (an elementwise step, no sort: the measured reduction
        said grouping here would not pay for itself). The batch keeps its
        liveness; ``offset`` numbers the rows' arrival as
        ``_update_batch`` does."""
        work, ords = self._project_inputs(batch)
        cap = work.capacity
        live = work.row_mask()
        row_index = torch.arange(cap, dtype=torch.int64,
                                 device=live.device) + offset
        out_cols = list(work.columns[:self._nkeys])
        for spec, ord_ in zip(self.aggs, ords):
            if ord_ is None:
                col = SortedCol(torch.zeros(cap, dtype=torch.int64,
                                            device=live.device), live)
            else:
                c = work.columns[ord_]
                col = SortedCol(c.data, c.validity & live, c.lengths)
            for buf, bt in zip(spec.fn.update_row(col, row_index),
                               spec.fn.buffer_types):
                out_cols.append(self._buf_column(buf, bt, live))
        return DeviceBatch(tuple(out_cols), work.num_rows, sel=work.sel)

    @property
    def _rowskip_capable(self) -> bool:
        return self._nkeys > 0 and all(
            type(s.fn).update_row is not AggFunction.update_row
            for s in self.aggs)

    # -- zero-key path --------------------------------------------------------
    @property
    def _global_ok(self) -> bool:
        """Zero grouping keys and every function reduces a whole batch
        with masked reductions; a string Min/Max or First/Last and the
        mixed_final stage take the sorted path."""
        return self._nkeys == 0 and self.mode != "mixed_final" and not any(
            isinstance(s.fn, (Min, First))
            and s.fn.child.data_type().is_string for s in self.aggs)

    def _global_stage(self, work: DeviceBatch, ords, update: bool,
                      offset: int = 0) -> DeviceBatch:
        live = work.row_mask()
        all_bufs = []
        if update:
            row_index = torch.arange(work.capacity, dtype=torch.int64,
                                     device=live.device) + offset
            for spec, ord_ in zip(self.aggs, ords):
                if ord_ is None:
                    col = SortedCol(torch.zeros(work.capacity,
                                                dtype=torch.int64,
                                                device=live.device), live)
                else:
                    c = work.columns[ord_]
                    col = SortedCol(c.data, c.validity & live, c.lengths)
                all_bufs.append(spec.fn.update_global(col, row_index,
                                                      live))
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
        one batched row-count pull per level. The first level of the
        final, merge and mixed_final modes runs their stage over the
        input; every later level merges. The mixed stage is safe over
        chunks: its x values are unique rows, so chunk updates followed
        by merges count each value once."""
        first_stage = {"final": self._merge_batch,
                       "merge": self._merge_batch,
                       "mixed_final": self._mixed_batch}.get(self.mode)
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
        if final_stage and self.mode in ("final", "complete",
                                         "mixed_final"):
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
            # batch compacts before the capacity-scaled sort. The target
            # shrinks after the OOM ladder's shrink rung.
            child_iter = coalesce_iter(
                child_iter,
                effective_batch_target(int(ctx.conf.get(C.BATCH_SIZE_ROWS))),
                int(ctx.conf.get(C.BATCH_SIZE_BYTES)))
        # The adaptive partial skip (skipAggPassReductionRatio): the first
        # partial batch's reduction, read in one sync, decides for the
        # whole query (kept in the context); when grouping barely reduced
        # it, later batches project their rows straight into the buffer
        # layout and the final stage groups once.
        skip_key = f"aggskip:{id(self):x}"
        skip_ratio = float(ctx.conf.get(C.AGG_SKIP_PARTIAL_RATIO))
        can_skip = (self.mode == "partial" and skip_ratio < 1.0
                    and self.allow_partial_skip and self._rowskip_capable)
        offset = 0
        for batch in child_iter:
            if update_stage:
                skipping = can_skip and ctx.cache.get(skip_key, False)
                step = self._passthrough_batch if skipping \
                    else self._update_batch
                with timed(m):
                    # One partial a batch; one a half where the batch's
                    # OOM is left unmet (split_on_oom).
                    partials = list(split_on_oom(
                        lambda b, off: kc.call(step, b, offset + off),
                        batch))
                if can_skip and skip_key not in ctx.cache:
                    groups, live = torch.stack([
                        sum(p.num_rows.to(torch.int64) for p in partials),
                        batch.live_count().to(torch.int64)]).cpu().tolist()
                    skip = groups >= skip_ratio * max(live, 1)
                    ctx.cache[skip_key] = skip
                    m.add("partialSkip", int(skip))
                offset += batch.capacity
                if self.mode == "partial":
                    for partial in partials:
                        record_batch(m, partial)
                        yield partial
                    continue
                pending.extend(partials)
            else:
                pending.append(batch)
        if self.mode == "partial":
            return
        if self.mode == "mixed_final" and self._nkeys == 0 and pending:
            # The reference's exchange serves no empty piece, so a zero-key
            # mixed stage whose every input batch is empty has seen none.
            pending, counts = shrink_all(pending)
            pending = [b for b, c in zip(pending, counts) if c]
        if not pending:
            if self._nkeys == 0 and self.mode in ("final", "complete",
                                                  "mixed_final"):
                yield self._empty_result(self.plan_device())
            return
        with timed(m):
            acc = kc.call(self._consolidate, pending, final_stage=True)
        record_batch(m, acc)
        yield acc

    # -- host engine ---------------------------------------------------------
    def execute_host(self, ctx, partition):
        hbs = list(self.children[0].execute_host(ctx, partition))
        out = self._host_exec_vectorized(hbs)
        if out is None:
            if self.mode in ("final", "merge"):
                out = self._execute_host_final(
                    hbs, do_finalize=self.mode == "final")
            elif self.mode == "mixed_final":
                out = self._execute_host_mixed(hbs)
            else:
                out = self._execute_host_rows(hbs)
        yield out

    def _execute_host_rows(self, hbs) -> HostBatch:
        """The python-row path of the partial and complete modes: group
        the input rows, then ``host_update`` (partial) or ``host_agg``
        (complete) each group's python values."""
        key_evaluator = []
        input_lists = []
        for hb in hbs:
            key_evaluator.append([as_host_column(e.eval_host(hb), hb)
                                  for e in self.group_exprs])
            inlists = []
            for spec in self.aggs:
                if spec.fn.child is None:
                    inlists.append(None)
                else:
                    inlists.append(as_host_column(
                        spec.fn.child.eval_host(hb), hb).to_list())
            input_lists.append(inlists)
        order, key_values, groups = self._host_groups(hbs, key_evaluator,
                                                      input_lists)
        rows: List[tuple] = []
        for key in order:
            vals = list(key_values[key])
            for ai, spec in enumerate(self.aggs):
                if self.mode == "partial":
                    vals.extend(spec.fn.host_update(groups[key][ai]))
                else:
                    vals.append(spec.fn.host_agg(groups[key][ai]))
            rows.append(tuple(vals))
        if not rows and self._nkeys == 0:
            vals = []
            for spec in self.aggs:
                if self.mode == "partial":
                    vals.extend(spec.fn.host_update([]))
                else:
                    vals.append(spec.fn.host_agg([]))
            rows = [tuple(vals)]
        return _rows_to_host_batch(rows, self.schema)

    def _execute_host_final(self, hbs, do_finalize: bool = True
                            ) -> HostBatch:
        """The python-row path of the final and merge modes: group buffer
        rows by key, ``host_merge`` the buffer tuples, then
        ``host_finalize`` them (final) or emit them (merge)."""
        key_evaluator = []
        buf_lists = []
        for hb in hbs:
            key_evaluator.append(list(hb.columns[:self._nkeys]))
            # One pseudo-input per aggregate: its buffer values' tuple.
            ci = self._nkeys
            per_agg = []
            for spec in self.aggs:
                nbuf = len(spec.fn.buffer_types)
                cols = [hb.columns[ci + b].to_list() for b in range(nbuf)]
                per_agg.append(list(zip(*cols)) if cols else [])
                ci += nbuf
            buf_lists.append(per_agg)
        order, key_values, groups = self._host_groups(hbs, key_evaluator,
                                                      buf_lists)
        rows = []
        for key in order:
            vals = list(key_values[key])
            for ai, spec in enumerate(self.aggs):
                merged = spec.fn.host_merge(groups[key][ai])
                if do_finalize:
                    vals.append(spec.fn.host_finalize(merged))
                else:
                    vals.extend(merged)
            rows.append(tuple(vals))
        return _rows_to_host_batch(rows, self.schema)

    def _execute_host_mixed(self, hbs) -> HostBatch:
        """The python-row path of the mixed_final mode: input rows are
        unique by (keys, x); distinct specs aggregate the x values, the
        others merge and finalize their buffers. A zero-key stage over no
        rows gives one row (COUNT(DISTINCT) of nothing is 0)."""
        key_evaluator = []
        input_lists = []
        x_ord = self._nkeys
        for hb in hbs:
            key_evaluator.append(list(hb.columns[:self._nkeys]))
            xvals = hb.columns[x_ord].to_list()
            ci = self._nkeys + 1
            per_agg = []
            for spec in self.aggs:
                if spec.distinct:
                    per_agg.append(xvals)
                else:
                    nbuf = len(spec.fn.buffer_types)
                    cols = [hb.columns[ci + b].to_list()
                            for b in range(nbuf)]
                    per_agg.append(list(zip(*cols)) if cols else [])
                    ci += nbuf
            input_lists.append(per_agg)
        order, key_values, groups = self._host_groups(hbs, key_evaluator,
                                                      input_lists)

        def result(spec, values):
            if spec.distinct:
                return spec.fn.host_agg(values)
            return spec.fn.host_finalize(spec.fn.host_merge(values))
        rows = [tuple(key_values[key]) + tuple(
            result(spec, groups[key][ai])
            for ai, spec in enumerate(self.aggs)) for key in order]
        if not rows and self._nkeys == 0:
            rows = [tuple(result(spec, []) for spec in self.aggs)]
        return _rows_to_host_batch(rows, self.schema)

    def _host_groups(self, hbs, key_evaluator, input_lists):
        """Host grouping of the python-row path: (order, key_values,
        groups), ``groups[key][ai]`` the python values of aggregate
        ``ai``. Groups come in first-seen order and keep their rows'
        order; NaN == NaN and -0.0 == 0.0 group together, and so do null
        keys. Fixed-width keys group in numpy; string keys by a dict."""
        fast = self._host_groups_vectorized(hbs, key_evaluator,
                                            input_lists)
        if fast is not None:
            return fast
        groups = {}
        key_values = {}
        order = []
        for hb, keycols, inlists in zip(hbs, key_evaluator, input_lists):
            for i in range(hb.num_rows):
                triples = [self._host_key(kc, i) for kc in keycols]
                # The canonical key only: raw floats break NaN equality.
                key = tuple((t[0], t[1]) for t in triples)
                if key not in groups:
                    groups[key] = [[] for _ in self.aggs]
                    key_values[key] = [t[2] if t[0] else None
                                       for t in triples]
                    order.append(key)
                for ai, vals in enumerate(inlists):
                    groups[key][ai].append(vals[i] if vals is not None
                                           else 1)
        return order, key_values, groups

    def _host_groups_vectorized(self, hbs, key_evaluator, input_lists):
        """The numpy path of :meth:`_host_groups`, or None for string
        keys."""
        nrows = [hb.num_rows for hb in hbs]
        total = sum(nrows)
        if total == 0:
            return [], {}, {}
        keycols0 = key_evaluator[0] if key_evaluator else []
        if any(kc.dtype.is_string for kc in keycols0):
            return None
        nkeys = len(keycols0)
        nags = len(self.aggs)

        def group_lists(idx_groups):
            out_per_agg = []
            for ai in range(nags):
                parts = [il[ai] for il in input_lists]
                if any(p is None for p in parts):
                    out_per_agg.append([[1] * len(idx)
                                        for idx in idx_groups])
                    continue
                merged = parts[0] if len(parts) == 1 else \
                    [v for p in parts for v in p]
                arr = np.empty(len(merged), dtype=object)
                try:
                    arr[:] = merged          # scalars: one C-level copy
                    ok = True
                except (ValueError, TypeError):
                    ok = False               # tuple rows (merge buffers)
                if ok:
                    out_per_agg.append([arr[idx].tolist()
                                        for idx in idx_groups])
                else:
                    out_per_agg.append([[merged[i] for i in idx.tolist()]
                                        for idx in idx_groups])
            return out_per_agg

        if nkeys == 0:
            per_agg = group_lists([np.arange(total, dtype=np.int64)])
            key = ()
            return [key], {key: []}, {key: [per_agg[ai][0]
                                            for ai in range(nags)]}

        # Canonical key views across batches: NaNs share one bit pattern,
        # -0.0 == 0.0, and null rows compare equal whatever their data.
        views = []
        valids = []
        raws = []
        for ki in range(nkeys):
            cols = [ke[ki] for ke in key_evaluator]
            data = np.concatenate([np.asarray(c.data) for c in cols]) \
                if len(cols) > 1 else np.asarray(cols[0].data)
            valid = np.concatenate([np.asarray(c.validity)
                                    for c in cols]) \
                if len(cols) > 1 else np.asarray(cols[0].validity)
            dtype = cols[0].dtype
            if dtype.is_floating:
                d = data.astype(np.float64) + 0.0     # -0.0 -> +0.0
                nanmask = np.isnan(d)
                if nanmask.any():
                    d = d.copy()
                    d[nanmask] = np.nan               # canonical NaN bits
                view = d.view(np.uint64).astype(np.int64, copy=False)
            elif dtype.is_boolean:
                view = data.astype(np.int64)
            else:
                view = data.astype(np.int64, copy=False)
            view = np.where(valid, view, np.int64(0))
            views.append(view)
            valids.append(valid.astype(np.int8))
            raws.append((dtype, data, valid))
        order_idx = np.lexsort(tuple(
            a for ki in range(nkeys - 1, -1, -1)
            for a in (views[ki], valids[ki])))
        new_flags = np.zeros(total, dtype=bool)
        new_flags[0] = True
        for ki in range(nkeys):
            sv = views[ki][order_idx]
            sa = valids[ki][order_idx]
            new_flags[1:] |= (sv[1:] != sv[:-1]) | (sa[1:] != sa[:-1])
        starts = np.flatnonzero(new_flags)
        ends = np.append(starts[1:], total)
        # First-seen order: lexsort is stable, so order_idx at a group's
        # start is its first row, and a group's rows stay in input order.
        emit = np.argsort(order_idx[starts], kind="stable")
        idx_groups = [order_idx[starts[g]:ends[g]] for g in emit]
        per_agg = group_lists(idx_groups)
        order = []
        key_values = {}
        groups = {}
        for gi, g in enumerate(emit):
            rep = int(order_idx[starts[g]])
            key = []
            vals = []
            for ki in range(nkeys):
                v_ok = bool(valids[ki][rep])
                key.append((v_ok, int(views[ki][rep])))
                if not v_ok:
                    vals.append(None)
                    continue
                dtype, data, _ = raws[ki]
                if dtype.is_floating:
                    f = float(data[rep])
                    vals.append(0.0 if f == 0.0 else f)
                elif dtype.is_boolean:
                    vals.append(bool(data[rep]))
                else:
                    vals.append(int(data[rep]))
            key = tuple(key)
            order.append(key)
            key_values[key] = vals
            groups[key] = [per_agg[ai][gi] for ai in range(nags)]
        return order, key_values, groups

    def _host_segments(self, key_pieces, total):
        """Group segmentation over per-batch key column pieces: one stable
        lexsort over packed (validity, code) planes. Returns
        ``(order_idx, starts, ends, emit, rep_idx, key_enc)``: starts and
        ends ascending (reduceat's currency), ``emit`` permuting sorted
        group order into first-seen order, ``rep_idx`` each group's first
        row in emission order, ``key_enc`` each key's (codes, space)."""
        nkeys = len(key_pieces)
        if nkeys == 0:
            order_idx = np.arange(total, dtype=np.int64)
            one = np.zeros(1, np.int64)
            return (order_idx, one, np.asarray([total], np.int64), one,
                    one.copy(), [])
        codes, valids, spaces = [], [], []
        for pieces in key_pieces:
            c, v, space = encode_key_concat(pieces)
            codes.append(c)
            valids.append(v.view(np.int8))
            spaces.append(space)
        # Pack (valid, code) pairs into as few int64 planes as their
        # ranges allow. Packing is injective per key, so the segments and
        # the stable within-group order are those of the unpacked sort.
        planes: list = []
        acc = None
        acc_range = 1
        cap = 1 << 62
        for ki in range(nkeys):
            c, v = codes[ki], valids[ki].astype(np.int64)
            cmin = int(c.min())
            crange = int(c.max()) - cmin + 1
            r = 2 * crange
            if r > cap:
                if acc is not None:
                    planes.append(acc)
                    acc, acc_range = None, 1
                planes.append(v)        # valid outranks code (null group)
                planes.append(c)
                continue
            local = v * crange + (c - cmin)
            if acc is None:
                acc, acc_range = local, r
            elif acc_range * r <= cap:
                acc = acc * r + local
                acc_range *= r
            else:
                planes.append(acc)
                acc, acc_range = local, r
        if acc is not None:
            planes.append(acc)
        order_idx = stable_code_argsort(planes[0]) if len(planes) == 1 \
            else np.lexsort(tuple(planes[::-1]))
        new_flags = np.zeros(total, dtype=bool)
        new_flags[0] = True
        for p in planes:
            sp = p[order_idx]
            new_flags[1:] |= sp[1:] != sp[:-1]
        starts = np.flatnonzero(new_flags).astype(np.int64)
        ends = np.append(starts[1:], total)
        emit = np.argsort(order_idx[starts], kind="stable").astype(np.int64)
        rep_idx = order_idx[starts][emit]
        return (order_idx, starts, ends, emit, rep_idx,
                list(zip(codes, spaces)))

    def _host_exec_vectorized(self, hbs) -> Optional[HostBatch]:
        """One vectorized pass for every mode (update or complete over
        inputs, merge or final over buffers, mixed_final over x and
        buffers), or None when the shape does not qualify (empty input, a
        string Min/Max): the python-row path then runs."""
        total = sum(hb.num_rows for hb in hbs)
        if total == 0:
            return None
        if any(isinstance(spec.fn, Min)
               and spec.fn.child.data_type().is_string
               for spec in self.aggs):
            return None

        def concat_col(cols):
            if len(cols) == 1:
                return cols[0]
            return concat_host_batches(
                [HostBatch(("c",), [c]) for c in cols]).columns[0]

        agg_inputs = []
        if self.mode in ("partial", "complete"):
            kind = "update" if self.mode == "partial" else "agg"
            keysrc = [[as_host_column(e.eval_host(hb), hb)
                       for e in self.group_exprs] for hb in hbs]
            for spec in self.aggs:
                if spec.fn.child is None:
                    agg_inputs.append((kind, [None]))
                else:
                    agg_inputs.append((kind, [concat_col(
                        [as_host_column(spec.fn.child.eval_host(hb), hb)
                         for hb in hbs])]))
        elif self.mode in ("final", "merge"):
            keysrc = [list(hb.columns[:self._nkeys]) for hb in hbs]
            ci = self._nkeys
            for spec in self.aggs:
                nbuf = len(spec.fn.buffer_types)
                agg_inputs.append((self.mode, [
                    concat_col([hb.columns[ci + b] for hb in hbs])
                    for b in range(nbuf)]))
                ci += nbuf
        else:                                   # mixed_final
            keysrc = [list(hb.columns[:self._nkeys]) for hb in hbs]
            xcol = concat_col([hb.columns[self._nkeys] for hb in hbs])
            ci = self._nkeys + 1
            for spec in self.aggs:
                if spec.distinct:
                    agg_inputs.append(("agg", [xcol]))
                    continue
                nbuf = len(spec.fn.buffer_types)
                agg_inputs.append(("final", [
                    concat_col([hb.columns[ci + b] for hb in hbs])
                    for b in range(nbuf)]))
                ci += nbuf
        key_cols = [concat_col([ks[ki] for ks in keysrc])
                    for ki in range(self._nkeys)]
        (order_idx, starts, ends, emit, rep_idx,
         key_enc) = self._host_segments(
            [[ks[ki] for ks in keysrc] for ki in range(self._nkeys)],
            total)
        for kc, (codes, space) in zip(key_cols, key_enc):
            # The concat rows are the rows these codes were computed for;
            # stamping them lets take(rep_idx) below carry them on.
            if kc._key_codes is None:
                kc._key_codes = codes
                kc._key_uniq = space
        out_cols = []
        for kc in key_cols:
            oc = kc.take(rep_idx)
            if oc.dtype.is_floating:
                # Canonical zero: a -0.0 group representative emits 0.0.
                oc = HostColumn(oc.dtype,
                                oc.data + oc.dtype.np_dtype.type(0),
                                oc.validity)
            out_cols.append(oc)
        for (kind, cols), spec in zip(agg_inputs, self.aggs):
            res = _host_seg_agg(spec.fn, kind, cols, order_idx, starts,
                                ends)
            out_cols.extend(rc.take(emit) for rc in res)
        return HostBatch(tuple(n for n, _ in self.schema), out_cols)

    @staticmethod
    def _host_key(col: HostColumn, i: int):
        """(valid, canonical group key, output value) of one key cell."""
        if not col.validity[i]:
            return (False, None, None)
        v = col.data[i]
        if col.dtype.is_string:
            s = bytes(v).decode("utf-8", "replace")
            return (True, s, s)
        if col.dtype.is_floating:
            f = float(v)
            if np.isnan(f):
                return (True, "NaN", f)   # NaN == NaN for grouping
            if f == 0.0:
                return (True, 0.0, 0.0)   # -0.0 == 0.0 for grouping
            return (True, f, f)
        if col.dtype.is_boolean:
            return (True, bool(v), bool(v))
        return (True, int(v), int(v))


def _rows_to_host_batch(rows: List[tuple], schema: Schema) -> HostBatch:
    names = tuple(n for n, _ in schema)
    cols = [HostColumn.from_values(t, [r[ci] for r in rows])
            for ci, (_, t) in enumerate(schema)]
    return HostBatch(names, cols)


def _host_seg_agg(fn: AggFunction, kind: str, cols, order_idx, starts,
                  ends) -> List[HostColumn]:
    """Every group of one aggregate over sorted segments, one reduceat
    per buffer: the numpy mirror of the function's python-row path.
    ``kind``: 'agg' (complete result), 'update' (partial buffers), 'merge'
    (merged buffers, not finalized) or 'final' (merge + finalize).
    ``cols`` holds the concatenated input column (None for count(*)) or
    the buffer columns. Results come in
    sorted-group order (the caller permutes them into emission order).
    String Min/Max never gets here."""
    ngroups = len(starts)

    def v_of(c):
        return np.asarray(c.validity, np.bool_)[order_idx]

    def d_of(c):
        return np.asarray(c.data)[order_idx]

    def cnt_of(v):
        return np.add.reduceat(v.astype(np.int64), starts)

    def masked_sum(c, out_float):
        v = v_of(c)
        if out_float:
            return np.add.reduceat(
                np.where(v, d_of(c).astype(np.float64), 0.0), starts), v
        with np.errstate(over="ignore"):
            s = np.add.reduceat(
                np.where(v, d_of(c).astype(np.int64), np.int64(0)), starts)
        return s, v

    if isinstance(fn, CountStar) and kind in ("agg", "update"):
        return [HostColumn(dt.INT64, (ends - starts).astype(np.int64),
                           np.ones(ngroups, np.bool_))]
    if isinstance(fn, Count):           # Count + CountStar merge/final
        if kind in ("agg", "update"):
            data = cnt_of(v_of(cols[0]))
        else:
            data, _ = masked_sum(cols[0], out_float=False)
        return [HostColumn(dt.INT64, data, np.ones(ngroups, np.bool_))]

    if isinstance(fn, Sum):
        t = fn.result_type
        s, v = masked_sum(cols[0], out_float=t.is_floating)
        ok = cnt_of(v) > 0
        data = np.where(ok, s, 0).astype(t.np_dtype)
        return [HostColumn(t, data, ok)]

    if isinstance(fn, Average):
        if kind in ("agg", "update"):
            s, v = masked_sum(cols[0], out_float=True)
            n = cnt_of(v)
            sv = n > 0
        else:
            s, v0 = masked_sum(cols[0], out_float=True)
            n, _ = masked_sum(cols[1], out_float=False)
            sv = cnt_of(v0) > 0
        if kind in ("agg", "final"):
            ok = n > 0
            data = np.where(ok, s / np.where(ok, n, 1), 0.0)
            return [HostColumn(dt.FLOAT64, data, ok)]
        return [HostColumn(dt.FLOAT64, np.where(sv, s, 0.0), sv),
                HostColumn(dt.INT64, n, np.ones(ngroups, np.bool_))]

    if isinstance(fn, First):           # First + Last
        return _host_seg_first(fn, kind, cols, order_idx, starts, ends)

    # Min + Max, numeric.
    c = cols[0]
    t = c.dtype
    v = v_of(c)
    ok = cnt_of(v) > 0
    is_max = fn.kind == "max"
    if t.is_floating:
        f = d_of(c).astype(np.float64)
        nanm = v & np.isnan(f)
        nonnan = v & ~np.isnan(f)
        if is_max:
            # Spark max: NaN is greatest, so any NaN wins the group.
            m = np.maximum.reduceat(np.where(nonnan, f, -np.inf), starts)
            data = np.where(cnt_of(nanm) > 0, np.nan, m)
        else:
            # Spark min: NaN only when the group is all NaN.
            m = np.minimum.reduceat(np.where(nonnan, f, np.inf), starts)
            data = np.where(cnt_of(nonnan) > 0, m, np.nan)
        data = np.where(ok, data, 0.0).astype(t.np_dtype)
    else:
        x = d_of(c).astype(np.int64)
        if is_max:
            m = np.maximum.reduceat(
                np.where(v, x, np.iinfo(np.int64).min), starts)
        else:
            m = np.minimum.reduceat(
                np.where(v, x, np.iinfo(np.int64).max), starts)
        data = np.where(ok, m, 0).astype(t.np_dtype)
    return [HostColumn(t, data, ok)]


def _host_seg_first(fn: "First", kind: str, cols, order_idx, starts,
                    ends) -> List[HostColumn]:
    """First/Last over sorted segments. The index buffer is the pick's
    position inside its group's rows (what the python-row path's
    ``host_update`` numbers); merging keeps the least (First) or greatest
    (Last) index, ties to the earliest row, as the python ``min`` /
    ``max`` over buffer tuples do."""
    last = fn.pick == "max"
    total = len(order_idx)
    ngroups = len(starts)
    pos = np.arange(total, dtype=np.int64)
    if kind in ("agg", "update"):
        c = cols[0]
        v = np.asarray(c.validity, np.bool_)[order_idx]
        if fn.ignore_nulls:
            if last:
                p = np.maximum.reduceat(np.where(v, pos, np.int64(-1)),
                                        starts)
                ok = p >= 0
            else:
                p = np.minimum.reduceat(np.where(v, pos, np.int64(total)),
                                        starts)
                ok = p < total
        else:
            p = (ends - 1 if last else starts).astype(np.int64)
            ok = np.ones(ngroups, np.bool_)
        safe = np.where(ok, p, 0)
        vcol = c.take(np.where(ok, order_idx[safe], np.int64(-1)),
                      null_on_negative=True)
        if kind == "agg":
            return [vcol]
        return [vcol, HostColumn(dt.INT64, np.where(ok, safe - starts, 0),
                                 ok)]
    # merge / final: one reduceat over index * T + a tie-break that makes
    # the earliest row win.
    vb, ib = cols
    iv = np.asarray(ib.validity, np.bool_)[order_idx]
    ix = np.asarray(ib.data)[order_idx].astype(np.int64)
    localpos = pos - np.repeat(starts, ends - starts)
    T = np.int64(total + 1)
    if last:
        enc = np.where(iv, ix * T + (T - 1 - localpos), np.int64(-1))
        best = np.maximum.reduceat(enc, starts)
        ok = best >= 0
    else:
        imax = np.iinfo(np.int64).max
        enc = np.where(iv, ix * T + localpos, imax)
        best = np.minimum.reduceat(enc, starts)
        ok = best < imax
    safe = np.where(ok, best, 0)
    lp = (T - 1) - (safe % T) if last else safe % T
    idx = np.where(ok, order_idx[np.where(ok, starts + lp, 0)],
                   np.int64(-1))
    vcol = vb.take(idx, null_on_negative=True)
    if kind == "final":
        return [vcol]
    return [vcol, HostColumn(dt.INT64, np.where(ok, safe // T, 0), ok)]
