"""Window functions (port of the JAX package's ``ops/window.py``: frames,
specs, the device evaluation, ``WindowExec`` and the numpy host engine).

Device evaluation per batch (a window's partitions must lie in one batch,
so ``WindowExec`` coalesces its partition's batches into one):

1. sort rows by (partition fingerprint, order keys) with
   ``kernels.lex_sort_perm``, one K1 launch a word on the card, so
   partitions become contiguous segments with rows in frame order;
2. segment and peer boundary masks drive the rest:
   - row_number / rank / dense_rank from boundary cumsums and a
     ``torch.cummax`` of boundary positions,
   - lead / lag as shifts masked at partition edges,
   - aggregates as segment reductions broadcast back (``segment_reduce``:
     K2 for integer sums, every count and every min/max), running or
     ROWS-frame prefix-sum differences, or a segmented log-step scan for
     running min/max;
3. results scatter back to the original row order.

Frames: the whole partition (no ORDER BY), RANGE UNBOUNDED PRECEDING ..
CURRENT ROW with peers (Spark's default with an ORDER BY), ROWS frames
with bounded preceding/following, and RANGE frames of value offsets over
one ascending integer order column.

The host engine (``_host_window``) is the reference's: one ``np.lexsort``
over partition and order-key codes with boundary flags, falling back to a
python oracle for the shapes it does not vectorize.

The reference's jit cache (``kernel_cache``) and its out-of-core split by
partition keys are not ported: the window runs eagerly over one batch.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, DeviceColumn, torch_dtype)
from spark_rapids_tpu_torch.columnar.host import (
    HostBatch, HostColumn, all_valid as host_all_valid, concat_host_batches,
    encode_key, encode_sort_key)
from spark_rapids_tpu_torch.exprs.base import (
    Expression, as_device_column, as_host_column)
from spark_rapids_tpu_torch.ops import kernels
from spark_rapids_tpu_torch.ops.base import Exec, Schema, record_batch, timed
from spark_rapids_tpu_torch.ops.sort import SortOrder, coalesce_to_single_batch

UNBOUNDED = None


@dataclasses.dataclass
class WindowFrame:
    """Frame bounds; None = unbounded. Spark's default (RANGE
    UNBOUNDED..CURRENT with peers) is ``running_with_peers=True``.

    ``range_interval=True`` makes preceding/following VALUE offsets over
    the single integer-typed order column (date days / timestamp micros)
    instead of row counts."""

    preceding: Optional[int] = UNBOUNDED
    following: Optional[int] = 0
    running_with_peers: bool = False
    range_interval: bool = False


@dataclasses.dataclass
class WindowSpec:
    partition_by: List[Expression]
    order_by: List[SortOrder]


class WindowFunction:
    """One window expression."""

    def result_type(self) -> dt.DataType:
        raise NotImplementedError


@dataclasses.dataclass
class RowNumber(WindowFunction):
    def result_type(self):
        return dt.INT32


@dataclasses.dataclass
class Rank(WindowFunction):
    def result_type(self):
        return dt.INT32


@dataclasses.dataclass
class DenseRank(WindowFunction):
    def result_type(self):
        return dt.INT32


@dataclasses.dataclass
class Lead(WindowFunction):
    child: Expression
    offset: int = 1

    def result_type(self):
        return self.child.data_type()


@dataclasses.dataclass
class Lag(WindowFunction):
    child: Expression
    offset: int = 1

    def result_type(self):
        return self.child.data_type()


@dataclasses.dataclass
class WindowAgg(WindowFunction):
    """sum/count/min/max/avg over the window frame."""

    kind: str                   # sum | count | min | max | avg
    child: Optional[Expression]
    frame: WindowFrame = dataclasses.field(default_factory=WindowFrame)

    def result_type(self):
        if self.kind == "count":
            return dt.INT64
        if self.kind == "avg":
            return dt.FLOAT64
        t = self.child.data_type()
        if self.kind == "sum":
            return dt.FLOAT64 if t.is_floating else dt.INT64
        return t


@dataclasses.dataclass
class WindowExprSpec:
    name: str
    fn: WindowFunction
    spec: WindowSpec


# ---------------------------------------------------------------------------
# Device evaluation
# ---------------------------------------------------------------------------

def _arange(cap: int, device) -> torch.Tensor:
    return torch.arange(cap, dtype=torch.int64, device=device)


def _shift_prev(x: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """x[i - 1] at every i, with ``first`` (one element) at 0."""
    return torch.cat([first, x[:-1]])


def _last_marks(flags: torch.Tensor) -> torch.Tensor:
    """``flags[i + 1]`` at every i, True at the last row: marks the last
    row of each run whose first rows ``flags`` marks."""
    return torch.cat([flags[1:], flags.new_ones(1)])


def _sorted_frame(batch: DeviceBatch, spec: WindowSpec):
    """Sort rows into (partition, order) frame; return (perm, sorted
    liveness, partition-start mask, peer-start mask), all in sorted
    order. Partition boundaries compare the key fingerprint, as the
    reference's do."""
    cap = batch.capacity
    live = batch.row_mask()
    pcols = [as_device_column(e.eval(batch), batch)
             for e in spec.partition_by]
    ha, hb = kernels.key_fingerprint(pcols, cap, batch.device)
    order_words = []
    for o in spec.order_by:
        col = as_device_column(o.child.eval(batch), batch)
        order_words.extend(kernels.sort_key_passes(col, o.ascending,
                                                   o.nulls_first))
    # lex_sort_perm sorts dead rows last through its own leading word.
    perm = kernels.lex_sort_perm([ha, hb] + order_words, live, cap)
    s_live = live.index_select(0, perm)
    s_ha = ha.index_select(0, perm)
    s_hb = hb.index_select(0, perm)
    idx = _arange(cap, batch.device)
    new_part = ((s_ha != _shift_prev(s_ha, s_ha[:1] ^ 1))
                | (s_hb != _shift_prev(s_hb, s_hb[:1])) | (idx == 0)) \
        & s_live
    new_peer = new_part
    for w in order_words:
        sw = w.index_select(0, perm)
        new_peer = new_peer | ((sw != _shift_prev(sw, sw[:1])) & s_live)
    return perm, s_live, new_part, new_peer


def _segment_starts(new_part: torch.Tensor, cap: int) -> torch.Tensor:
    """Start index of the segment holding each row: the running max of
    the boundary positions."""
    idx = _arange(cap, new_part.device)
    return torch.cummax(torch.where(new_part, idx, torch.zeros_like(idx)),
                        0).values


def _run_ends(boundary_next: torch.Tensor, cap: int) -> torch.Tensor:
    """For each row, the index of the last row of its run, where
    ``boundary_next[i]`` marks i as a run's last row."""
    idx = _arange(cap, boundary_next.device)
    marked = torch.where(boundary_next, idx, torch.full_like(idx, cap))
    ends = torch.flip(torch.cummin(torch.flip(marked, (0,)), 0).values, (0,))
    return ends.clamp(0, cap - 1)


def _seg_id(new_part: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(new_part.to(torch.int64), 0) - 1


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """``inv[perm[p]] = p``."""
    return torch.empty_like(perm).scatter_(
        0, perm, _arange(perm.shape[0], perm.device))


def compute_window(batch: DeviceBatch,
                   exprs: Sequence[WindowExprSpec]) -> DeviceBatch:
    """Evaluate all window expressions; returns the batch with one new
    column per expression appended (original row order)."""
    cap = batch.capacity
    mask = batch.row_mask()
    out_cols = list(batch.columns)
    for wx in exprs:
        perm, s_live, new_part, new_peer = _sorted_frame(batch, wx.spec)
        inv = _inverse(perm)
        seg_start = _segment_starts(new_part, cap)
        idx = _arange(cap, batch.device)
        # Dead rows sort last, so ids stay nondecreasing (K2's contract).
        gid = torch.where(s_live, _seg_id(new_part),
                          torch.full_like(idx, max(cap - 1, 0)))
        t = wx.fn.result_type()
        if t.is_string:
            out_cols.append(_eval_one_string(batch, wx, perm, inv, s_live,
                                             gid, idx, cap))
            continue
        data, valid = _eval_one(batch, wx, perm, s_live, new_part,
                                new_peer, seg_start, gid, idx, cap)
        # Sorted position p holds original row perm[p]; the result for
        # original row r is at sorted position inv[r].
        valid_orig = valid.index_select(0, inv) & mask
        data_orig = data.index_select(0, inv).to(torch_dtype(t))
        data_orig = torch.where(valid_orig, data_orig,
                                torch.zeros_like(data_orig))
        out_cols.append(DeviceColumn(t, data_orig, valid_orig))
    return DeviceBatch(tuple(out_cols), batch.num_rows,
                       rows_hint=batch.rows_hint, sel=batch.sel)


def _eval_one_string(batch, wx, perm, inv, s_live, gid, idx, cap):
    """String-typed window results. The variable-width payload never flows
    through the numeric window arithmetic: each branch computes, per output
    row, the ORIGINAL row index whose string is the answer, and one
    ``DeviceColumn.gather`` moves the (bytes, lengths) rows."""
    fn = wx.fn
    col = as_device_column(fn.child.eval(batch), batch)
    if isinstance(fn, (Lead, Lag)):
        off = fn.offset if isinstance(fn, Lead) else -fn.offset
        src = idx + off
        ok = (src >= 0) & (src < cap)
        src_c = src.clamp(0, cap - 1)
        same = gid.index_select(0, src_c) == gid
        struct = ok & same & s_live & s_live.index_select(0, src_c)
        src_orig = perm.index_select(0, src_c).index_select(0, inv)
        struct_orig = struct.index_select(0, inv)
    elif isinstance(fn, WindowAgg) and fn.kind in ("min", "max"):
        frame = fn.frame
        if not (frame.preceding is UNBOUNDED and
                frame.following is UNBOUNDED and
                not frame.running_with_peers):
            raise NotImplementedError(
                "string min/max window: whole-partition frames only")
        # A second sort by (partition keys, child bytes) makes each
        # partition's winner the first live row of its segment; nulls sort
        # last, so an all-null partition's head is itself null.
        spec2 = WindowSpec(wx.spec.partition_by,
                           [SortOrder(fn.child, ascending=fn.kind == "min",
                                      nulls_first=False)])
        perm2, s_live2, new_part2, _ = _sorted_frame(batch, spec2)
        inv2 = _inverse(perm2)
        head = _segment_starts(new_part2, cap)
        src_orig = perm2.index_select(0, head).index_select(0, inv2)
        struct_orig = s_live2.index_select(0, inv2)
    else:
        raise NotImplementedError(
            "string window results for %s" % type(fn).__name__)
    return col.gather(src_orig, struct_orig & batch.row_mask())


def _eval_one(batch, wx, perm, s_live, new_part, new_peer, seg_start, gid,
              idx, cap):
    fn = wx.fn
    if isinstance(fn, RowNumber):
        return idx - seg_start + 1, s_live
    if isinstance(fn, Rank):
        # First row index of the peer run, relative to segment start.
        peer_start = torch.cummax(
            torch.where(new_peer, idx, torch.zeros_like(idx)), 0).values
        return peer_start - seg_start + 1, s_live
    if isinstance(fn, DenseRank):
        # Count of peer boundaries within the segment up to current row.
        pb = torch.cumsum(new_peer.to(torch.int64), 0)
        return pb - pb.index_select(0, seg_start) + 1, s_live
    if isinstance(fn, (Lead, Lag)):
        col = as_device_column(fn.child.eval(batch), batch)
        sdata = col.data.index_select(0, perm)
        svalid = col.validity.index_select(0, perm) & s_live
        off = fn.offset if isinstance(fn, Lead) else -fn.offset
        src = idx + off
        ok = (src >= 0) & (src < cap)
        src_c = src.clamp(0, cap - 1)
        data = sdata.index_select(0, src_c)
        # Must stay inside the same partition.
        same = gid.index_select(0, src_c) == gid
        valid = svalid.index_select(0, src_c) & ok & same & s_live
        return data, valid
    if isinstance(fn, WindowAgg):
        return _eval_window_agg(batch, fn, perm, s_live, new_part,
                                new_peer, seg_start, gid, idx, cap, wx.spec)
    raise NotImplementedError(type(fn).__name__)


def _seg_lower_bound(oval, lo0, hi0, target, cap, inclusive):
    """Per-row binary search within [lo0, hi0): first index j with
    oval[j] >= target (inclusive=False) or > target (inclusive=True).
    oval is ascending inside each segment; the bounds confine each search
    to its row's segment."""
    lo, hi = lo0, hi0
    for _ in range(int(np.ceil(np.log2(max(cap, 2)))) + 1):
        mid = (lo + hi) // 2
        v = oval.index_select(0, mid.clamp(0, cap - 1))
        go_right = (v <= target) if inclusive else (v < target)
        active = lo < hi
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def _prefix_upto(cum: torch.Tensor, cnt: torch.Tensor, i: torch.Tensor,
                 cap: int):
    """(cum[i], cnt[i]) with 0 where i < 0: inclusive prefix sums."""
    c = cum.index_select(0, i.clamp(0, cap - 1))
    n = cnt.index_select(0, i.clamp(0, cap - 1))
    neg = i < 0
    return (torch.where(neg, torch.zeros_like(c), c),
            torch.where(neg, torch.zeros_like(n), n))


def _frame_sums(fn: WindowAgg, sdata, svalid):
    """(prefix sums of the values, prefix counts of valid rows) in the
    accumulator type of ``fn``'s sum/avg/count."""
    t = fn.result_type()
    acc = torch.float64 if t.is_floating or fn.kind == "avg" \
        else torch.int64
    cnt = torch.cumsum(svalid.to(torch.int64), 0)
    if fn.kind == "count":
        return cnt, cnt
    zero = torch.zeros((), dtype=acc, device=svalid.device)
    vals = torch.where(svalid, sdata.to(acc), zero)
    return torch.cumsum(vals, 0), cnt


def _finish_frame(fn: WindowAgg, s, n, s_live):
    if fn.kind == "count":
        return s.to(torch.int64), s_live
    if fn.kind == "avg":
        safe = torch.where(n > 0, n, torch.ones_like(n))
        return s / safe.to(torch.float64), s_live & (n > 0)
    return s.to(torch_dtype(fn.result_type())), s_live & (n > 0)


def _eval_window_agg(batch, fn: WindowAgg, perm, s_live, new_part, new_peer,
                     seg_start, gid, idx, cap, spec=None):
    if fn.child is not None:
        col = as_device_column(fn.child.eval(batch), batch)
        sdata = col.data.index_select(0, perm)
        svalid = col.validity.index_select(0, perm) & s_live
    else:
        sdata = torch.ones(cap, dtype=torch.int64, device=idx.device)
        svalid = s_live
    frame = fn.frame

    if frame.preceding is UNBOUNDED and frame.following is UNBOUNDED and \
            not frame.running_with_peers:
        # Whole partition: segment reduce, broadcast back by gid.
        return _whole_partition(fn, sdata, svalid, gid, cap)

    if frame.range_interval:
        return _eval_range_interval(batch, fn, sdata, svalid, perm, s_live,
                                    new_part, seg_start, idx, cap, spec)

    if fn.kind in ("sum", "avg", "count"):
        # Running / ROWS frames via prefix-sum differences.
        cum, cnt = _frame_sums(fn, sdata, svalid)
        if frame.running_with_peers:
            # Spark's default RANGE frame ends at each row's LAST peer.
            end = _run_ends(_last_marks(new_peer), cap)
        elif frame.following is UNBOUNDED:
            end = _run_ends(_last_marks(new_part), cap)
        else:
            seg_end = _run_ends(_last_marks(new_part), cap)
            end = torch.minimum(idx + frame.following, seg_end)
        if frame.preceding is UNBOUNDED:
            start = seg_start
        else:
            start = torch.maximum(idx - frame.preceding, seg_start)
        c_end, n_end = _prefix_upto(cum, cnt, end, cap)
        c_before, n_before = _prefix_upto(cum, cnt, start - 1, cap)
        # start - 1 may cross into the previous segment; clamp to it.
        c_start0, n_start0 = _prefix_upto(cum, cnt, seg_start - 1, cap)
        cross = start - 1 < seg_start
        c_before = torch.where(cross, c_start0, c_before)
        n_before = torch.where(cross, n_start0, n_before)
        return _finish_frame(fn, c_end - c_before, n_end - n_before, s_live)

    if fn.kind in ("min", "max"):
        # The whole-partition frame is handled above; what is left is the
        # running frame, which a segmented scan with a reset flag gives.
        if frame.preceding is not UNBOUNDED or frame.following != 0:
            raise NotImplementedError(
                "bounded-preceding min/max window frames")
        fill = kernels._identity_for(sdata, fn.kind)
        vals = torch.where(svalid, sdata, fill)
        scanned, ns = _segmented_running(
            fn.kind, new_part, vals, svalid.to(torch.int64))
        if frame.running_with_peers:
            end = _run_ends(_last_marks(new_peer), cap)
            scanned = scanned.index_select(0, end)
            ns = ns.index_select(0, end)
        return scanned, s_live & (ns > 0)
    raise NotImplementedError(fn.kind)


def _segmented_running(kind: str, flags: torch.Tensor, vals: torch.Tensor,
                       counts: torch.Tensor):
    """Inclusive segmented scan of (flag, value, count) under the
    reference's combine: a row that starts a segment resets the running
    min/max and count. A log-step (Hillis-Steele) scan: step d combines
    each row with the row d before it."""
    minmax = torch.minimum if kind == "min" else torch.maximum
    if vals.is_floating_point():
        def op(a, b):
            # A NaN operand propagates as it is, payload kept, as XLA's
            # min/max do (torch's make a new NaN).
            return torch.where(torch.isnan(a), a, torch.where(
                torch.isnan(b), b, minmax(a, b)))
    else:
        op = minmax
    n = flags.shape[0]
    d = 1
    while d < n:
        a_f, a_v, a_n = flags[:-d], vals[:-d], counts[:-d]
        b_f, b_v, b_n = flags[d:], vals[d:], counts[d:]
        vals = torch.cat([vals[:d], torch.where(b_f, b_v, op(a_v, b_v))])
        counts = torch.cat([counts[:d], torch.where(b_f, b_n, a_n + b_n)])
        flags = torch.cat([flags[:d], a_f | b_f])
        d *= 2
    if vals.is_floating_point():
        # The reference's associative_scan interleaves its halves by
        # adding zero-padded arrays, which turns every -0.0 into +0.0.
        vals = vals + 0.0
    return vals, counts


def _eval_range_interval(batch, fn: WindowAgg, sdata, svalid, perm,
                         s_live, new_part, seg_start, idx, cap, spec):
    """RANGE BETWEEN (val - preceding) AND (val + following): frame bounds
    found by a segment-confined binary search per row over the (sorted)
    order-column values, then prefix-sum differences. One integer
    (date/time) order column, ascending."""
    assert spec is not None and len(spec.order_by) == 1, \
        "range-interval frames require exactly one order column"
    o = spec.order_by[0]
    assert o.ascending, "range-interval frames require ascending order"
    if fn.kind not in ("sum", "avg", "count"):
        raise NotImplementedError("range-interval min/max window frames")
    ocol = as_device_column(o.child.eval(batch), batch)
    oval = ocol.data.index_select(0, perm).to(torch.int64)
    seg_end = _run_ends(_last_marks(new_part), cap)
    if fn.frame.preceding is UNBOUNDED:
        start = seg_start
    else:
        # First index in the segment with oval >= cur - preceding.
        start = _seg_lower_bound(oval, seg_start, seg_end + 1,
                                 oval - fn.frame.preceding, cap,
                                 inclusive=False)
    if fn.frame.following is UNBOUNDED:
        end = seg_end
    else:
        # Last index in the segment with oval <= cur + following.
        end = _seg_lower_bound(oval, seg_start, seg_end + 1,
                               oval + fn.frame.following, cap,
                               inclusive=True) - 1
    cum, cnt = _frame_sums(fn, sdata, svalid)
    c_end, n_end = _prefix_upto(cum, cnt, end, cap)
    c_before, n_before = _prefix_upto(cum, cnt, start - 1, cap)
    empty = end < start
    s = torch.where(empty, torch.zeros_like(c_end), c_end - c_before)
    n = torch.where(empty, torch.zeros_like(n_end), n_end - n_before)
    return _finish_frame(fn, s, n, s_live)


def _whole_partition(fn: WindowAgg, sdata, svalid, gid, cap):
    """Segment reductions (K2 on the card for every count, integer sum
    and min/max; a scatter-add for float sums), broadcast back by gid."""
    if fn.kind == "count":
        agg = kernels._seg_sum(svalid.to(torch.int64), gid, cap)
        return agg.index_select(0, gid), torch.ones_like(svalid)
    if fn.kind in ("sum", "avg"):
        t = fn.result_type()
        acc = torch.float64 if fn.kind == "avg" or t.is_floating \
            else torch.int64
        agg, counts = kernels.segment_reduce(sdata.to(acc), svalid, gid,
                                             cap, "sum")
        n = counts.index_select(0, gid)
        s = agg.index_select(0, gid)
        if fn.kind == "avg":
            safe = torch.where(n > 0, n, torch.ones_like(n))
            return s / safe.to(torch.float64), n > 0
        return s.to(torch_dtype(t)), n > 0
    agg, counts = kernels.segment_reduce(sdata, svalid, gid, cap, fn.kind)
    return agg.index_select(0, gid), counts.index_select(0, gid) > 0


# ---------------------------------------------------------------------------
# Exec
# ---------------------------------------------------------------------------

class WindowExec(Exec):
    """Appends window expression columns. The device half evaluates over
    the partition's batches coalesced into one (every window partition
    must lie in one batch); the host half over their concatenation."""

    def __init__(self, child: Exec, exprs: Sequence[WindowExprSpec]):
        super().__init__(child)
        self.exprs = list(exprs)

    @property
    def schema(self) -> Schema:
        base = list(self.children[0].schema)
        for wx in self.exprs:
            base.append((wx.name, wx.fn.result_type()))
        return tuple(base)

    def execute_device(self, ctx, partition):
        m = ctx.metrics_for(self)
        batches = list(self.children[0].execute_device(ctx, partition))
        if not batches:
            return
        with timed(m):
            out = compute_window(coalesce_to_single_batch(batches),
                                 self.exprs)
        record_batch(m, out)
        yield out

    def execute_host(self, ctx, partition):
        hbs = list(self.children[0].execute_host(ctx, partition))
        if not hbs:
            return
        yield _host_window(concat_host_batches(hbs), self.exprs,
                           self.schema)


# ---------------------------------------------------------------------------
# Host engine (numpy copies of the reference's)
# ---------------------------------------------------------------------------

def _host_window_vectorized(hb: HostBatch, wx) -> Optional[HostColumn]:
    """One window expression evaluated with the lexsort/segment-boundary
    machinery of the vectorized host group-by: one stable lexsort over
    (partition codes, order-key codes), partition/peer boundary flags,
    then ranks as positions-in-segment, Lead/Lag as clamped shifted
    gathers, and frame aggregates as prefix-sum differences. Results come
    back through the inverse permutation so output rows keep input order.
    Returns None for shapes the python oracle below owns (min/max over
    bounded frames, string agg inputs, NaN sums, descending or
    null-bearing range frames)."""
    n = hb.num_rows
    fn = wx.fn
    if n == 0:
        return None
    pcols = [as_host_column(e.eval_host(hb), hb)
             for e in wx.spec.partition_by]
    ocols = [(as_host_column(o.child.eval_host(hb), hb), o)
             for o in wx.spec.order_by]
    ccol = None
    if isinstance(fn, (Lead, Lag, WindowAgg)) and \
            getattr(fn, "child", None) is not None:
        ccol = as_host_column(fn.child.eval_host(hb), hb)

    part_planes = []
    for c in pcols:
        part_planes.append((encode_key(c),
                            np.asarray(c.validity, np.int8)))
    okey_planes = []
    for c, o in ocols:
        valid = np.asarray(c.validity, np.bool_)
        null_rank = (valid if o.nulls_first else ~valid).astype(np.int8)
        code = encode_sort_key(c)
        if not o.ascending:
            code = np.where(valid, ~code, np.int64(0))
        okey_planes.append((null_rank, code))

    # Most-significant first; np.lexsort takes least-significant first.
    sig = []
    for code, val in part_planes:
        sig.append(code)
        sig.append(val)
    for null_rank, code in okey_planes:
        sig.append(null_rank)
        sig.append(code)
    if sig:
        order_idx = np.lexsort(tuple(reversed(sig)))
    else:
        order_idx = np.arange(n, dtype=np.int64)

    pos = np.arange(n, dtype=np.int64)
    seg_flags = np.zeros(n, np.bool_)
    seg_flags[0] = True
    for code, val in part_planes:
        sc, sv = code[order_idx], val[order_idx]
        seg_flags[1:] |= (sc[1:] != sc[:-1]) | (sv[1:] != sv[:-1])
    starts = np.flatnonzero(seg_flags).astype(np.int64)
    seg_len = np.diff(np.append(starts, n))
    seg_start = np.repeat(starts, seg_len)
    seg_end = np.repeat(starts + seg_len - 1, seg_len)
    r_local = pos - seg_start

    change = seg_flags.copy()
    for null_rank, code in okey_planes:
        snr, sc = null_rank[order_idx], code[order_idx]
        change[1:] |= (snr[1:] != snr[:-1]) | (sc[1:] != sc[:-1])
    rb = np.flatnonzero(change).astype(np.int64)
    run_len = np.diff(np.append(rb, n))
    peer_start = np.repeat(rb, run_len)
    peer_end = np.repeat(rb + run_len - 1, run_len)

    inv = np.empty(n, np.int64)
    inv[order_idx] = pos

    def out_numeric(t, data, validity):
        return HostColumn(t, np.where(validity, data, 0)
                          .astype(t.np_dtype),
                          np.asarray(validity, np.bool_)).take(inv)

    t = fn.result_type()
    if isinstance(fn, RowNumber):
        return out_numeric(t, r_local + 1, host_all_valid(n))
    if isinstance(fn, DenseRank):
        d = np.cumsum(change)
        dense = d - np.repeat(d[starts], seg_len) + 1
        return out_numeric(t, dense, host_all_valid(n))
    if isinstance(fn, Rank):
        return out_numeric(t, peer_start - seg_start + 1,
                           host_all_valid(n))
    if isinstance(fn, (Lead, Lag)):
        off = fn.offset if isinstance(fn, Lead) else -fn.offset
        tgt = pos + off
        inrange = (tgt >= seg_start) & (tgt <= seg_end)
        idx = np.where(inrange, order_idx[np.clip(tgt, 0, n - 1)],
                       np.int64(-1))
        return ccol.take(idx, null_on_negative=True).take(inv)
    if not isinstance(fn, WindowAgg):
        return None

    frame = fn.frame
    kind = fn.kind
    if ccol is not None and ccol.dtype.is_string and kind != "count":
        return None
    # Frame bounds as global [lo, hi] row ranges per row.
    if frame.running_with_peers:
        lo, hi = seg_start, peer_end
    elif frame.preceding is UNBOUNDED and frame.following is UNBOUNDED:
        lo, hi = seg_start, seg_end
    elif frame.range_interval:
        if not ocols:
            return None
        oc, oo = ocols[0]
        if (not oo.ascending or oc.dtype.is_string
                or not np.asarray(oc.validity, np.bool_).all()):
            return None
        ov = np.asarray(oc.data, np.float64)[order_idx]
        cur = ov                                  # current row's value
        lo = seg_start.copy()
        hi = seg_end.copy()
        for s0, sl in zip(starts.tolist(), seg_len.tolist()):
            s1 = s0 + sl
            vals_seg = ov[s0:s1]
            if frame.preceding is not UNBOUNDED:
                lo[s0:s1] = s0 + np.searchsorted(
                    vals_seg, cur[s0:s1] - frame.preceding, "left")
            if frame.following is not UNBOUNDED:
                hi[s0:s1] = s0 + np.searchsorted(
                    vals_seg, cur[s0:s1] + frame.following, "right") - 1
    else:
        lo = seg_start if frame.preceding is UNBOUNDED else \
            np.maximum(seg_start, pos - frame.preceding)
        hi = seg_end if frame.following is UNBOUNDED else \
            np.minimum(seg_end, pos + frame.following)

    empty = hi < lo
    loc = np.clip(lo, 0, n)
    hic = np.clip(hi + 1, 0, n)

    def prefix(x):
        return np.concatenate([np.zeros(1, x.dtype), np.cumsum(x)])

    if ccol is not None:
        cvalid = np.asarray(ccol.validity, np.bool_)[order_idx]
    else:
        cvalid = host_all_valid(n)
    Pc = prefix(cvalid.astype(np.int64))
    cnt = np.where(empty, 0, Pc[hic] - Pc[loc])

    if kind == "count":
        total = np.where(empty, 0, hi - lo + 1)
        data = cnt if ccol is not None else total
        return out_numeric(t, data, host_all_valid(n))

    if kind in ("sum", "avg"):
        x = np.asarray(ccol.data)[order_idx]
        if t.is_floating or kind == "avg":
            xf = np.where(cvalid, x.astype(np.float64), 0.0)
            if np.isnan(xf).any():
                # A prefix-sum difference leaks NaN into every frame
                # after the NaN (cumsum is global); the oracle sums
                # only the frame's own rows.
                return None
            P = prefix(xf)
        else:
            with np.errstate(over="ignore"):
                P = prefix(np.where(cvalid, x.astype(np.int64),
                                    np.int64(0)))
        s = np.where(empty, 0, P[hic] - P[loc])
        ok = cnt > 0
        if kind == "avg":
            data = np.where(ok, s / np.where(ok, cnt, 1), 0.0)
        else:
            data = np.where(ok, s, 0)
        return out_numeric(t, data, ok)

    # min/max: only the whole-segment frame vectorizes (a prefix trick
    # does not exist for range min); bounded frames stay on the oracle.
    if not (np.array_equal(lo, seg_start) and np.array_equal(hi, seg_end)):
        return None
    x = np.asarray(ccol.data)[order_idx]
    ok = np.add.reduceat(cvalid.astype(np.int64), starts) > 0
    if ccol.dtype.is_floating:
        f = x.astype(np.float64)
        nanm = cvalid & np.isnan(f)
        nonnan = cvalid & ~np.isnan(f)
        if kind == "max":
            m = np.maximum.reduceat(np.where(nonnan, f, -np.inf), starts)
            hasnan = np.add.reduceat(nanm.astype(np.int64), starts) > 0
            data_g = np.where(hasnan, np.nan, m)
        else:
            m = np.minimum.reduceat(np.where(nonnan, f, np.inf), starts)
            nncnt = np.add.reduceat(nonnan.astype(np.int64), starts)
            data_g = np.where(nncnt > 0, m, np.nan)
        data_g = np.where(ok, data_g, 0.0)
    else:
        xi64 = x.astype(np.int64)
        if kind == "max":
            data_g = np.maximum.reduceat(
                np.where(cvalid, xi64, np.iinfo(np.int64).min), starts)
        else:
            data_g = np.minimum.reduceat(
                np.where(cvalid, xi64, np.iinfo(np.int64).max), starts)
        data_g = np.where(ok, data_g, 0)
    data = np.repeat(data_g, seg_len)
    validity = np.repeat(ok, seg_len)
    return out_numeric(t, data, validity)


class _Rev:
    """Reverses comparison for descending host sort keys."""

    def __init__(self, v):
        self.v = v

    def __eq__(self, other):
        return self.v == other.v

    def __lt__(self, other):
        return other.v < self.v


def _host_window(hb: HostBatch, exprs, schema) -> HostBatch:
    """Host window: vectorized per expression, python oracle fallback."""
    n = hb.num_rows
    out_cols = {i: [None] * n for i in range(len(exprs))}
    for xi, wx in enumerate(exprs):
        fast = _host_window_vectorized(hb, wx)
        if fast is not None:
            out_cols[xi] = fast
            continue
        pcols = [as_host_column(e.eval_host(hb), hb).to_list()
                 for e in wx.spec.partition_by]
        ocols = [(as_host_column(o.child.eval_host(hb), hb).to_list(), o)
                 for o in wx.spec.order_by]
        ccol = None
        if isinstance(wx.fn, (Lead, Lag, WindowAgg)) and \
                getattr(wx.fn, "child", None) is not None:
            ccol = as_host_column(wx.fn.child.eval_host(hb), hb).to_list()

        def canon(v):
            if isinstance(v, float):
                if np.isnan(v):
                    return "NaN"
                if v == 0:
                    return 0.0
            return v

        def order_key(i):
            parts = []
            for vals, o in ocols:
                v = vals[i]
                null_rank = 0 if (v is None) == o.nulls_first else 1
                if v is None:
                    parts.append((null_rank, 0))
                else:
                    k = v
                    if isinstance(v, float):
                        k = (1, 0.0) if np.isnan(v) else (0, v)
                    parts.append((null_rank,
                                  k if o.ascending else _Rev(k)))
            return tuple(parts)

        groups = {}
        for i in range(n):
            key = tuple(canon(pc[i]) for pc in pcols)
            groups.setdefault(key, []).append(i)
        for key, idxs in groups.items():
            idxs = sorted(idxs, key=order_key)
            peers = []
            prev = object()
            for rank_i, i in enumerate(idxs):
                ok = order_key(i)
                if ok != prev:
                    peers.append(rank_i)
                    prev = ok
                else:
                    peers.append(peers[-1])
            ovals = ocols[0][0] if ocols else None
            out_cols[xi] = _host_eval_fn(
                wx.fn, idxs, peers, ccol, out_cols[xi], ovals)
    cols = list(hb.columns)
    for xi, wx in enumerate(exprs):
        if isinstance(out_cols[xi], HostColumn):
            cols.append(out_cols[xi])
        else:
            t = wx.fn.result_type()
            cols.append(HostColumn.from_values(t, out_cols[xi]))
    return HostBatch(tuple(n_ for n_, _ in schema), cols)


def _host_eval_fn(fn, idxs, peers, ccol, out, ovals=None):
    npart = len(idxs)
    if isinstance(fn, RowNumber):
        for r, i in enumerate(idxs):
            out[i] = r + 1
    elif isinstance(fn, Rank):
        for r, i in enumerate(idxs):
            out[i] = peers[r] + 1
    elif isinstance(fn, DenseRank):
        dense = []
        d = 0
        for r in range(npart):
            if r == 0 or peers[r] != peers[r - 1]:
                d += 1
            dense.append(d)
        for r, i in enumerate(idxs):
            out[i] = dense[r]
    elif isinstance(fn, (Lead, Lag)):
        off = fn.offset if isinstance(fn, Lead) else -fn.offset
        for r, i in enumerate(idxs):
            s = r + off
            out[i] = ccol[idxs[s]] if 0 <= s < npart else None
    elif isinstance(fn, WindowAgg):
        for r, i in enumerate(idxs):
            frame = fn.frame
            if frame.running_with_peers:
                hi = r
                while hi + 1 < npart and peers[hi + 1] == peers[r]:
                    hi += 1
                lo = 0
            elif frame.preceding is UNBOUNDED and \
                    frame.following is UNBOUNDED:
                lo, hi = 0, npart - 1
            elif frame.range_interval:
                cur = ovals[i]
                lo, hi = 0, npart - 1
                if frame.preceding is not UNBOUNDED:
                    lo = npart
                    for s in range(npart):
                        if ovals[idxs[s]] >= cur - frame.preceding:
                            lo = s
                            break
                if frame.following is not UNBOUNDED:
                    hi = -1
                    for s in range(npart - 1, -1, -1):
                        if ovals[idxs[s]] <= cur + frame.following:
                            hi = s
                            break
            else:
                lo = 0 if frame.preceding is UNBOUNDED else \
                    max(0, r - frame.preceding)
                hi = npart - 1 if frame.following is UNBOUNDED else \
                    min(npart - 1, r + frame.following)
            vals = [1 if ccol is None else ccol[idxs[s]]
                    for s in range(lo, hi + 1)]
            nn = [v for v in vals if v is not None]
            if fn.kind == "count":
                out[i] = len(nn) if ccol is not None else len(vals)
            elif not nn:
                out[i] = None
            elif fn.kind == "sum":
                out[i] = float(np.sum(np.asarray(nn, np.float64))) \
                    if fn.result_type().is_floating else int(sum(nn))
            elif fn.kind == "avg":
                out[i] = float(np.sum(np.asarray(nn, np.float64)) / len(nn))
            elif fn.kind == "min":
                non_nan = [v for v in nn if not (
                    isinstance(v, float) and np.isnan(v))]
                out[i] = min(non_nan) if non_nan else float("nan")
            elif fn.kind == "max":
                has_nan = any(isinstance(v, float) and np.isnan(v)
                              for v in nn)
                out[i] = float("nan") if has_nan else max(nn)
    return out
