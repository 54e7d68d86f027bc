"""Broadcast hash join (port of the JAX package's ``ops/join.py``:
``BuiltSide``, ``build_side``, the dense direct-address table,
``_pair_keys_equal``, ``probe_ranges``, ``expand_pairs``, the join kernel
mixin and ``BroadcastHashJoinExec``).

A sort-probe join over key fingerprints, as in the reference:

  build side: fingerprint the build keys (two murmur3 streams,
      ``kernels.key_fingerprint``) into one u64, sort the build rows by it
      in unsigned order; rows that can never match (null keys, dead rows)
      carry the sentinel 0xFFFF_FFFF_FFFF_FFFF and sort last. One pull of a
      small stats vector per build gives the longest run of equal
      fingerprints and, for integral keys, their range.
  probe side, one of three paths per build:
      dense  - unique integral keys spanning under 2^24 values: a direct
               table maps key -> build row, one gather per probe batch;
      fast   - runs of at most 4: the two binary searches (kernel K3 on
               the card), then pair expansion into probe_cap * max_run
               slots with no host sync;
      synced - longer runs: the same searches, one host sync for the pair
               count, then the expansion.
  Expanded pairs are checked key against key (a fingerprint range is a
  candidate only), then a residual condition, then the join type's
  emission.

A u64 fingerprint is carried as the int64 tensor of its bit pattern; it is
sorted as ``fp ^ (1 << 63)`` so signed order is unsigned order.

The port runs every step eagerly: the JAX package's kernel cache, its
out-of-memory retry and its jit/eager split have no counterpart here. Join
types: inner, left, right, semi (left semi) and anti (left anti), each with
an optional residual condition. Full outer and cross joins, the shuffled
and nested-loop execs and grace partitioning come in later slices.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, DeviceColumn, bucket_capacity, coalesce_iter,
    concat_batches, flush_subnormal, string_repad)
from spark_rapids_tpu_torch.columnar.rowmove import gather_rows
from spark_rapids_tpu_torch.exprs.base import (
    BoundReference, Expression, as_device_column)
from spark_rapids_tpu_torch.ops import kernels, native
from spark_rapids_tpu_torch.ops.base import (
    Exec, Schema, record_batch, timed)
from spark_rapids_tpu_torch.ops.sort import coalesce_to_single_batch

JOIN_TYPES = ("inner", "left", "right", "semi", "anti")

_INT64_MIN = -(1 << 63)
_SENTINEL = -1                  # 0xFFFF_FFFF_FFFF_FFFF as an int64 pattern

# Dense tables beyond this many entries are not worth the device memory
# (64 MB of int32).
_DENSE_TABLE_MAX = 1 << 24

# Fast-path bound: with max_run <= this, a probe batch's output capacity is
# probe_cap * max_run with no per-batch size sync.
_FAST_PATH_MAX_RUN = 4


# ---------------------------------------------------------------------------
# Build side
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BuiltSide:
    """Build rows sorted by key fingerprint, ready for probing.

    ``stats`` is a small int64 device vector, [max_run, int_keys_ok,
    kmin..., kmax...], pulled to the host once per build
    (:meth:`stats_host`): max_run sizes the fast path, the key range
    decides the dense table. ``table`` (built lazily) maps dense key
    offsets to build rows."""

    batch: DeviceBatch              # rows in fingerprint-sorted order
    fp: torch.Tensor                # (cap,) int64: sorted u64 fingerprints
    matchable: torch.Tensor         # (cap,) bool: live with non-null keys
    key_ordinals: List[int]
    stats: Optional[torch.Tensor] = None
    table: Optional[torch.Tensor] = None       # (size,) int32, -1 = none
    table_base: Optional[Tuple[int, ...]] = None   # kmin per key
    table_spans: Optional[Tuple[int, ...]] = None  # span per key
    host_stats: Optional[List[int]] = None

    def stats_host(self) -> Optional[List[int]]:
        """The stats vector on the host, pulled at most once: a broadcast
        build serves every probe partition."""
        if self.host_stats is None and self.stats is not None:
            self.host_stats = [int(x) for x in self.stats.tolist()]
        return self.host_stats


def _fingerprint64(batch: DeviceBatch, key_ordinals) -> torch.Tensor:
    """(ha << 32) | hb as an int64 bit pattern."""
    ha, hb = kernels.key_fingerprint(
        [batch.columns[i] for i in key_ordinals], batch.capacity)
    return (ha << 32) | hb


def build_side(batch: DeviceBatch, key_ordinals: Sequence[int]) -> BuiltSide:
    """Sort build rows by fingerprint. Rows with a null key never match
    (SQL equi-join) and sort last with the sentinel, after them the dead
    rows."""
    fp = _fingerprint64(batch, key_ordinals)
    row_live = batch.row_mask()
    matchable = row_live
    for i in key_ordinals:
        matchable = matchable & batch.columns[i].validity
    key = torch.where(matchable, fp, torch.full_like(fp, _SENTINEL))
    perm = torch.sort(key ^ _INT64_MIN, stable=True).indices
    s_live = row_live.index_select(0, perm)
    sorted_batch = gather_rows(batch, perm, batch.num_rows, valid_dst=s_live)
    s_fp = key.index_select(0, perm)
    s_match = matchable.index_select(0, perm)
    # Longest run of equal sorted fingerprints among matchable rows (the
    # sentinel run is excluded through s_match). Each row's run start is
    # the JAX package's running max of start positions; here it is found
    # by run id (a cumsum), a scatter of each run's start and a gather,
    # because torch.cummax took a third of q4's device time on the card.
    cap = batch.capacity
    idx = torch.arange(cap, dtype=torch.int64, device=fp.device)
    starts = torch.ones(cap, dtype=torch.bool, device=fp.device)
    starts[1:] = s_fp[1:] != s_fp[:-1]
    run_id = torch.cumsum(starts, 0) - 1
    run_start = torch.zeros(cap + 1, dtype=torch.int64, device=fp.device)
    run_start[torch.where(starts, run_id, cap)] = idx
    last_start = run_start.index_select(0, run_id)
    max_run = torch.where(s_match, idx - last_start + 1, 0).max()
    # Key range for the dense decision: all-integral keys only.
    int_ok = all(batch.columns[i].dtype.is_integral
                 or batch.columns[i].dtype.name == "date"
                 for i in key_ordinals)
    mins: List[torch.Tensor] = []
    maxs: List[torch.Tensor] = []
    if int_ok:
        for i in key_ordinals:
            c = batch.columns[i]
            v = c.data.to(torch.int64)
            ok = matchable & c.validity
            mins.append(torch.where(ok, v, 2 ** 62).min())
            maxs.append(torch.where(ok, v, -2 ** 62).max())
    stats = None
    if key_ordinals:
        stats = torch.stack([max_run, torch.tensor(int(int_ok),
                                                   device=fp.device)]
                            + mins + maxs)
    return BuiltSide(sorted_batch, s_fp, s_match, list(key_ordinals), stats)


def _maybe_build_dense(built: BuiltSide) -> None:
    """Attach a direct-address table when the integral build keys are
    unique and span a small dense range (every TPC-H dimension join
    qualifies). Idempotent: a broadcast build is shared across probe
    partitions and builds its table once."""
    if built.stats is None or built.table is not None:
        return
    st = built.stats_host()
    max_run, int_ok = st[0], st[1]
    if not int_ok or max_run > 1:
        return
    k = len(built.key_ordinals)
    mins, maxs = st[2:2 + k], st[2 + k:2 + 2 * k]
    if any(mx < mn for mn, mx in zip(mins, maxs)):
        return          # no matchable rows
    spans = [mx - mn + 1 for mn, mx in zip(mins, maxs)]
    size = 1
    for s in spans:
        size *= s
        if size > _DENSE_TABLE_MAX:
            return
    # The table indexes the fingerprint-sorted batch, which every path
    # gathers from.
    b = built.batch
    dev = built.fp.device
    combined = torch.zeros(b.capacity, dtype=torch.int64, device=dev)
    for i, o in enumerate(built.key_ordinals):
        v = b.columns[o].data.to(torch.int64) - mins[i]
        combined = combined * spans[i] + v
    # Unmatchable rows (and anything out of range) are dropped: they go to
    # one extra slot that is sliced off.
    pos = torch.where(built.matchable & (combined >= 0) & (combined < size),
                      combined, size)
    table = torch.full((size + 1,), -1, dtype=torch.int32, device=dev)
    table[pos] = torch.arange(b.capacity, dtype=torch.int32, device=dev)
    built.table = table[:size]
    built.table_base = tuple(mins)
    built.table_spans = tuple(spans)


# ---------------------------------------------------------------------------
# Probe
# ---------------------------------------------------------------------------

def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(t, idx, axis=0, mode="clip")``."""
    return t.index_select(0, idx.long().clamp(0, t.shape[0] - 1))


def _pair_keys_equal(built: BuiltSide, b_idx: torch.Tensor,
                     probe: DeviceBatch, p_idx: torch.Tensor,
                     probe_ordinals: Sequence[int],
                     base: torch.Tensor) -> torch.Tensor:
    """Actual key equality of candidate (probe, build) pairs: a fingerprint
    range is a candidate only (a 64-bit collision, or a fingerprint equal
    to the sentinel, would otherwise join wrong rows). Float keys follow
    Spark's join-key semantics: NaN == NaN, -0.0 == 0.0, and a subnormal
    equals the zero of its sign as in the reference."""
    eq = base
    for bo, po in zip(built.key_ordinals, probe_ordinals):
        bc = built.batch.columns[bo]
        pc = probe.columns[po]
        bv = _take(bc.validity, b_idx)
        pv = _take(pc.validity, p_idx)
        if bc.dtype.is_string:
            w = max(bc.string_width, pc.string_width)
            bcw, pcw = string_repad(bc, w), string_repad(pc, w)
            data_eq = (_take(bcw.lengths, b_idx) == _take(pcw.lengths, p_idx)) \
                & (_take(bcw.data, b_idx) == _take(pcw.data, p_idx)).all(dim=1)
        else:
            bd = _take(bc.data, b_idx)
            pd = _take(pc.data, p_idx)
            if bd.is_floating_point():
                bd, pd = flush_subnormal(bd), flush_subnormal(pd)
                data_eq = (bd == pd) | (torch.isnan(bd) & torch.isnan(pd))
            else:
                data_eq = bd == pd
        eq = eq & bv & pv & data_eq
    return eq


def probe_ranges(built: BuiltSide, probe: DeviceBatch,
                 key_ordinals: Sequence[int]):
    """Per-probe-row match range [lo, lo + count) in the sorted build side:
    ``native.searchsorted_u64_pair`` (kernel K3 on the card). Rows that
    are dead or have a null key get count 0."""
    fp = _fingerprint64(probe, key_ordinals)
    plive = probe.row_mask()
    for i in key_ordinals:
        plive = plive & probe.columns[i].validity
    lo, hi = native.searchsorted_u64_pair(built.fp, fp)
    counts = torch.where(plive, hi - lo, 0)
    return lo, counts, plive


def expand_pairs(lo: torch.Tensor, counts: torch.Tensor, out_cap: int,
                 probe_cap: int):
    """Map output slots to (probe_row, build_row) pairs.

    offsets = exclusive cumsum(counts); slot s belongs to probe row
    p = upper_bound(offsets, s) - 1 and build row lo[p] + (s - offsets[p]).
    Returns (p, b, valid, num_rows): ``num_rows`` is the pair count clamped
    to ``out_cap``."""
    c64 = counts.to(torch.int64)
    offsets = torch.cumsum(c64, 0) - c64
    num_rows = c64.sum().clamp(max=out_cap).to(torch.int32)
    slots = torch.arange(out_cap, dtype=torch.int64, device=lo.device)
    p = torch.searchsorted(offsets, slots, side="right") - 1
    p = p.clamp(0, probe_cap - 1)
    within = slots - offsets.index_select(0, p)
    b = lo.to(torch.int64).index_select(0, p) + within
    valid = slots < num_rows
    return p, b, valid, num_rows


def _join_schema(left: Schema, right: Schema, join_type: str) -> Schema:
    if join_type in ("semi", "anti"):
        return tuple(left)
    return tuple(left) + tuple(right)


def _empty_like(schema: Schema, device) -> DeviceBatch:
    return DeviceBatch(tuple(DeviceColumn.full_null(t, 8, device=device)
                             for _, t in schema),
                       torch.zeros((), dtype=torch.int32, device=device))


class _JoinKernelMixin:
    """Device join over a built (single-batch) build side and a streamed
    probe side. Subclasses decide which input is which."""

    join_type: str
    condition: Optional[Expression]

    def _dense_step(self, built: BuiltSide, pbatch: DeviceBatch,
                    probe_keys, build_is_right: bool) -> DeviceBatch:
        """Direct-address probe: one table gather decides every probe
        row's build match. Emits a selection-vector batch: no expansion,
        no size sync, no compaction."""
        jt = self.join_type
        cond = self.condition
        base, spans = built.table_base, built.table_spans
        size = built.table.shape[0]
        plive = pbatch.row_mask()
        combined = torch.zeros(pbatch.capacity, dtype=torch.int64,
                               device=plive.device)
        inrange = plive
        for i, o in enumerate(probe_keys):
            c = pbatch.columns[o]
            v = c.data.to(torch.int64)
            inrange = inrange & c.validity & (v >= base[i]) \
                & (v < base[i] + spans[i])
            combined = combined * spans[i] + (v - base[i])
        pos = built.table.index_select(0, combined.clamp(0, size - 1))
        found = inrange & (pos >= 0)
        if jt in ("semi", "anti") and cond is None:
            keep = found if jt == "semi" else ~found
            return pbatch.with_sel(keep & plive)
        bsafe = pos.clamp(0, built.batch.capacity - 1)
        build_out = gather_rows(built.batch, bsafe, pbatch.num_rows,
                                valid_dst=found)
        if build_is_right:
            cols = tuple(pbatch.columns) + tuple(build_out.columns)
        else:
            cols = tuple(build_out.columns) + tuple(pbatch.columns)
        pairs = DeviceBatch(cols, pbatch.num_rows)
        matched = found
        if cond is not None:
            c = as_device_column(cond.eval(pairs), pairs)
            matched = matched & c.data & c.validity
        if jt == "inner":
            return pairs.with_sel(matched & plive)
        if jt in ("semi", "anti"):
            keep = matched if jt == "semi" else ~matched
            return pbatch.with_sel(keep & plive)
        # left/right outer: every live probe row survives; the build side
        # is NULL where unmatched (the gather nulled not-found rows, a
        # failed condition re-nulls here).
        if cond is not None:
            nulled = tuple(c.with_validity(c.validity & matched)
                           for c in build_out.columns)
            if build_is_right:
                cols = tuple(pbatch.columns) + nulled
            else:
                cols = nulled + tuple(pbatch.columns)
            pairs = DeviceBatch(cols, pbatch.num_rows)
        return pairs.with_sel(plive)

    def _device_join_stream(self, ctx, built: BuiltSide, probe_iter,
                            probe_keys, build_is_right: bool):
        # Coalesce the probe stream (compacting sparse members first): a
        # probe batch costs launches whatever its size.
        probe_iter = coalesce_iter(probe_iter,
                                   int(ctx.conf.get(C.BATCH_SIZE_ROWS)),
                                   int(ctx.conf.get(C.BATCH_SIZE_BYTES)))
        # One sync per build: the stats sized the fast path and decide the
        # dense table.
        mr = built.stats_host()[0] if built.stats is not None else None
        if mr is not None:
            _maybe_build_dense(built)
        if built.table is not None:
            for pbatch in probe_iter:
                yield self._dense_step(built, pbatch, probe_keys,
                                       build_is_right)
            return
        fast = mr is not None and 0 < mr <= _FAST_PATH_MAX_RUN
        for pbatch in probe_iter:
            # (Semi/anti expand too: candidate ranges must be key-checked
            # before deciding hit or miss.)
            lo, counts, plive = probe_ranges(built, pbatch, probe_keys)
            if fast:
                out_cap = bucket_capacity(max(pbatch.capacity * mr, 1))
            else:
                total = int(counts.sum())
                out_cap = bucket_capacity(max(total, 1))
            yield self._emit_expanded(built, pbatch, lo, counts, out_cap,
                                      build_is_right, probe_keys)

    def _emit_expanded(self, built: BuiltSide, pbatch: DeviceBatch, lo,
                       counts, out_cap: int, build_is_right: bool,
                       probe_keys) -> DeviceBatch:
        """Expand the matches of one probe batch and emit by join type."""
        jt = self.join_type
        cond = self.condition
        probe_cap = pbatch.capacity
        p, b, valid, total = expand_pairs(lo, counts, out_cap, probe_cap)
        valid = _pair_keys_equal(built, b, pbatch, p, probe_keys, valid)
        probe_out = gather_rows(pbatch, p, total, valid_dst=valid)
        build_out = gather_rows(built.batch, b, total, valid_dst=valid)
        if build_is_right:
            cols = tuple(probe_out.columns) + tuple(build_out.columns)
        else:
            cols = tuple(build_out.columns) + tuple(probe_out.columns)
        pairs = DeviceBatch(cols, total)
        cond_keep = valid
        if cond is not None:
            c = as_device_column(cond.eval(pairs), pairs)
            cond_keep = c.data & c.validity & valid
        if jt == "inner":
            return pairs.with_sel(cond_keep)
        # Per probe row: did any pair survive? (segment max over p)
        hit = torch.zeros(probe_cap, dtype=torch.int32, device=p.device) \
            .scatter_reduce(0, p, cond_keep.to(torch.int32), "amax") > 0
        if jt in ("semi", "anti"):
            keep = (hit if jt == "semi" else ~hit) & pbatch.row_mask()
            return pbatch.with_sel(keep)
        # Outer joins: surviving pairs, then unmatched probe rows with a
        # NULL build side.
        survivors = pairs.with_sel(cond_keep)
        extra = self._null_extend(pbatch, ~hit & pbatch.row_mask(),
                                  built.batch, build_is_right)
        return concat_batches([survivors, extra], bucket_capacity(
            survivors.capacity + extra.capacity))

    @staticmethod
    def _null_extend(pbatch: DeviceBatch, keep, build_batch: DeviceBatch,
                     build_is_right: bool) -> DeviceBatch:
        """Probe rows with a NULL build side (selection vector, no move)."""
        kept = pbatch.with_sel(keep & pbatch.row_mask())
        nulls = tuple(DeviceColumn.full_null(
            c.dtype, kept.capacity,
            c.string_width if c.dtype.is_string else 8,
            device=kept.device) for c in build_batch.columns)
        if build_is_right:
            cols = tuple(kept.columns) + nulls
        else:
            cols = nulls + tuple(kept.columns)
        return DeviceBatch(cols, kept.num_rows, sel=kept.sel)


# ---------------------------------------------------------------------------
# The exec
# ---------------------------------------------------------------------------

class BroadcastHashJoinExec(Exec, _JoinKernelMixin):
    """Hash join whose build side is collected once, from every partition
    of its child, and shared by every probe partition
    (GpuBroadcastHashJoinExec). The build side is the right child, or the
    left one for a right outer join; the probe side streams its
    partitions. Keys are bound references into each side."""

    def __init__(self, left: Exec, right: Exec,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 join_type: str = "inner",
                 condition: Optional[Expression] = None):
        super().__init__(left, right)
        if join_type == "full":
            # Build-unmatched rows would be emitted once per probe
            # partition; full outer needs a shuffled (co-partitioned)
            # plan, which the port does not have yet.
            raise NotImplementedError(
                "full outer join requires a shuffled (co-partitioned) plan")
        if join_type not in JOIN_TYPES:
            raise ValueError(f"unsupported join type {join_type!r}")
        for k in list(left_keys) + list(right_keys):
            if not isinstance(k, BoundReference):
                raise TypeError("join keys must be pre-projected "
                                "BoundReferences")
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.join_type = join_type
        self.condition = condition

    @property
    def schema(self) -> Schema:
        return _join_schema(self.children[0].schema,
                            self.children[1].schema, self.join_type)

    def _sides(self):
        """(build_is_right, build child, probe child, build key ordinals,
        probe key ordinals)."""
        build_right = self.join_type != "right"
        left = (self.children[0], [k.ordinal for k in self.left_keys])
        right = (self.children[1], [k.ordinal for k in self.right_keys])
        build, probe = (right, left) if build_right else (left, right)
        return build_right, build[0], probe[0], build[1], probe[1]

    def num_partitions(self, ctx) -> int:
        return self._sides()[2].num_partitions(ctx)

    def execute_device(self, ctx, partition):
        build_right, build_child, probe_child, build_keys, probe_keys = \
            self._sides()
        m = ctx.metrics_for(self)
        probe_iter = probe_child.execute_device(ctx, partition)
        # The built side (collection + fingerprint sort of the broadcast
        # table) is built once per query and shared across probe
        # partitions; None stands for an empty broadcast table.
        cache_key = f"builtside:{id(self):x}"
        if cache_key in ctx.cache:
            built = ctx.cache[cache_key]
        else:
            bbatches = []
            for cp in range(build_child.num_partitions(ctx)):
                bbatches.extend(build_child.execute_device(ctx, cp))
            with timed(m, "buildTime"):
                built = build_side(coalesce_to_single_batch(bbatches),
                                   build_keys) if bbatches else None
            ctx.cache[cache_key] = built
            m.add("buildSideBuilds", 1)
        if built is None:
            for pbatch in probe_iter:
                if self.join_type == "anti":
                    yield pbatch
                elif self.join_type in ("left", "right"):
                    yield self._null_extend(
                        pbatch, pbatch.row_mask(),
                        _empty_like(build_child.schema, pbatch.device),
                        build_right)
            return
        for out in self._device_join_stream(ctx, built, probe_iter,
                                            probe_keys, build_right):
            record_batch(m, out)
            yield out
