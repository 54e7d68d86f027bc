"""Hash and nested-loop joins (port of the JAX package's ``ops/join.py``:
``BuiltSide``, ``build_side``, the dense direct-address table,
``_pair_keys_equal``, ``probe_ranges``, ``expand_pairs``, the join kernel
mixin, ``ShuffledHashJoinExec``, ``BroadcastHashJoinExec`` and
``BroadcastNestedLoopJoinExec``).

A sort-probe join over key fingerprints, as in the reference:

  build side: fingerprint the build keys (two murmur3 streams,
      ``kernels.key_fingerprint``) into one u64, sort the build rows by it
      in unsigned order; rows that can never match (null keys, dead rows)
      carry the sentinel 0xFFFF_FFFF_FFFF_FFFF and sort last. One pull of a
      small stats vector per build gives the longest run of equal
      fingerprints and, for integral keys, their range.
  probe side, one of three paths per build:
      dense  - unique integral keys spanning under 2^24 values: a direct
               table maps key -> build row, one gather per probe batch
               (not for a full outer join, which tracks build coverage);
      fast   - runs of at most 4: the two binary searches (kernel K3 on
               the card), then pair expansion into probe_cap * max_run
               slots with no host sync;
      synced - longer runs: the same searches, one host sync for the pair
               count, then the expansion.
  Expanded pairs are checked key against key (a fingerprint range is a
  candidate only), then a residual condition, then the join type's
  emission. A full outer join ORs each probe batch's matched build rows
  into a coverage mask and, after the probe stream, emits the build rows
  nothing matched with a NULL probe side (``_null_extend_build``).

A u64 fingerprint is carried as the int64 tensor of its bit pattern; it is
sorted as ``fp ^ (1 << 63)`` so signed order is unsigned order.

``ShuffledHashJoinExec`` joins co-partitioned sides partition by
partition: each partition's build side is coalesced to one batch
(RequireSingleBatch) and probed, so K3 launches once per partition whose
build is not dense. ``BroadcastHashJoinExec`` is its subclass whose build
side is collected once from every partition of its child and shared by
every probe partition (a full outer join there needs one probe
partition). ``BroadcastNestedLoopJoinExec`` pairs every probe (left) row
with every build (right) row, for cross joins and conditional joins of
every type; a right or full one needs a single probe partition. Its
output capacity is probe rows times build rows a batch: a product that
cannot be allocated raises.

Out of core (the grace hash join): a shuffled join whose partition's
build side exceeds ``join.grace.buildFraction`` of the device budget
stages both sides as spillables and hash-partitions them by the join
keys through two staged exchanges into ``ceil(build bytes / bucket
budget)`` buckets (at least 2, at most ``join.grace.maxPartitions``;
``graceJoinPartitions``), then joins the co-partitioned bucket pairs one
at a time: a bucket's probe launches K3. An empty build bucket takes the
empty-build semantics (anti keeps its probe rows, outer joins
null-extend them). The grace path is also the OOM rung above an
exhausted spill ladder (``_grace_retry``); a broadcast join has none. Every build and
probe step is an OOM retry site (``memory/oom.py``); a probe step whose
OOM the ladder leaves unmet splits its probe batch in half and probes
each half (``split_on_oom``), so a nested join, which no grace rung
reaches, recovers too.

A runtime re-plan (``parallel/replan.py``) may demote a shuffled join
for one query: its ``num_partitions`` and ``execute_device`` then stream
the broadcast delegate the re-plan built, over the materialized build
exchange and the probe exchange's unshuffled child; its host half never
sees a decision.

The port runs every step eagerly: the JAX package's kernel cache and
jit/eager split have no counterpart here. Join types:
inner, left, right, full, semi (left semi), anti (left anti) and cross,
each with an optional residual condition.

The host half (``_host_join``, numpy, as in the reference's host engine)
encodes each key tuple to one int64 code per row in a code space shared
by both sides (``encode_key_pair``: NaN == NaN, -0.0 == 0.0, no
subnormal flush), sorts the build codes once per query, and probes every
probe row through a lookup table or one binary search; a nested-loop join
expands the cross product in bounded chunks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import config as C, faults
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, DeviceColumn, bucket_capacity, coalesce_iter,
    concat_batches, flush_subnormal, string_repad)
from spark_rapids_tpu_torch.columnar.host import (
    HostBatch, HostColumn, concat_host_batches, encode_key_pair,
    stable_code_argsort)
from spark_rapids_tpu_torch.columnar.rowmove import gather_rows
from spark_rapids_tpu_torch.exprs.base import (
    BoundReference, Expression, as_device_column, as_host_column)
from spark_rapids_tpu_torch.memory.oom import split_on_oom
from spark_rapids_tpu_torch.ops import kernel_cache as kc
from spark_rapids_tpu_torch.ops import kernels, native
from spark_rapids_tpu_torch.ops.base import (
    Exec, Schema, record_batch, timed)
from spark_rapids_tpu_torch.ops.sort import (
    coalesce_to_single_batch, stage_spillables, staged_exchange)

JOIN_TYPES = ("inner", "left", "right", "full", "semi", "anti", "cross")

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
    row_live: torch.Tensor          # (cap,) bool: live, null keys included
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
    rows; they stay live for a full outer join's emission."""
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
    return BuiltSide(sorted_batch, s_fp, s_match, s_live, list(key_ordinals),
                     stats)


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
    ``native.searchsorted_u64_pair`` (kernel K3 on the card), or with
    ``native.joinProbe`` off its library route, two ``torch.searchsorted``
    (K3's plain version). Rows that are dead or have a null key get count
    0."""
    fp = _fingerprint64(probe, key_ordinals)
    plive = probe.row_mask()
    for i in key_ordinals:
        plive = plive & probe.columns[i].validity
    if native.kernel_enabled("joinProbe"):
        lo, hi = native.searchsorted_u64_pair(built.fp, fp)
    else:
        native.count_library("join_probe")
        lo, hi = native.searchsorted_u64_pair_plain(built.fp, fp)
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
        jt = self.join_type
        # Full outer: build coverage accumulates over the whole probe
        # stream; the build rows nothing matched are emitted at its end.
        covered_acc = torch.zeros(built.batch.capacity, dtype=torch.bool,
                                  device=built.fp.device) \
            if jt == "full" else None
        # Coalesce the probe stream (compacting sparse members first): a
        # probe batch costs launches whatever its size.
        probe_iter = coalesce_iter(probe_iter,
                                   int(ctx.conf.get(C.BATCH_SIZE_ROWS)),
                                   int(ctx.conf.get(C.BATCH_SIZE_BYTES)))
        # One sync per build: the stats sized the fast path and decide the
        # dense table.
        mr = built.stats_host()[0] if built.stats is not None else None
        if mr is not None and jt != "full":
            _maybe_build_dense(built)
        if built.table is not None:
            def dense_step(pbatch, _offset):
                return kc.call(self._dense_step, built, pbatch, probe_keys,
                               build_is_right)

            for pbatch in probe_iter:
                yield from split_on_oom(dense_step, pbatch)
            return
        fast = mr is not None and 0 < mr <= _FAST_PATH_MAX_RUN

        def probe_step(pbatch):
            # (Semi/anti expand too: candidate ranges must be key-checked
            # before deciding hit or miss.)
            lo, counts, _ = probe_ranges(built, pbatch, probe_keys)
            if fast:
                out_cap = bucket_capacity(max(pbatch.capacity * mr, 1))
            else:
                total = int(counts.sum())
                out_cap = bucket_capacity(max(total, 1))
            return self._emit_expanded(built, pbatch, lo, counts, out_cap,
                                       build_is_right, probe_keys)

        for pbatch in probe_iter:
            for out, covered in split_on_oom(
                    lambda b, _offset: kc.call(probe_step, b), pbatch):
                if covered_acc is not None:
                    covered_acc = covered_acc | covered
                yield out
        if covered_acc is not None:
            yield self._null_extend_build(
                built.batch, built.row_live, ~covered_acc,
                self._probe_schema(), build_is_right)

    def _emit_expanded(self, built: BuiltSide, pbatch: DeviceBatch, lo,
                       counts, out_cap: int, build_is_right: bool,
                       probe_keys):
        """Expand the matches of one probe batch and emit by join type.
        Returns (batch, the build rows a pair matched or None); only a
        full outer join reads the latter."""
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
            return pairs.with_sel(cond_keep), None
        # Per probe row: did any pair survive? (segment max over p)
        hit = _segment_any(cond_keep, p, probe_cap)
        if jt in ("semi", "anti"):
            keep = (hit if jt == "semi" else ~hit) & pbatch.row_mask()
            return pbatch.with_sel(keep), None
        # Outer joins: surviving pairs, then unmatched probe rows with a
        # NULL build side.
        survivors = pairs.with_sel(cond_keep)
        extra = self._null_extend(pbatch, ~hit & pbatch.row_mask(),
                                  built.batch, build_is_right)
        out = concat_batches([survivors, extra], bucket_capacity(
            survivors.capacity + extra.capacity))
        if jt == "full":
            bcap = built.batch.capacity
            return out, _segment_any(cond_keep, b.clamp(0, bcap - 1), bcap)
        return out, None

    def _probe_schema(self) -> Schema:
        build_right = self.join_type != "right"
        return self.children[0 if build_right else 1].schema

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

    @staticmethod
    def _null_extend_build(b: DeviceBatch, row_live, keep,
                           probe_schema: Schema,
                           build_is_right: bool) -> DeviceBatch:
        """Build rows that are live and under ``keep``, with a NULL probe
        side. A built batch's live rows are not a prefix
        (fingerprint-sorted, null keys last), so ``num_rows`` is the
        capacity and the selection vector alone marks them."""
        dev = row_live.device
        kept = DeviceBatch(b.columns, torch.tensor(
            b.capacity, dtype=torch.int32, device=dev),
            sel=keep & row_live)
        nulls = tuple(DeviceColumn.full_null(t, b.capacity, device=dev)
                      for _, t in probe_schema)
        if build_is_right:
            cols = nulls + tuple(kept.columns)
        else:
            cols = tuple(kept.columns) + nulls
        return DeviceBatch(cols, kept.num_rows, sel=kept.sel)


def _segment_any(flags: torch.Tensor, seg: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """(num_segments,) bool: whether any flag of each segment is set."""
    return torch.zeros(num_segments, dtype=torch.int32,
                       device=flags.device).scatter_reduce(
        0, seg, flags.to(torch.int32), "amax") > 0


# ---------------------------------------------------------------------------
# The execs
# ---------------------------------------------------------------------------

def _key_ordinals(keys: Sequence[Expression]) -> List[int]:
    return [k.ordinal for k in keys]


class ShuffledHashJoinExec(Exec, _JoinKernelMixin):
    """Both sides co-partitioned by key (GpuShuffledHashJoinExec). The
    build side (right, or left for a right outer join) of each partition
    is coalesced to one batch (RequireSingleBatch, as in the reference)
    and its probe side streams. Keys are bound references into each
    side."""

    def __init__(self, left: Exec, right: Exec,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 join_type: str = "inner",
                 condition: Optional[Expression] = None):
        super().__init__(left, right)
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
        left = (self.children[0], _key_ordinals(self.left_keys))
        right = (self.children[1], _key_ordinals(self.right_keys))
        build, probe = (right, left) if build_right else (left, right)
        return build_right, build[0], probe[0], build[1], probe[1]

    def num_partitions(self, ctx) -> int:
        delegate = self._replan_delegate(ctx)
        if delegate is not None:
            return delegate.num_partitions(ctx)
        return self.children[0].num_partitions(ctx)

    def _replan_delegate(self, ctx):
        """The broadcast join a runtime re-plan put in this join's place
        for this query (``parallel/replan.py``), or None. Decisions live
        in the context: the cached plan and the host engine never see
        them. ``BroadcastHashJoinExec`` overrides every method that asks,
        so a delegate never consults itself."""
        from spark_rapids_tpu_torch.parallel import replan as RP
        return RP.demoted(ctx, self)

    def host_prefetchable(self) -> bool:
        # Only the probe side streams by this node's partition numbering;
        # a broadcast build materializes once, and prefetching it per
        # probe partition would re-encode the whole build table N times.
        from spark_rapids_tpu_torch.parallel.stages import \
            is_stage_boundary
        probe = self._sides()[2]
        return not is_stage_boundary(probe) and probe.host_prefetchable()

    def prefetch_host(self, ctx, partition):
        from spark_rapids_tpu_torch.parallel.stages import \
            is_stage_boundary
        probe = self._sides()[2]
        if not is_stage_boundary(probe):
            probe.prefetch_host(ctx, partition)

    def _empty_build(self, probe_iter, build_schema, build_right: bool):
        """Every probe row is unmatched: anti keeps it, an outer join
        null-extends it, the rest emit nothing."""
        for pbatch in probe_iter:
            if self.join_type == "anti":
                yield pbatch
            elif self.join_type in ("left", "right", "full"):
                yield self._null_extend(
                    pbatch, pbatch.row_mask(),
                    _empty_like(build_schema, pbatch.device), build_right)

    def _build(self, ctx, batches, build_keys) -> BuiltSide:
        m = ctx.metrics_for(self)
        with timed(m, "buildTime"):
            built = kc.call(
                lambda: build_side(coalesce_to_single_batch(batches),
                                   build_keys))
        m.add("buildSideBuilds", 1)
        return built

    def execute_device(self, ctx, partition):
        delegate = self._replan_delegate(ctx)
        if delegate is not None:
            # Demoted at run time: stream the broadcast subtree, whose
            # build side reads the materialized exchange and whose probe
            # side reads the probe exchange's child unshuffled.
            yield from delegate.execute_device(ctx, partition)
            return
        build_right, build_child, probe_child, build_keys, probe_keys = \
            self._sides()
        m = ctx.metrics_for(self)
        bbatches = list(build_child.execute_device(ctx, partition))
        if not bbatches:
            if self.join_type not in ("inner", "semi", "cross"):
                yield from self._empty_build(
                    probe_child.execute_device(ctx, partition),
                    build_child.schema, build_right)
            return
        probe_iter = probe_child.execute_device(ctx, partition)
        grace_budget = self._grace_bucket_budget(ctx)
        total_bytes = sum(b.device_size_bytes() for b in bbatches)
        m.add("buildBytes", total_bytes)
        if grace_budget is not None and (
                ctx.cache.get(self._grace_force_key())
                or total_bytes > grace_budget):
            stream = self._grace_join(ctx, bbatches, probe_iter,
                                      total_bytes, grace_budget)
        else:
            built = self._build(ctx, bbatches, build_keys)
            del bbatches
            stream = self._device_join_stream(ctx, built, probe_iter,
                                              probe_keys, build_right)
        for out in stream:
            record_batch(m, out)
            yield out

    # -- out-of-core grace hash join ---------------------------------------
    def _grace_force_key(self) -> str:
        return f"grace-join-force:{id(self):x}"

    def _grace_bucket_budget(self, ctx) -> Optional[int]:
        """The per-bucket byte budget where the grace path is open to this
        join, else None; a build side above it takes the grace path."""
        if not bool(ctx.conf.get(C.JOIN_GRACE_ENABLED)):
            return None
        if self.join_type == "cross" or not self.left_keys:
            return None
        frac = float(ctx.conf.get(C.JOIN_GRACE_BUILD_FRACTION))
        return max(int(ctx.catalog.device_budget * frac), 1 << 16)

    def _grace_retry(self, ctx, partition):
        """The OOM rung above the spill ladder: force the grace path for
        this join and re-run it on the device; None where grace is closed
        or was already forced (then the error propagates)."""
        if self._grace_bucket_budget(ctx) is None:
            return None
        key = self._grace_force_key()
        if ctx.cache.get(key):
            return None
        ctx.cache[key] = True
        faults.record("graceJoinEngaged")
        ctx.metrics_for(self).add("graceJoinEngaged", 1)
        return self.execute_device(ctx, partition)

    def _grace_join(self, ctx, bbatches: List[DeviceBatch], probe_iter,
                    total_bytes: int, bucket_budget: int):
        """Both sides hash-partition by the join keys (the exchange's
        murmur3, so equal keys share a bucket on both sides) into
        spillable buckets; the bucket pairs join one at a time. Peak
        device memory is about one bucket's build side and one probe
        batch."""
        from spark_rapids_tpu_torch.parallel.partitioning import \
            HashPartitioning
        build_right, build_child, probe_child, bords, pords = self._sides()
        bexprs = self.right_keys if build_right else self.left_keys
        pexprs = self.left_keys if build_right else self.right_keys
        m = ctx.metrics_for(self)
        nb = max(2, -(-total_bytes // bucket_budget))
        nb = min(nb, max(int(ctx.conf.get(C.JOIN_GRACE_MAX_PARTITIONS)), 2))
        m.add("graceJoinPartitions", nb)
        faults.record("graceJoinPartitions", nb)
        bspill: list = []
        pspill: list = []
        exchanges = []
        try:
            # Inside the cleanup: a probe side that fails while it is
            # staged must not leave the build side's entries behind.
            bspill, _ = stage_spillables(ctx, iter(bbatches))
            bbatches.clear()
            pspill, _ = stage_spillables(ctx, probe_iter)
            bex = staged_exchange(bspill, build_child.schema,
                                  HashPartitioning(list(bexprs), nb))
            pex = staged_exchange(pspill, probe_child.schema,
                                  HashPartitioning(list(pexprs), nb))
            exchanges = [bex, pex]
            for p in range(nb):
                bucket = list(bex.execute_device(ctx, p))
                bex.release(ctx, p)
                probe_bucket = pex.execute_device(ctx, p)
                if not bucket:
                    # Each probe row lives in exactly one bucket, so the
                    # empty-build semantics per bucket are exact.
                    yield from self._empty_build(
                        probe_bucket, build_child.schema, build_right)
                else:
                    m.add("graceJoinBuildBuckets", 1)
                    built = self._build(ctx, bucket, bords)
                    del bucket
                    yield from self._device_join_stream(
                        ctx, built, probe_bucket, pords, build_right)
                    del built
                pex.release(ctx, p)
        finally:
            for ex in exchanges:
                ex.release(ctx)
            for sb in bspill + pspill:
                sb.close()

    def execute_host(self, ctx, partition):
        yield from _host_join(self, ctx, partition)


class BroadcastHashJoinExec(ShuffledHashJoinExec):
    """Hash join whose build side is collected once, from every partition
    of its child, and shared by every probe partition
    (GpuBroadcastHashJoinExec); the probe side streams its partitions.
    It has no grace rung: its build side is shared by every probe
    partition, so an exhausted ladder there raises."""

    def _grace_retry(self, ctx, partition):
        return None

    def num_partitions(self, ctx) -> int:
        return self._sides()[2].num_partitions(ctx)

    def execute_device(self, ctx, partition):
        build_right, build_child, probe_child, build_keys, probe_keys = \
            self._sides()
        # Full outer over a broadcast build would emit build-unmatched
        # rows once per probe partition; Spark never plans that shape.
        if self.join_type == "full" and probe_child.num_partitions(ctx) != 1:
            raise NotImplementedError(
                "full outer join requires a shuffled (co-partitioned) plan")
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
            yield from self._empty_build(probe_iter, build_child.schema,
                                         build_right)
            return
        for out in self._device_join_stream(ctx, built, probe_iter,
                                            probe_keys, build_right):
            record_batch(m, out)
            yield out


class BroadcastNestedLoopJoinExec(Exec, _JoinKernelMixin):
    """Cross and conditional nested-loop join: every probe (left) row
    pairs with every build (right, collected from all its partitions)
    row (GpuBroadcastNestedLoopJoinExec.scala). A batch's output capacity
    is probe rows times build rows. 'right' preserves the build side;
    right and full need a single probe partition (build-unmatched rows
    are emitted once)."""

    def __init__(self, left: Exec, right: Exec, join_type: str = "cross",
                 condition: Optional[Expression] = None):
        super().__init__(left, right)
        if join_type not in JOIN_TYPES:
            raise ValueError(f"unsupported join type {join_type!r}")
        self.join_type = join_type
        self.condition = condition

    @property
    def schema(self) -> Schema:
        return _join_schema(self.children[0].schema,
                            self.children[1].schema, self.join_type)

    def num_partitions(self, ctx) -> int:
        return self.children[0].num_partitions(ctx)

    def host_prefetchable(self) -> bool:
        # The probe (left) side only: the build side is pulled whole for
        # every partition, not by this node's partition numbering.
        from spark_rapids_tpu_torch.parallel.stages import \
            is_stage_boundary
        return not is_stage_boundary(self.children[0]) and \
            self.children[0].host_prefetchable()

    def prefetch_host(self, ctx, partition):
        from spark_rapids_tpu_torch.parallel.stages import \
            is_stage_boundary
        if not is_stage_boundary(self.children[0]):
            self.children[0].prefetch_host(ctx, partition)

    def execute_device(self, ctx, partition):
        jt = self.join_type
        if jt in ("right", "full") and self.num_partitions(ctx) != 1:
            raise NotImplementedError(
                f"nested-loop {jt} join needs a single probe partition")
        m = ctx.metrics_for(self)
        bbatches = []
        for cp in range(self.children[1].num_partitions(ctx)):
            bbatches.extend(self.children[1].execute_device(ctx, cp))
        probe_iter = self.children[0].execute_device(ctx, partition)
        if not bbatches:
            # Empty build side: left/full keep probes null-extended, anti
            # keeps every probe, inner/cross/semi/right emit nothing.
            empty = _empty_like(self.children[1].schema,
                                self.plan_device())
            for pbatch in probe_iter:
                if jt == "anti":
                    yield pbatch
                elif jt in ("left", "full"):
                    yield self._null_extend(pbatch, pbatch.row_mask(),
                                            empty, True)
            return
        build = coalesce_to_single_batch(bbatches)
        if build.sel is not None:
            # Probe rows pair with build positions 0..num_rows-1, so a
            # selection vector compacts first.
            build = build.compact()
        live = build.row_mask()
        bcap = build.capacity
        nbuild = int(build.num_rows)
        covered_acc = torch.zeros(bcap, dtype=torch.bool,
                                  device=live.device) \
            if jt in ("right", "full") else None
        for pbatch in probe_iter:
            pcap = pbatch.capacity
            lo = torch.zeros(pcap, dtype=torch.int32, device=live.device)
            counts = torch.where(pbatch.row_mask(), nbuild, 0)
            out_cap = bucket_capacity(max(int(pbatch.num_rows) * nbuild, 1))
            with timed(m):
                out, covered = self._nlj_emit(build, pbatch, lo, counts,
                                              out_cap)
            if covered_acc is not None:
                covered_acc = covered_acc | covered
            record_batch(m, out)
            yield out
        if covered_acc is not None:
            yield self._null_extend_build(build, live, ~covered_acc,
                                          self.children[0].schema, True)

    def _nlj_emit(self, build: DeviceBatch, pbatch: DeviceBatch, lo, counts,
                  out_cap: int):
        """``_emit_expanded`` with nested-loop semantics: the probe is
        always the left side, and 'right' preserves the build."""
        jt = self.join_type
        cond = self.condition
        probe_cap = pbatch.capacity
        bcap = build.capacity
        p, b, valid, total = expand_pairs(lo, counts, out_cap, probe_cap)
        left = gather_rows(pbatch, p, total, valid_dst=valid)
        right = gather_rows(build, b, total, valid_dst=valid)
        pairs = DeviceBatch(tuple(left.columns) + tuple(right.columns),
                            total)
        cond_keep = valid
        if cond is not None:
            c = as_device_column(cond.eval(pairs), pairs)
            cond_keep = c.data & c.validity & valid
        covered = _segment_any(cond_keep, b.clamp(0, bcap - 1), bcap) \
            if jt in ("right", "full") else None
        if jt in ("inner", "cross", "right"):
            # A right join emits its matched pairs here and the build
            # rows nothing matched at the end.
            return pairs.with_sel(cond_keep), covered
        hit = _segment_any(cond_keep, p, probe_cap)
        if jt in ("semi", "anti"):
            keep = (hit if jt == "semi" else ~hit) & pbatch.row_mask()
            return pbatch.with_sel(keep), covered
        # left / full: survivors, then the unmatched probe rows.
        survivors = pairs.with_sel(cond_keep)
        extra = self._null_extend(pbatch, ~hit & pbatch.row_mask(), build,
                                  True)
        return concat_batches([survivors, extra], bucket_capacity(
            survivors.capacity + extra.capacity)), covered

    def execute_host(self, ctx, partition):
        yield from _host_join(self, ctx, partition, nested_loop=True)


def _empty_host_batch(schema: Schema) -> HostBatch:
    cols = []
    for _, t in schema:
        if t.is_string:
            cols.append(HostColumn(t, None, np.zeros(0, np.bool_),
                                   str_matrix=np.zeros((0, 1), np.uint8),
                                   str_lengths=np.zeros(0, np.int32)))
        else:
            cols.append(HostColumn(t, np.zeros(0, t.np_dtype),
                                   np.zeros(0, np.bool_)))
    return HostBatch(tuple(n for n, _ in schema), cols)


def _host_join(op, ctx, partition, nested_loop: bool = False):
    """Vectorized host join with SQL null semantics (a null key never
    matches). Each key tuple becomes one int64 code per row in a code
    space shared by both sides; the build side sorts by code once per
    query; each probe row finds its [lo, hi) run of build rows by a
    lookup table (dense codes) or one binary search over the unique
    codes. Pairs expand by one repeat and gather; a nested-loop join
    expands the cross product in chunks of about 2^20 pairs. The
    condition evaluates once over the gathered pairs, and every join
    type emits by an index gather (a negative index is a null
    extension). Emission order: pairs in left-row order with their build
    rows in code order, then, for a right or full join, the unmatched
    right rows. A shuffled join joins this partition of both sides; a
    broadcast one this partition of its probe side with its whole build
    side."""

    def collect(child, parts, cache_tag=None):
        # The broadcast side spans every child partition and is collected
        # once per query (the device path's broadcast collection).
        key = None
        if cache_tag is not None:
            key = f"bcast-host:{id(op):x}:{cache_tag}"
            hit = ctx.cache.get(key)
            if hit is not None:
                return hit
        hbs = []
        for cp in parts:
            hbs.extend(child.execute_host(ctx, cp))
        out = (concat_host_batches(hbs) if hbs
               else _empty_host_batch(child.schema))
        if key is not None:
            ctx.cache[key] = out
        return out

    lchild, rchild = op.children
    if isinstance(op, ShuffledHashJoinExec) and \
            not isinstance(op, BroadcastHashJoinExec):
        lb = collect(lchild, [partition])
        rb = collect(rchild, [partition])
    elif op.join_type != "right" or nested_loop:
        lb = collect(lchild, [partition])
        rb = collect(rchild, range(rchild.num_partitions(ctx)), "build")
    else:
        lb = collect(lchild, range(lchild.num_partitions(ctx)), "build")
        rb = collect(rchild, [partition])
    nl, nr = lb.num_rows, rb.num_rows
    lschema, rschema = lchild.schema, rchild.schema
    jt = op.join_type
    cond = op.condition

    def eval_cond(li_p, ri_p):
        if cond is None:
            return np.ones(len(li_p), np.bool_)
        if not len(li_p):
            return np.zeros(0, np.bool_)
        hb = HostBatch(
            tuple(n for n, _ in tuple(lschema) + tuple(rschema)),
            [c.take(li_p) for c in lb.columns]
            + [c.take(ri_p) for c in rb.columns])
        c = as_host_column(cond.eval_host(hb), hb)
        return np.asarray(c.data, np.bool_) & np.asarray(c.validity,
                                                         np.bool_)

    if nested_loop:
        li_parts, ri_parts = [], []
        step = max(1, (1 << 20) // max(1, nr))
        ridx = np.arange(nr, dtype=np.int64)
        for blo in range(0, nl, step):
            bhi = min(nl, blo + step)
            li_p = np.repeat(np.arange(blo, bhi, dtype=np.int64), nr)
            ri_p = np.tile(ridx, bhi - blo)
            ok = eval_cond(li_p, ri_p)
            li_parts.append(li_p[ok])
            ri_parts.append(ri_p[ok])
        li_f = np.concatenate(li_parts) if li_parts \
            else np.zeros(0, np.int64)
        ri_f = np.concatenate(ri_parts) if ri_parts \
            else np.zeros(0, np.int64)
    else:
        lval = np.ones(nl, np.bool_)
        rval = np.ones(nr, np.bool_)
        cl_parts, cr_parts = [], []
        for lk, rk in zip(op.left_keys, op.right_keys):
            a, b = lb.columns[lk.ordinal], rb.columns[rk.ordinal]
            ca, cb = encode_key_pair(a, b)
            cl_parts.append(ca)
            cr_parts.append(cb)
            lval &= np.asarray(a.validity, np.bool_)
            rval &= np.asarray(b.validity, np.bool_)
        if len(cl_parts) == 1:
            cl, cr = cl_parts[0], cr_parts[0]
        else:
            allc = np.ascontiguousarray(np.concatenate(
                [np.stack(cl_parts, 1), np.stack(cr_parts, 1)]))
            v = allc.view(np.dtype((np.void, allc.shape[1] * 8))).ravel()
            _, inv = np.unique(v, return_inverse=True)
            inv = inv.astype(np.int64)
            cl, cr = inv[:nl], inv[nl:]
        # The build side's sort order and run boundaries are the same for
        # every probe partition (the encodings are order-preserving and
        # equality-exact over the same build rows): cached per build batch.
        skey = f"hjoin-order:{id(op):x}"
        cached = ctx.cache.get(skey)
        if cached is not None and cached[0] is rb:
            rs_order, rstart, rend = cached[1], cached[2], cached[3]
        else:
            rsel = np.flatnonzero(rval)
            rs_order = rsel[stable_code_argsort(cr[rsel])]
            cr_sorted = cr[rs_order]
            if len(cr_sorted):
                rstart = np.flatnonzero(np.concatenate(
                    [np.ones(1, np.bool_), cr_sorted[1:] != cr_sorted[:-1]]))
                rend = np.concatenate(
                    [rstart[1:], np.array([len(cr_sorted)], np.int64)])
            else:
                rstart = rend = np.zeros(0, np.int64)
            ctx.cache[skey] = (rb, rs_order, rstart, rend)
        # One lookup per probe row into the unique build codes.
        if len(rs_order):
            uniq = cr[rs_order[rstart]]
            base = int(uniq[0])
            spread = int(uniq[-1]) - base + 1
            if spread <= max(1 << 20, 8 * len(uniq)):
                # Dense codes (string ranks always, integer keys usually): a
                # direct [lo, hi) table, one gather per probe row.
                lut_lo = np.zeros(spread, np.int64)
                lut_hi = np.zeros(spread, np.int64)
                lut_lo[uniq - base] = rstart
                lut_hi[uniq - base] = rend
                idx = cl - base
                inb = (idx >= 0) & (idx < spread) & lval
                idx = np.where(inb, idx, 0)
                plo = np.where(inb, lut_lo[idx], 0)
                phi = np.where(inb, lut_hi[idx], 0)
            else:
                pos = np.minimum(np.searchsorted(uniq, cl, "left"),
                                 len(uniq) - 1)
                hit = (uniq[pos] == cl) & lval
                plo = np.where(hit, rstart[pos], 0)
                phi = np.where(hit, rend[pos], 0)
        else:
            plo = phi = np.zeros(nl, np.int64)
        if len(rstart) == len(rs_order):
            # Unique build keys: 0 or 1 match a probe row, a masked gather.
            li_p = np.flatnonzero(phi > plo)
            ri_p = rs_order[plo[li_p]]
        else:
            cnt = (phi - plo).astype(np.int64)
            tot = int(cnt.sum())
            li_p = np.repeat(np.arange(nl, dtype=np.int64), cnt)
            offs = np.arange(tot, dtype=np.int64) \
                - np.repeat(np.cumsum(cnt) - cnt, cnt)
            ri_p = rs_order[np.repeat(plo, cnt) + offs]
        ok = eval_cond(li_p, ri_p)
        li_f, ri_f = li_p[ok], ri_p[ok]

    names = tuple(n for n, _ in op.schema)
    lmatch = np.bincount(li_f, minlength=nl)
    if jt in ("semi", "anti"):
        keep = lmatch > 0 if jt == "semi" else lmatch == 0
        yield HostBatch(names, [c.filter(keep) for c in lb.columns])
        return
    if jt in ("left", "full"):
        unm = np.flatnonzero(lmatch == 0)
        li_all = np.concatenate([li_f, unm])
        ri_all = np.concatenate([ri_f, np.full(len(unm), -1, np.int64)])
        order = np.argsort(li_all, kind="stable")
        li_all, ri_all = li_all[order], ri_all[order]
    else:                                    # inner / cross / right pairs
        li_all, ri_all = li_f, ri_f
    if jt in ("right", "full"):
        rmatched = np.zeros(nr, np.bool_)
        rmatched[ri_f] = True
        runm = np.flatnonzero(~rmatched)
        li_all = np.concatenate([li_all, np.full(len(runm), -1, np.int64)])
        ri_all = np.concatenate([ri_all, runm])
    cols = [c.take(li_all, null_on_negative=True) for c in lb.columns] \
        + [c.take(ri_all, null_on_negative=True) for c in rb.columns]
    yield HostBatch(names, cols)
