"""The single-process shuffle exchange (port of the JAX package's
``parallel/exchange.py`` ``ShuffleExchangeExec``; ref
GpuShuffleExchangeExec.scala, ShuffledBatchRDD.scala).

The exchange materializes its child once per query context (the map
side), bucketing every batch by partition id, and writes the pieces
through its shuffle transport session (``parallel/transport/``, chosen
by ``spark.rapids.sql.shuffle.transport``): ``inprocess`` keeps them as
``SpillableBatch`` handles of the query's catalog at
``PRIORITY_SHUFFLE_OUTPUT`` (they spill first under the device budget,
device -> host -> disk, and are restored when served); ``hostfile``
spools CRC-framed shard files to a shared directory and ``objectstore``
puts them into an object store, so other processes can fetch them. The
session's tag is ``x<pid>-<exchange id>``, its owner the exchange's id;
it is parked in ``ctx.cache`` and the context's teardown closes it.
Reduce tasks then stream their bucket. The child is pulled through
``execute_device_recovering``.

Map side, per window of child batches (two-phase sizes-then-data; a
window holds at most 32 batches and a quarter of ``batchSizeBytes`` or of
the catalog's device budget, whichever is smaller):

- one destination: no ids, no sort; each batch shrinks to its live bucket
  (one batched row-count pull a window) and is kept whole;
- otherwise each batch's partition ids and per-partition counts are
  computed, the counts of the whole window pulled in one sync, a
  mostly-dead batch shrinks to its live bucket first, and then one
  pid-stable sort (``native.stable_argsort_u32``, kernel K1 on the card)
  orders the rows by destination and one gather a piece copies each
  piece's rows out of the batch. A piece owns its tensors (its dead
  rows zeroed), so spilling it frees its memory; a view of one sorted
  batch would free nothing. Where the OOM ladder leaves a step unmet,
  the rest of the window goes batch by batch, a batch split in half
  while it does not fit (``split_on_oom``, port-only): more pieces, the
  same rows in the same order.

A range exchange samples up to 64 rows of the first batch of each child
partition, downloads and merges them and picks its bounds on the host
(``RangePartitioning.compute_bounds``); the child runs once for the
sample and again for the data, as the reference's does. One partition
needs no bounds, so it samples nothing.

Reduce side: a partition's shards (``fetch_shards``, a
``fetch-shards`` span) concatenate into batches of up to
``batchSizeRows`` capacity (``effective_batch_target``: smaller after the
OOM ladder's shrink rung), carrying the summed ``rows_hint``; a served
piece stays pinned until the consumer asks for the next batch. With
``allow_coalesce`` (aggregate, window and sort exchanges; never a join's
co-partitioned inputs) adjacent undersized partitions merge under the
``spark.rapids.sql.aqe.coalescePartitions.*`` row target (exact map-side
counts) and byte target (the bytes the session observed), as the
AQE-lite reader does (GpuCustomShuffleReaderExec.scala:132).

Traced (``monitoring/recorder.py``): the map side is an
``exchange-materialize`` span and each served batch an ``exchange-serve``
span, both ``shuffle``; ``exchange.flush`` (each map-side window) and
``exchange.serve`` (each served batch) are fault sites tagged with the
exchange's id (``faults.py``).

Stage hooks (``parallel/stages.py``): the exchange is a stage boundary.
``stage_invalidate`` makes the session drop its output and forgets it
(the next execution recomputes the stage from its parents' outputs);
``stage_prematerialize`` runs the map side ahead of the partition loop
(``parallel/pipeline.py``), unless a runtime re-plan flagged the exchange
as a skipped probe side (``replan-skip:``); ``observed_total_bytes`` is
the session's ``observed_bytes()`` (in process: the kept pieces' device
bytes), which the runtime re-plan (``parallel/replan.py``) compares with
``autoBroadcastJoinThreshold``. The reference sums each piece's bytes at
its split capacity, the largest count of its batch's pieces rounded up
the capacity ladder, where the port gives each piece its own count's
rung; so for the same input the port's sum is at most the reference's,
equal where one destination takes every batch. A served piece that
fails its checksum twice (``WireCorruptionError``), and a fetched shard
that is lost (``ShardLostError``), carry the exchange's id, so the
planner recomputes this stage.
``BroadcastExchangeExec`` collects its child into one batch, kept as a
spillable catalog handle, with the same hooks.

The host half (``execute_host``) splits each host batch with
``split_host_batch`` and serves a partition's pieces as they are; under
the device engine (a host-tagged exchange in a device-rooted plan) a
coalesced exchange's partition is its group's buckets, as on the device.
"""

from __future__ import annotations

import os
import traceback
from typing import List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import config as C, faults
from spark_rapids_tpu_torch.columnar.batch import (
    MIN_SHRINK_BYTES, DeviceBatch, DeviceColumn, bucket_capacity,
    concat_batches, sample_rows, shrink_all, shrink_to_capacity)
from spark_rapids_tpu_torch.columnar.wire import WireCorruptionError
from spark_rapids_tpu_torch.columnar.host import (
    HostBatch, HostColumn, concat_host_batches, device_to_host)
from spark_rapids_tpu_torch.exprs.base import BoundReference, as_host_column
from spark_rapids_tpu_torch.memory.oom import (
    effective_batch_target, is_unmet_oom, retry_on_oom, split_on_oom)
from spark_rapids_tpu_torch.ops import kernel_cache as kc
from spark_rapids_tpu_torch.memory.stores import (
    PRIORITY_BROADCAST, PRIORITY_SHUFFLE_OUTPUT, SpillableBatch)
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops.base import Exec, Schema, record_batch, timed
from spark_rapids_tpu_torch.ops.sort import SortOrder
from spark_rapids_tpu_torch.parallel.partitioning import (
    Partitioning, RangePartitioning, split_host_batch)

# Map-side window: at most this many child batches, or a quarter of the
# device batch target or budget in bytes, wait for one batched counts
# pull.
_WINDOW = 32
_SAMPLE_ROWS = 64


class ShuffleExchangeExec(Exec):
    """Repartition the child by a Partitioning strategy.

    ``allow_coalesce`` opts this exchange into AQE-lite partition
    coalescing: once the map side materializes, the exact per-bucket row
    counts are known, and undersized adjacent reduce partitions merge up
    to the target. The planner enables it where partition identity is
    not load-bearing (aggregate, window and sort exchanges) and keeps it
    off for co-partitioned join inputs."""

    def __init__(self, child: Exec, partitioning: Partitioning,
                 allow_coalesce: bool = False):
        super().__init__(child)
        self.partitioning = partitioning
        self.allow_coalesce = allow_coalesce

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def _groups(self, ctx) -> Optional[List[List[int]]]:
        """Coalesced bucket groups (device engine only), or None."""
        n = self.partitioning.num_partitions
        if not self.allow_coalesce or n <= 1 or \
                ctx.cache.get("engine") != "device" or \
                not bool(ctx.conf.get(C.AQE_COALESCE_PARTITIONS)):
            return None
        gkey = f"shuffle-groups:{id(self):x}"
        groups = ctx.cache.get(gkey)
        if groups is None:
            sess = self._materialize_device(ctx)
            rows = ctx.cache[self._cache_key(True) + ":rows"]
            target = int(ctx.conf.get(C.AQE_COALESCE_TARGET_ROWS))
            tbytes = int(ctx.conf.get(C.AQE_COALESCE_TARGET_BYTES))
            groups = []
            cur: List[int] = []
            cur_rows = cur_bytes = 0
            for b in range(n):
                # Exact row counts from the map side, and the bytes the
                # transport session observed.
                b_rows = rows[b]
                b_bytes = sess.observed_bytes(b)
                if cur and (cur_rows + b_rows > target or
                            cur_bytes + b_bytes > tbytes):
                    groups.append(cur)
                    cur, cur_rows, cur_bytes = [], 0, 0
                cur.append(b)
                cur_rows += b_rows
                cur_bytes += b_bytes
            if cur:
                groups.append(cur)
            ctx.metrics_for(self).add("coalescedPartitions", n - len(groups))
            ctx.cache[gkey] = groups
        return groups

    def num_partitions(self, ctx) -> int:
        groups = self._groups(ctx)
        if groups is not None:
            return len(groups)
        return self.partitioning.num_partitions

    # -- the map side ---------------------------------------------------------
    def _cache_key(self, device: bool) -> str:
        return f"shuffle:{id(self):x}:{'dev' if device else 'host'}"

    def _ensure_bounds(self, ctx, device: bool):
        """A range partitioning picks its bounds from a host sample of up
        to 64 rows of each child partition's first batch."""
        p = self.partitioning
        if not isinstance(p, RangePartitioning) or p.bounds is not None:
            return
        if p.num_partitions == 1:
            p.bounds = HostBatch((), [])
            return
        child = self.children[0]
        samples: List[HostBatch] = []
        for cp in range(child.num_partitions(ctx)):
            it = (child.execute_device_recovering(ctx, cp) if device
                  else child.execute_host(ctx, cp))
            for b in it:
                hb = device_to_host(sample_rows(b, _SAMPLE_ROWS)) \
                    if device else b
                keycols = [as_host_column(o.child.eval_host(hb), hb)
                           for o in p.orders]
                n = min(_SAMPLE_ROWS, hb.num_rows)
                idx = np.linspace(0, max(hb.num_rows - 1, 0), n,
                                  dtype=np.int64) if n else \
                    np.zeros(0, np.int64)
                cols = [HostColumn(c.dtype, c.data[idx], c.validity[idx])
                        for c in keycols]
                samples.append(HostBatch(
                    tuple(f"k{i}" for i in range(len(cols))), cols))
                break       # one batch a partition is enough for bounds
        if not samples:
            p.bounds = HostBatch((), [])
            return
        merged_cols = []
        for ci in range(samples[0].num_columns):
            merged_cols.append(HostColumn(
                samples[0].columns[ci].dtype,
                np.concatenate([s.columns[ci].data for s in samples]),
                np.concatenate([s.columns[ci].validity for s in samples])))
        merged = HostBatch(samples[0].names, merged_cols)
        # The bounds batch holds the key columns positionally, so the sort
        # orders reference them by ordinal.
        bound_orders = [SortOrder(BoundReference(i, o.child.data_type()),
                                  o.ascending, o.nulls_first)
                        for i, o in enumerate(p.orders)]
        p.bounds = RangePartitioning.compute_bounds(merged, bound_orders,
                                                    p.num_partitions)

    def _pids_counts(self, b: DeviceBatch):
        """(partition ids, per-partition live counts) of one batch."""
        n = self.partitioning.num_partitions
        pids = self.partitioning.partition_ids(b)
        key = torch.where(b.row_mask(), pids.to(torch.int64),
                          torch.full((), n, dtype=torch.int64,
                                     device=b.device))
        return pids, torch.bincount(key, minlength=n + 1)[:n]

    def _window_counts(self, window: List[DeviceBatch]):
        """(batch, pids, counts) of each batch of a window, and every
        batch's counts pulled to the host in one copy."""
        metas = [(b,) + self._pids_counts(b) for b in window]
        pulled = torch.stack([c for _, _, c in metas]).cpu().tolist()
        return metas, pulled

    def _shrunk(self, b: DeviceBatch, capacity: int):
        """``b`` shrunk to ``capacity`` rows, and its partition ids."""
        small = shrink_to_capacity(b, capacity)
        return small, self._pids_counts(small)[0]

    def _split(self, b: DeviceBatch, pids: torch.Tensor,
               counts: List[int]) -> List[Optional[DeviceBatch]]:
        """One pid-stable sort (K1), then each non-empty piece gathered
        into its own batch of ``bucket_capacity(count)`` rows (None for an
        empty one) by one ``index_select`` a tensor. A zero row appended
        to the batch's tensors stands for every slot past a piece's count,
        so those slots come out zeroed whole, as ``gather_rows`` zeroes
        them, with one launch a tensor where its mask takes three."""
        n = self.partitioning.num_partitions
        skey = torch.where(b.row_mask(), pids.to(torch.int64),
                           torch.full((), n, dtype=torch.int64,
                                      device=b.device))
        sort = native.stable_argsort_u32 \
            if native.kernel_enabled("radixSort") \
            else native.stable_argsort_u32_library
        perm = sort(skey).to(torch.int64)
        zero_row = b.capacity

        def padded(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
            if t is None:
                return None
            return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])

        srcs = [(padded(c.data), padded(c.validity), padded(c.lengths))
                for c in b.columns]
        rows = torch.tensor(counts, dtype=torch.int32, device=b.device)
        offsets = np.concatenate([[0], np.cumsum(counts[:-1])])
        out: List[Optional[DeviceBatch]] = []
        for p in range(n):
            cnt = counts[p]
            if not cnt:
                out.append(None)
                continue
            o, cap = int(offsets[p]), bucket_capacity(cnt)
            idx = perm[o:o + cnt]
            if cap > cnt:
                idx = torch.cat([idx, perm.new_full((cap - cnt,), zero_row)])
            cols = tuple(DeviceColumn(
                c.dtype, data.index_select(0, idx),
                valid.index_select(0, idx),
                None if lengths is None else lengths.index_select(0, idx))
                for c, (data, valid, lengths) in zip(b.columns, srcs))
            piece = DeviceBatch(cols, rows[p])
            piece.rows_hint = cnt
            out.append(piece)
        return out

    def _open_session(self, ctx):
        """This exchange's transport session (``parallel/transport/``):
        the configured transport decides where map-side shards live
        (catalog handles ``inprocess``, spool files ``hostfile``, objects
        ``objectstore``). The session is the durable stage output; it is
        parked in ``ctx.cache``, so a re-execution serves the committed
        materialization, and the context's teardown closes it."""
        from spark_rapids_tpu_torch.parallel import transport as T
        transport = T.materialization_transport(ctx.conf)
        return transport.open(
            ctx.conf, f"x{os.getpid():x}-{id(self):x}",
            self.partitioning.num_partitions, owner=id(self),
            catalog=ctx.catalog, metrics=T.metrics_entry(ctx),
            device=self.plan_device())

    def _materialize_device(self, ctx):
        key = self._cache_key(True)
        if key in ctx.cache:
            return ctx.cache[key]
        from spark_rapids_tpu_torch import monitoring
        with monitoring.span("exchange-materialize", "shuffle",
                             args={"op": self.name,
                                   "partitions":
                                   self.partitioning.num_partitions}):
            return self._materialize_device_traced(ctx, key)

    def _materialize_device_traced(self, ctx, key):
        m = ctx.metrics_for(self)
        self._ensure_bounds(ctx, device=True)
        n = self.partitioning.num_partitions
        sess = self._open_session(ctx)
        bucket_rows = [0] * n           # exact counts (AQE coalescing)

        def keep(p: int, piece: DeviceBatch):
            bucket_rows[p] += piece.rows_hint
            sess.write_shard(p, piece)

        def flush_counted(batch: DeviceBatch, pids, counts: List[int]):
            total = sum(counts)
            if total == 0:
                return
            # Mostly-dead batches shrink to their live bucket first, so
            # the split moves live rows, not capacity.
            small = bucket_capacity(total)
            if small < batch.capacity:
                batch, pids = retry_on_oom(self._shrunk, batch, small)
            with timed(m, "splitTime"):
                pieces = kc.call(self._split, batch, pids, counts)
            for p, piece in enumerate(pieces):
                if piece is not None:
                    keep(p, piece)

        def flush_one(batch: DeviceBatch, _offset: int):
            metas, pulled = retry_on_oom(self._window_counts, [batch])
            flush_counted(batch, metas[0][1], pulled[0])

        def flush_window(window: List[DeviceBatch]):
            faults.fault_point("exchange.flush", owner=id(self))
            if n == 1:
                pieces, counts1 = retry_on_oom(shrink_all, window)
                for piece, cnt in zip(pieces, counts1):
                    if cnt:
                        piece.rows_hint = cnt
                        keep(0, piece)
                return
            # Every device step of the map side runs under the OOM ladder.
            # Where it leaves an OOM unmet, the rest of the window goes
            # batch by batch, each split in half while it does not fit
            # (split_on_oom); a batch keeps its pieces only once all are
            # cut, so none is kept twice.
            rest = window
            try:
                metas, pulled = retry_on_oom(self._window_counts, window)
                for i, ((batch, pids, _), counts) in enumerate(
                        zip(metas, pulled)):
                    rest = window[i:]
                    flush_counted(batch, pids, counts)
                rest = []
            except Exception as e:
                if not is_unmet_oom(e):
                    raise
                traceback.clear_frames(e.__traceback__)
            metas = batch = pids = None
            for b in rest:
                for _ in split_on_oom(flush_one, b):
                    pass

        child = self.children[0]
        max_window_bytes = max(min(int(ctx.conf.get(C.BATCH_SIZE_BYTES)),
                                   ctx.catalog.device_budget) // 4, 1 << 20)
        window: List[DeviceBatch] = []
        window_bytes = 0
        # The map-side partition loop runs through the partition
        # pipeline: the child's host half (scan decode, wire encode and
        # pack) runs prefetchPartitions ahead on host threads while this
        # one ordered consumer uploads and splits (parallel/pipeline.py;
        # the serial pipeline streams exactly as before).
        from spark_rapids_tpu_torch.parallel import pipeline as PL
        try:
            with timed(m, "materializeTime"):
                nchild = child.num_partitions(ctx)
                pipe = PL.open_pipeline(ctx, child, nchild)
                try:
                    for cp in range(nchild):
                        for b in pipe.consume(
                                cp, lambda cp=cp:
                                child.execute_device_recovering(ctx, cp)):
                            window.append(b)
                            window_bytes += b.device_size_bytes()
                            if len(window) >= _WINDOW or \
                                    window_bytes >= max_window_bytes:
                                flush_window(window)
                                window, window_bytes = [], 0
                finally:
                    pipe.close()
                if window:
                    flush_window(window)
        except BaseException:
            # A partial materialization must leave no catalog entries,
            # spool files or objects: the recovery ladder runs it again
            # from scratch.
            sess.abort()
            raise
        sess.commit()
        ctx.cache[key] = sess
        ctx.cache[key + ":rows"] = bucket_rows
        return sess

    def _forget(self, ctx):
        """Drop this exchange's device materialization from the context
        and return its session (None when there is none)."""
        key = self._cache_key(True)
        ctx.cache.pop(key + ":rows", None)
        ctx.cache.pop(f"shuffle-groups:{id(self):x}", None)
        return ctx.cache.pop(key, None)

    def release(self, ctx, partition: Optional[int] = None):
        """Release one reduce partition's served pieces, or close the
        whole session and forget the materialization (``partition``
        None): an exchange built for one operator's out-of-core pass
        frees its buckets as it finishes them."""
        if partition is not None:
            sess = ctx.cache.get(self._cache_key(True))
            if sess is not None:
                sess.release_partition(partition)
            return
        sess = self._forget(ctx)
        if sess is not None:
            sess.close()

    def _materialize_host(self, ctx) -> List[List[HostBatch]]:
        key = self._cache_key(False)
        if key in ctx.cache:
            return ctx.cache[key]
        self._ensure_bounds(ctx, device=False)
        n = self.partitioning.num_partitions
        buckets: List[List[HostBatch]] = [[] for _ in range(n)]
        child = self.children[0]
        for cp in range(child.num_partitions(ctx)):
            for hb in child.execute_host(ctx, cp):
                pids = self.partitioning.partition_ids_host(hb)
                for p, piece in enumerate(split_host_batch(hb, pids, n)):
                    buckets[p].append(piece)
        ctx.cache[key] = buckets
        return buckets

    # -- the reduce side ------------------------------------------------------
    def execute_device(self, ctx, partition):
        """The partition's pieces (its group's, when coalesced),
        concatenated up to the batch target of capacity; the pieces'
        exact counts make each output's ``rows_hint``. A piece served
        alone stays pinned (un-spillable) until the consumer resumes."""
        from spark_rapids_tpu_torch import monitoring
        sess = self._materialize_device(ctx)
        m = ctx.metrics_for(self)
        target = effective_batch_target(int(ctx.conf.get(C.BATCH_SIZE_ROWS)))
        groups = self._groups(ctx)
        mine = groups[partition] if groups is not None else [partition]

        def concat(group: list) -> DeviceBatch:
            members = [sb.get() for sb in group]
            try:
                out = concat_batches(members, bucket_capacity(
                    sum(b.capacity for b in members)))
            finally:
                for sb in group:
                    sb.release(PRIORITY_SHUFFLE_OUTPUT)
            out.rows_hint = sum(sb.rows_hint for sb in group)
            return out

        def serve(group: list):
            faults.fault_point("exchange.serve", owner=id(self))
            span = monitoring.span("exchange-serve", "shuffle",
                                   args={"partition": partition,
                                         "shards": len(group)})
            single = len(group) == 1
            try:
                try:
                    if single:
                        with span:
                            out = group[0].get()
                    else:
                        with span, timed(m, "concatTime"):
                            out = retry_on_oom(concat, group)
                except WireCorruptionError as err:
                    # A kept piece failed its checksum even after the
                    # re-read: the data at rest is gone. Tag the loss with
                    # this exchange, so the planner recomputes this stage.
                    err.fault_owner = id(self)
                    raise
                record_batch(m, out)
                yield out
            finally:
                if single:
                    group[0].release(PRIORITY_SHUFFLE_OUTPUT)

        group: list = []
        group_cap = 0
        for b in mine:
            with monitoring.span("fetch-shards", "shuffle",
                                 level=monitoring.LEVEL_KERNEL,
                                 args={"bucket": b}):
                fetched = sess.fetch_shards(b)
            for sb in fetched:
                if group and group_cap + sb.capacity > target:
                    yield from serve(group)
                    group, group_cap = [], 0
                group.append(sb)
                group_cap += sb.capacity
        if group:
            yield from serve(group)

    def execute_host(self, ctx, partition):
        """The partition's host pieces. Under the device engine (a host
        subtree of a device-rooted plan) a coalesced exchange numbers its
        partitions by group, so partition p is group p's buckets there
        too."""
        buckets = self._materialize_host(ctx)
        groups = self._groups(ctx)
        for b in (groups[partition] if groups is not None else [partition]):
            yield from buckets[b]

    # -- runtime re-plan and stage hooks ----------------------------------------
    def observed_total_bytes(self, ctx) -> int:
        """Materialize the map side (once a context) and return the bytes
        its session observed (in process, the kept pieces' device
        bytes): what the runtime re-plan (``parallel/replan.py``)
        compares with the broadcast threshold."""
        return self._materialize_device(ctx).observed_bytes()

    def stage_prematerialize(self, ctx) -> None:
        """Materialize this stage's output now (idempotent against the
        context cache), the hook the concurrent stage pass calls. A probe
        side whose join the runtime re-plan demoted to a broadcast is
        never shuffled: the demoted join reads its child unshuffled."""
        if ctx.cache.get(f"replan-skip:{id(self):x}"):
            return
        if ctx.cache.get("engine") == "device":
            self._materialize_device(ctx)

    def stage_invalidate(self, ctx) -> None:
        """Drop this exchange's stage output: the session drops every
        shard it holds (catalog handles, spool files, objects) and the
        coalesced groups and host buckets are forgotten, so the next
        execution recomputes the stage from its parents'
        still-materialized outputs. A lost or persistently corrupt
        fetched shard lands here too (the fetch raises tagged with this
        exchange's id), and the recompute rewrites it."""
        sess = self._forget(ctx)
        ctx.cache.pop(self._cache_key(False), None)
        if sess is not None:
            sess.invalidate()


class BroadcastExchangeExec(Exec):
    """Collect the whole child into one batch shared by every consumer
    (GpuBroadcastExchangeExec). The single is a durable stage output: a
    spillable catalog handle at ``PRIORITY_BROADCAST``, re-acquired from
    whatever tier it sits on. The port's planner plans broadcast joins
    without it (the join collects its build side itself), as the
    reference's does."""

    def __init__(self, child: Exec):
        super().__init__(child)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def num_partitions(self, ctx) -> int:
        return 1

    def _cache_key(self, device: bool) -> str:
        return f"broadcast:{id(self):x}:{'dev' if device else 'host'}"

    def collect_single_device(self, ctx) -> DeviceBatch:
        key = self._cache_key(True)
        handle = ctx.cache.get(key)
        if handle is not None:
            batch = handle.get()
            handle.release(PRIORITY_BROADCAST)
            return batch
        from spark_rapids_tpu_torch import monitoring
        from spark_rapids_tpu_torch.parallel import pipeline as PL
        child = self.children[0]
        nchild = child.num_partitions(ctx)
        pipe = PL.open_pipeline(ctx, child, nchild)
        batches: List[DeviceBatch] = []
        try:
            with monitoring.span("broadcast-collect", "shuffle",
                                 args={"partitions": nchild}):
                for cp in range(nchild):
                    batches.extend(pipe.consume(
                        cp, lambda cp=cp:
                        child.execute_device_recovering(ctx, cp)))
        finally:
            pipe.close()
        if not batches:
            raise ValueError("broadcast of empty child needs a schema batch")
        # One batched sizes pull shrinks the large members to their live
        # rows; small ones keep their capacity (the join's kernels take
        # selection vectors).
        batches, _ = retry_on_oom(shrink_all, batches, MIN_SHRINK_BYTES)
        total = sum(b.capacity for b in batches)
        single = batches[0] if len(batches) == 1 else \
            retry_on_oom(concat_batches, batches, bucket_capacity(total))
        ctx.cache[key] = SpillableBatch(ctx.catalog, single,
                                        PRIORITY_BROADCAST)
        ctx.on_close.append(lambda: self.stage_invalidate(ctx))
        return single

    def collect_single_host(self, ctx) -> HostBatch:
        key = self._cache_key(False)
        if key in ctx.cache:
            return ctx.cache[key]
        hbs = []
        for cp in range(self.children[0].num_partitions(ctx)):
            hbs.extend(self.children[0].execute_host(ctx, cp))
        if not hbs:
            raise ValueError("broadcast of empty child")
        merged = concat_host_batches(hbs)
        ctx.cache[key] = merged
        return merged

    def stage_prematerialize(self, ctx) -> None:
        """Build the broadcast single now (idempotent), so sibling stages
        materialize concurrently (``parallel/pipeline.py``)."""
        if ctx.cache.get("engine") == "device":
            self.collect_single_device(ctx)

    def stage_invalidate(self, ctx) -> None:
        """Drop the broadcast's stage output, device and host copies."""
        dev = ctx.cache.pop(self._cache_key(True), None)
        ctx.cache.pop(self._cache_key(False), None)
        if dev is not None:
            dev.close()

    def execute_device(self, ctx, partition):
        yield self.collect_single_device(ctx)

    def execute_host(self, ctx, partition):
        yield self.collect_single_host(ctx)
