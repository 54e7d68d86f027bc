"""The planner's collective shuffle: a hash exchange lowered onto the
slot mesh (port of the JAX package's ``parallel/mesh_exchange.py``; ref
GpuShuffleExchangeExec.scala, whose UCX pull protocol the reference
turns into one collective).

With ``spark.rapids.sql.shuffle.transport=mesh`` (or the legacy
``mesh.enabled``) the planner emits ``MeshExchangeExec`` for hash
shuffles and hash repartitions. Its map side, once a query context:

1. child partitions are dealt onto the mesh's slots round robin
   (partition cp to slot ``cp % n``) and each slot's batches become one
   shard; ``_uniform_shards`` pads every shard to one capacity and one
   width a string column (and compacts a lone batch that still has its
   selection vector), so all shards have the reference's uniform
   shapes;
2. each shard's LOGICAL partition ids are computed once and folded onto
   slots: with np logical partitions on n slots, slot = pid //
   ceil(np / n) (counter ``meshPartitionFolds`` when np != n);
3. the two-phase sizes-then-data shuffle: at n > 1 and shards of at
   least ``TWO_PHASE_MIN_SHARD_ROWS`` rows, the per-destination counts
   are exchanged first and pulled in one host copy, and the data
   exchange's piece capacity is the observed maximum on the capacity
   ladder (its metric ``meshPieceCapacity``) instead of the whole shard;
   below the threshold the worst-case padding costs less than the
   sync; at n = 1 the exchange moves nothing, so it is skipped;
4. ``parallel/mesh.py``'s ``all_to_all_exchange`` over the query's local
   group (split by one K1 sort a shard, the transpose, the concat);
5. each slot's shard unfolds back into its logical partitions (one id
   pass over the received rows) and every logical partition's shard is
   written through the ``mesh`` transport session as a spillable
   catalog handle: consumers see logical partitions only.

A partitioning that is not collective-capable (``collective`` false:
a range partitioning, whose bounds come from a host sample) is served
by the single-process exchange with a warning and ``meshCollectiveSkipped``.
A failed collective (the ``mesh.exchange`` fault site) under
``spark.rapids.sql.mesh.degrade.enabled`` demotes every mesh exchange of
the query to the single-process exchange (``meshDegrades``, a context
flag) instead of failing it; off, the error propagates to the recovery
ladder. The exchange is a stage boundary (``stage_invalidate`` drops its
shards, the fallback's too); the host engine has no mesh and serves the
single-process exchange's buckets.

The port keeps no kernel cache, so the steps run directly.
"""

from __future__ import annotations

import logging
import os
from typing import List

import torch

from spark_rapids_tpu_torch import config as C, faults
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, DeviceColumn, bucket_capacity, string_repad)
from spark_rapids_tpu_torch.memory.stores import PRIORITY_SHUFFLE_OUTPUT
from spark_rapids_tpu_torch.ops.base import Exec, Schema, timed
from spark_rapids_tpu_torch.parallel import mesh as M
from spark_rapids_tpu_torch.parallel.partitioning import Partitioning

_LOG = logging.getLogger("spark_rapids_tpu_torch")

# Shards below this many rows skip the two-phase counts exchange: its
# host pull costs more than the worst-case padding it would avoid.
# Module-level so tests can lower it.
TWO_PHASE_MIN_SHARD_ROWS = 1 << 18


def mesh_for(ctx, device=None):
    """The query context's mesh: one local group of ``mesh_size()``
    slots over ``device``'s kind of device, made once a context."""
    m = ctx.cache.get("mesh:singleton")
    if m is None:
        m = ctx.cache["mesh:singleton"] = M.make_mesh(device=device)
    return m


def mesh_size() -> int:
    """The slot count a new mesh gets (``parallel/mesh.default_slots``)."""
    return M.default_slots()


def _uniform_shards(batches_per_dev: List[List[DeviceBatch]], schema: Schema,
                    devices) -> List[DeviceBatch]:
    """Coalesce each slot's batches into one shard, on its slot's device,
    and pad every shard to one common capacity and string width (an
    empty slot gets an all-NULL shard of no rows)."""
    from spark_rapids_tpu_torch.ops.sort import coalesce_to_single_batch
    shards = []
    for blist in batches_per_dev:
        if not blist:
            shards.append(None)
            continue
        single = coalesce_to_single_batch(blist)
        if single.sel is not None:
            # A lone filtered batch passes the coalesce with its
            # selection vector; a shard is dense.
            single = single.compact()
        shards.append(single)
    caps = [s.capacity for s in shards if s is not None]
    cap = bucket_capacity(max(caps)) if caps else 8
    widths = []
    for ci, (_, t) in enumerate(schema):
        ws = [s.columns[ci].string_width for s in shards
              if s is not None] if t.is_string else []
        widths.append((max(ws) if ws else 8) if t.is_string else None)
    out = []
    for s, dev in zip(shards, devices):
        if s is None:
            cols = tuple(DeviceColumn.full_null(t, cap, widths[ci] or 8,
                                                device=dev)
                         for ci, (_, t) in enumerate(schema))
            out.append(DeviceBatch(cols, torch.zeros(
                (), dtype=torch.int32, device=dev)))
            continue
        s = DeviceBatch(tuple(
            string_repad(c, widths[ci]) if c.dtype.is_string else c
            for ci, c in enumerate(s.columns)), s.num_rows)
        if s.capacity != cap:
            s = s.gather(torch.arange(cap, dtype=torch.int64,
                                      device=s.device), s.num_rows)
        out.append(M._to(s, dev))
    return out


class MeshExchangeExec(Exec):
    """Hash shuffle over the slot mesh as one collective exchange."""

    def __init__(self, child: Exec, partitioning: Partitioning):
        super().__init__(child)
        self.partitioning = partitioning

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def num_partitions(self, ctx) -> int:
        return self.partitioning.num_partitions

    def _cache_key(self, device: bool) -> str:
        return f"meshx:{id(self):x}" if device else f"meshx-host:{id(self):x}"

    def _fallback(self):
        """The single-process exchange over the same child and
        partitioning: the degrade target. Built once an exec, so its
        per-context materialization keys stay stable across retries."""
        fb = getattr(self, "_fallback_exec", None)
        if fb is None:
            from spark_rapids_tpu_torch.parallel.exchange import \
                ShuffleExchangeExec
            fb = self._fallback_exec = ShuffleExchangeExec(
                self.children[0], self.partitioning)
        return fb

    def _degrade(self, ctx, err) -> None:
        """The collective failed: demote THIS query's mesh exchanges to
        the single-process path (a context flag every mesh exchange of
        the plan reads) instead of failing the query."""
        _LOG.warning("mesh collective failed in %s; degrading this "
                     "query's exchanges to the single-process shuffle "
                     "path: %s", self.name, err)
        faults.record("meshDegrades")
        ctx.metrics_for(self).add("meshDegrades", 1)
        ctx.cache["mesh.degraded"] = True

    def _skip(self, ctx, m) -> None:
        _LOG.warning("mesh collective skipped in %s: partitioning %r is "
                     "not collective-capable; serving this exchange from "
                     "the single-process shuffle path", self.name,
                     type(self.partitioning).__name__)
        faults.record("meshCollectiveSkipped")
        m.add("meshCollectiveSkipped", 1)
        ctx.cache[f"meshx-skip:{id(self):x}"] = True

    def _exchange(self, mesh, shards: List[DeviceBatch], fold: int,
                  m) -> List[DeviceBatch]:
        """Steps 2-4 of the module doc: folded ids, the two-phase
        counts, the collective."""
        n = mesh.size
        pids = [self.partitioning.partition_ids(s) // fold for s in shards]
        piece_cap = None
        if n > 1 and shards[0].capacity >= TWO_PHASE_MIN_SHARD_ROWS:
            counts = M.exchange_counts(mesh, shards, pids)
            # One host copy of every slot's counts.
            top = int(torch.stack([c.max().to(mesh.devices[0])
                                   for c in counts]).max())
            piece_cap = bucket_capacity(max(top, 1))
            if piece_cap >= shards[0].capacity:
                piece_cap = None        # the padding would not shrink
            m.add("meshPieceCapacity", piece_cap or shards[0].capacity)
        return M.all_to_all_exchange(mesh, shards, pids,
                                     piece_capacity=piece_cap)

    def _materialize(self, ctx):
        """Run the collective and register each logical partition's
        shard through the mesh transport session; None after a degrade or
        a skip (the caller serves from the single-process exchange)."""
        key = self._cache_key(True)
        if key in ctx.cache:
            return ctx.cache[key]
        if ctx.cache.get(f"meshx-skip:{id(self):x}"):
            return None
        m = ctx.metrics_for(self)
        np_parts = self.partitioning.num_partitions
        if np_parts < 1 or not getattr(self.partitioning, "collective",
                                       True):
            self._skip(ctx, m)
            return None
        plan_dev = self.plan_device()
        mesh = mesh_for(ctx, plan_dev)
        n = mesh.size
        fold = -(-np_parts // n)        # ceil: logical ids per slot
        if fold > 1 or np_parts != n:
            faults.record("meshPartitionFolds")
            m.add("meshPartitionFolds", 1)
        per_dev: List[List[DeviceBatch]] = [[] for _ in range(n)]
        child = self.children[0]
        for cp in range(child.num_partitions(ctx)):
            for batch in child.execute_device_recovering(ctx, cp):
                per_dev[cp % n].append(batch)
        from spark_rapids_tpu_torch import monitoring
        with monitoring.span("exchange-materialize", "shuffle",
                             args={"op": self.name, "partitions": np_parts,
                                   "slots": n}), timed(m, "shuffleTime"):
            try:
                faults.fault_point("mesh.exchange", owner=id(self))
                shards = _uniform_shards(per_dev, self.schema, mesh.devices)
                per_dev = None
                out = self._exchange(mesh, shards, fold, m)
                shards = None
                target = plan_dev if plan_dev is not None \
                    else mesh.devices[0]
                parts = [M._to(p, torch.device(target)) for p in out]
            except Exception as err:
                if not bool(ctx.conf.get(C.MESH_DEGRADE_ENABLED)):
                    raise
                self._degrade(ctx, err)
                return None
        from spark_rapids_tpu_torch.parallel import transport as T
        sess = T.get_transport("mesh").open(
            ctx.conf, f"meshx{os.getpid():x}-{id(self):x}", np_parts,
            owner=id(self), catalog=ctx.catalog,
            metrics=T.metrics_entry(ctx))
        if fold == 1 and np_parts <= n:
            for p in range(np_parts):
                sess.write_shard(p, parts[p])
        else:
            # Unfold: each slot's shard splits back into its logical
            # partitions (one id pass over the received rows).
            for d in range(n):
                lo = d * fold
                cnt = min(np_parts - lo, fold)
                if cnt <= 0:
                    continue
                shard = parts[d]
                shard_pids = self.partitioning.partition_ids(shard)
                live = shard.row_mask()
                for j in range(cnt):
                    sess.write_shard(lo + j, shard.compact(
                        (shard_pids == lo + j) & live))
        sess.commit()
        ctx.cache[key] = sess
        return sess

    def execute_device(self, ctx, partition):
        sess = None
        if not ctx.cache.get("mesh.degraded"):
            sess = self._materialize(ctx)
        if sess is None:          # degraded (here or by another exchange)
            yield from self._fallback().execute_device(ctx, partition)
            return
        for h in sess.fetch_shards(partition):
            batch = h.get()
            try:
                yield batch
            finally:
                h.release(PRIORITY_SHUFFLE_OUTPUT)

    def stage_invalidate(self, ctx) -> None:
        """Drop this exchange's shards and its fallback's (the stage
        boundary contract, ``parallel/stages.py``)."""
        sess = ctx.cache.pop(self._cache_key(True), None)
        ctx.cache.pop(self._cache_key(False), None)
        ctx.cache.pop(f"meshx-skip:{id(self):x}", None)
        if sess is not None:
            sess.invalidate()
        fb = getattr(self, "_fallback_exec", None)
        if fb is not None:
            fb.stage_invalidate(ctx)

    def execute_host(self, ctx, partition):
        """The host engine has no mesh: the single-process exchange's
        buckets (the same rows, the oracle's path)."""
        from spark_rapids_tpu_torch.parallel.partitioning import \
            split_host_batch
        key = self._cache_key(False)
        if key not in ctx.cache:
            n = self.partitioning.num_partitions
            buckets = [[] for _ in range(n)]
            child = self.children[0]
            for cp in range(child.num_partitions(ctx)):
                for hb in child.execute_host(ctx, cp):
                    pids = self.partitioning.partition_ids_host(hb)
                    for p, piece in enumerate(
                            split_host_batch(hb, pids, n)):
                        buckets[p].append(piece)
            ctx.cache[key] = buckets
        yield from iter(ctx.cache[key][partition])
