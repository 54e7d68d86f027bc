"""Slot-mesh collectives: the distribution layer (port of the JAX
package's ``parallel/mesh.py``; ref UCX.scala's shuffle pull protocol,
which the reference turns into a planned collective exchange).

The reference writes each step once and runs it under ``shard_map`` over
a ``jax.sharding.Mesh``: one program, every device's shard at once. Torch
has no single-controller ``shard_map``, so each step here is a per-shard
body over a small *group* object, which does the collective between the
bodies:

- :class:`LocalGroup` (``make_mesh``): n slots in this process, laid over
  its devices (slot i on CUDA card ``i % cards``; every slot on the CPU
  for a CPU mesh). A collective transposes the pieces from their source
  slot to their destination slot and moves each piece to its destination
  slot's device; on the same device no copy is made. The planner's mesh
  exchange uses this kind, as the reference's single-controller program
  does.
- :class:`ProcessGroupMesh` (``make_process_mesh``): ``torch.distributed``,
  one rank a process and one slot a rank (NCCL on the card, gloo over CPU
  processes). Pieces of variable size travel as the reference's
  counts-then-data: one int64 counts exchange (``all_to_all_single``),
  then every column padded to the common piece capacity in one
  ``all_to_all_single`` a tensor; ``all_gather_batch`` uses
  ``all_gather_into_tensor`` the same way.

Every function takes and returns the shards THIS process holds, in the
group's ``local_slots`` order (all n for a local group, one for a rank).
Output order is the reference's: index i of what a slot receives is the
piece from peer i, concatenated in peer order.

The split of a shard into its n destination pieces is one stable sort of
its partition ids (``native.stable_argsort_u32``, kernel K1 on the card)
and one gather a piece, with no host sync: piece d holds the first
``piece_capacity`` rows bound for d (the whole shard capacity by
default, the reference's worst case), its row count clamped on the
device. ``exchange_counts`` is the two-phase shuffle's first phase: the
counts every slot will receive, from which the planner sizes the piece
capacity of the data exchange.

The mesh size of a local group is the env ``SRT_MESH_SLOTS`` when set
(the counterpart of the reference's
``--xla_force_host_platform_device_count``: tests run an 8-slot mesh on
the CPU), else the number of visible CUDA cards, else 1.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, DeviceColumn, bucket_capacity, concat_batches,
    string_repad)
from spark_rapids_tpu_torch.parallel.partitioning import Partitioning

DATA_AXIS = "data"
SLOTS_ENV = "SRT_MESH_SLOTS"


def default_slots() -> int:
    """The slot count of a mesh made without one: ``SRT_MESH_SLOTS``,
    else the visible CUDA cards, else 1."""
    env = os.environ.get(SLOTS_ENV, "").strip()
    if env:
        return max(int(env), 1)
    return max(torch.cuda.device_count(), 1) \
        if torch.cuda.is_available() else 1


def _to(batch: DeviceBatch, device: torch.device) -> DeviceBatch:
    """``batch`` on ``device``: itself where it already lies there."""
    if batch.device == device:
        return batch
    cols = tuple(DeviceColumn(
        c.dtype, c.data.to(device), c.validity.to(device),
        None if c.lengths is None else c.lengths.to(device))
        for c in batch.columns)
    out = DeviceBatch(cols, batch.num_rows.to(device),
                      sel=None if batch.sel is None
                      else batch.sel.to(device))
    out.rows_hint = batch.rows_hint
    return out


class LocalGroup:
    """n mesh slots in this process (``kind`` "local")."""

    kind = "local"

    def __init__(self, devices: Sequence[torch.device],
                 axis: str = DATA_AXIS):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.axis_names = (axis,)
        self.local_slots = list(range(self.size))

    def exchange(self, pieces: List[List[DeviceBatch]]
                 ) -> List[List[DeviceBatch]]:
        """``pieces[src][dst]`` -> ``out[dst][src]``, each piece moved to
        its destination slot's device."""
        n = self.size
        return [[_to(pieces[src][dst], self.devices[dst])
                 for src in range(n)] for dst in range(n)]

    def exchange_counts(self, counts: List[torch.Tensor]
                        ) -> List[torch.Tensor]:
        """``counts[src]`` (n,) -> out[dst] (n,) with out[dst][src] =
        counts[src][dst]."""
        n = self.size
        return [torch.stack([counts[src][dst].to(self.devices[dst])
                             for src in range(n)]) for dst in range(n)]

    def gather(self, batches: List[DeviceBatch]) -> List[List[DeviceBatch]]:
        """Every slot's batch, on every slot's device."""
        return [[_to(b, dev) for b in batches] for dev in self.devices]


class ProcessGroupMesh:
    """One slot a rank of the default ``torch.distributed`` process group
    (``kind`` "process"); ``device`` is where this rank's tensors live
    (its card under NCCL, the CPU under gloo)."""

    kind = "process"

    def __init__(self, device, axis: str = DATA_AXIS):
        import torch.distributed as dist
        self._dist = dist
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.device = torch.device(device)
        self.devices = [self.device] * self.size
        self.axis_names = (axis,)
        self.local_slots = [self.rank]

    def _max(self, values: List[int]) -> List[int]:
        t = torch.tensor(values, dtype=torch.int64, device=self.device)
        self._dist.all_reduce(t, op=self._dist.ReduceOp.MAX)
        return [int(v) for v in t.tolist()]

    def _common(self, batches: List[DeviceBatch]) -> tuple:
        """(capacity, string widths) every rank pads its batches to."""
        b0 = batches[0]
        widths = [c.string_width if c.dtype.is_string else 0
                  for c in b0.columns]
        agreed = self._max([max(b.capacity for b in batches)] + widths)
        return agreed[0], agreed[1:]

    @staticmethod
    def _padded(t: torch.Tensor, cap: int) -> torch.Tensor:
        if t.shape[0] == cap:
            return t
        pad = t.new_zeros((cap - t.shape[0],) + tuple(t.shape[1:]))
        return torch.cat([t, pad])

    def _wire(self, batches: List[DeviceBatch], cap: int, widths):
        """Per column, the (data, validity as uint8, lengths) tensors of
        every batch, repadded to the common width and capacity and
        stacked along a leading peer axis."""
        out = []
        for ci, c0 in enumerate(batches[0].columns):
            cols = [b.columns[ci] for b in batches]
            if c0.dtype.is_string:
                cols = [string_repad(c, widths[ci]) for c in cols]
            parts = [torch.stack([self._padded(c.data, cap) for c in cols]),
                     torch.stack([self._padded(c.validity, cap)
                                  for c in cols]).to(torch.uint8)]
            if c0.dtype.is_string:
                parts.append(torch.stack([self._padded(c.lengths, cap)
                                          for c in cols]))
            out.append(parts)
        return out

    def _unwire(self, proto: DeviceBatch, tensors, counts: torch.Tensor,
                n: int) -> List[DeviceBatch]:
        got = []
        for i in range(n):
            cols = []
            for c0, parts in zip(proto.columns, tensors):
                lengths = parts[2][i] if c0.dtype.is_string else None
                cols.append(DeviceColumn(c0.dtype, parts[0][i],
                                         parts[1][i].to(torch.bool),
                                         lengths))
            got.append(DeviceBatch(tuple(cols), counts[i].to(torch.int32)))
        return got

    def exchange(self, pieces: List[List[DeviceBatch]]
                 ) -> List[List[DeviceBatch]]:
        """This rank's n pieces (``pieces[0][dst]``) -> the n pieces the
        peers sent it, counts first, then the padded data."""
        mine = [p if p.sel is None else p.compact() for p in pieces[0]]
        n = self.size
        counts = torch.stack([p.num_rows.to(torch.int64) for p in mine])
        recv_counts = torch.empty_like(counts)
        self._dist.all_to_all_single(recv_counts, counts)
        cap, widths = self._common(mine)
        recv = []
        for parts in self._wire(mine, cap, widths):
            got = []
            for t in parts:
                t = t.contiguous()
                r = torch.empty_like(t)
                self._dist.all_to_all_single(r, t)
                got.append(r)
            recv.append(got)
        return [self._unwire(mine[0], recv, recv_counts, n)]

    def exchange_counts(self, counts: List[torch.Tensor]
                        ) -> List[torch.Tensor]:
        c = counts[0].to(torch.int64).contiguous()
        out = torch.empty_like(c)
        self._dist.all_to_all_single(out, c)
        return [out]

    def gather(self, batches: List[DeviceBatch]) -> List[List[DeviceBatch]]:
        b = batches[0] if batches[0].sel is None else batches[0].compact()
        n = self.size
        cap, widths = self._common([b])
        count = b.num_rows.to(torch.int64).reshape(1)
        counts = torch.empty(n, dtype=torch.int64, device=self.device)
        gather = self._dist.all_gather_into_tensor
        gather(counts, count)
        recv = []
        for parts in self._wire([b], cap, widths):
            got = []
            for t in parts:
                r = t.new_empty((n,) + tuple(t.shape[1:]))
                gather(r, t.contiguous())
                got.append(r)
            recv.append(got)
        return [self._unwire(b, recv, counts, n)]


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS,
              device=None) -> LocalGroup:
    """A local group of ``n_devices`` slots (default: ``default_slots``).
    ``device`` None lays the slots over the visible CUDA cards (raising
    without one, as every entry point does); a CPU device puts every
    slot on the CPU."""
    from spark_rapids_tpu_torch import resolve_device
    n = default_slots() if n_devices is None else int(n_devices)
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = max(torch.cuda.device_count(), 1)
        first = dev.index or 0
        devices = [torch.device("cuda", (first + i) % cards)
                   for i in range(n)]
    else:
        devices = [dev] * n
    return LocalGroup(devices, axis)


def make_process_mesh(device=None, axis: str = DATA_AXIS
                      ) -> ProcessGroupMesh:
    """The default process group as a mesh, this rank's tensors on
    ``device`` (None: the card)."""
    from spark_rapids_tpu_torch import resolve_device
    return ProcessGroupMesh(resolve_device(device), axis)


# ---------------------------------------------------------------------------
# Collective shuffle (per-shard bodies)
# ---------------------------------------------------------------------------

def split_pieces(batch: DeviceBatch, pids: torch.Tensor, n: int,
                 piece_capacity: Optional[int] = None
                 ) -> List[DeviceBatch]:
    """The shard's n destination pieces, each a packed prefix of
    ``min(piece_capacity, capacity)`` slots holding its first rows in
    their order in the shard (the reference's ``split_batch`` and its
    truncation). One K1 sort of the ids, one gather a piece, no sync."""
    from spark_rapids_tpu_torch.ops import native
    cap = batch.capacity
    cap_p = cap if piece_capacity is None else min(int(piece_capacity), cap)
    dev = batch.device
    live = batch.row_mask()
    key = torch.where(live, pids.to(torch.int64),
                      torch.full((), n, dtype=torch.int64, device=dev))
    sort = native.stable_argsort_u32 \
        if native.kernel_enabled("radixSort") \
        else native.stable_argsort_u32_library
    perm = sort(key).to(torch.int64)
    counts = torch.bincount(key, minlength=n + 1)[:n]
    offsets = torch.cumsum(counts, 0) - counts
    slots = torch.arange(cap_p, dtype=torch.int64, device=dev)
    pieces = []
    for d in range(n):
        idx = perm.index_select(0, (offsets[d] + slots).clamp(max=cap - 1))
        pieces.append(batch.gather(
            idx, counts[d].clamp(max=cap_p).to(torch.int32)))
    return pieces


def all_to_all_exchange(group, batches: List[DeviceBatch],
                        pids: List[torch.Tensor], n_devices: int = None,
                        piece_capacity: Optional[int] = None
                        ) -> List[DeviceBatch]:
    """The hash-shuffle step of this process's shards: split each into
    its per-destination pieces, exchange them over ``group``, and
    concatenate what each slot received (peer order) into one batch of
    ``bucket_capacity`` of the pieces' summed capacity.

    ``piece_capacity`` is the per-destination piece size. None is the
    worst case, every piece at the full shard capacity (an n-fold wire
    inflation); the planner's two-phase path exchanges the counts first
    and passes the observed maximum."""
    n = group.size if n_devices is None else n_devices
    pieces = [split_pieces(b, p, n, piece_capacity)
              for b, p in zip(batches, pids)]
    received = group.exchange(pieces)
    return [concat_batches(parts, bucket_capacity(
        sum(p.capacity for p in parts))) for parts in received]


def exchange_counts(group, batches: List[DeviceBatch],
                    pids: List[torch.Tensor], n_devices: int = None
                    ) -> List[torch.Tensor]:
    """Phase 1 of the two-phase shuffle: each shard's per-destination
    live-row counts, exchanged so every slot holds the counts of the
    pieces it WILL receive ((n,) int64 a slot, index i from peer i)."""
    n = group.size if n_devices is None else n_devices
    counts = []
    for b, p in zip(batches, pids):
        key = torch.where(b.row_mask(), p.to(torch.int64),
                          torch.full((), n, dtype=torch.int64,
                                     device=b.device))
        counts.append(torch.bincount(key, minlength=n + 1)[:n])
    return group.exchange_counts(counts)


def all_gather_batch(group, batches: List[DeviceBatch],
                     n_devices: int = None) -> List[DeviceBatch]:
    """Every slot's shard replicated to every slot (a broadcast build
    side's one-time all-gather), concatenated in peer order."""
    got = group.gather(batches)
    mine = got if group.kind == "process" else \
        [got[s] for s in group.local_slots]
    return [concat_batches(parts, bucket_capacity(
        sum(p.capacity for p in parts))) for parts in mine]


# ---------------------------------------------------------------------------
# Distributed plan steps
# ---------------------------------------------------------------------------

def distributed_aggregate_step(mesh, agg_exec, partitioning: Partitioning,
                               axis: str = DATA_AXIS):
    """A distributed aggregation step over ``mesh``: per shard a partial
    update, the hash exchange by group key, then merge and finalize of
    what each slot received. ``agg_exec`` is a ``HashAggregateExec`` used
    for its batch functions only. The step takes and returns this
    process's shards."""

    def step(shards: List[DeviceBatch]) -> List[DeviceBatch]:
        partials = [agg_exec._update_batch(b, 0) for b in shards]
        pids = [partitioning.partition_ids(p) for p in partials]
        exchanged = all_to_all_exchange(mesh, partials, pids)
        return [agg_exec._finalize_batch(agg_exec._merge_batch(x))
                for x in exchanged]

    return step


def distributed_join_agg_step(mesh, join_exec, agg_exec,
                              join_partitioning_left,
                              join_partitioning_right,
                              agg_partitioning, axis: str = DATA_AXIS,
                              join_out_capacity: Optional[int] = None):
    """A distributed join + aggregate step (TPC-H q3's shape): per shard,
    both sides exchanged by join key, a local inner hash join (K3
    probe), a partial aggregate, the exchange by group key, the final
    aggregate. Returns ``(results, overflowed)``: the join's pair buffer
    is bounded by ``join_out_capacity`` (default: the exact |L| x |R|
    product when it is at most 2^20, else 4x the inputs), and
    ``overflowed`` is a 0-d bool a shard, true where pairs were cut."""
    from spark_rapids_tpu_torch.columnar.rowmove import gather_rows
    from spark_rapids_tpu_torch.ops import join as J
    lkeys = J._key_ordinals(join_exec.left_keys)
    rkeys = J._key_ordinals(join_exec.right_keys)

    def join_one(lex: DeviceBatch, rex: DeviceBatch):
        built = J.build_side(rex, rkeys)
        lo, counts, _ = J.probe_ranges(built, lex, lkeys)
        if join_out_capacity is not None:
            out_cap = bucket_capacity(join_out_capacity)
        elif lex.capacity * rex.capacity <= (1 << 20):
            out_cap = bucket_capacity(lex.capacity * rex.capacity)
        else:
            out_cap = bucket_capacity(4 * (lex.capacity + rex.capacity))
        overflow = counts.to(torch.int64).sum() > out_cap
        p, b, valid, total = J.expand_pairs(lo, counts, out_cap,
                                            lex.capacity)
        valid = J._pair_keys_equal(built, b, lex, p, lkeys, valid)
        probe = gather_rows(lex, p, total, valid_dst=valid)
        build = gather_rows(built.batch, b, total, valid_dst=valid)
        pairs = DeviceBatch(tuple(probe.columns) + tuple(build.columns),
                            total).compact(valid)
        return agg_exec._update_batch(pairs, 0), overflow

    def step(lefts: List[DeviceBatch], rights: List[DeviceBatch]):
        lex = all_to_all_exchange(mesh, lefts, [
            join_partitioning_left.partition_ids(b) for b in lefts])
        rex = all_to_all_exchange(mesh, rights, [
            join_partitioning_right.partition_ids(b) for b in rights])
        joined = [join_one(a, b) for a, b in zip(lex, rex)]
        partials = [j[0] for j in joined]
        exchanged = all_to_all_exchange(mesh, partials, [
            agg_partitioning.partition_ids(p) for p in partials])
        outs = [agg_exec._finalize_batch(agg_exec._merge_batch(x))
                for x in exchanged]
        return outs, [j[1] for j in joined]

    return step


def shard_batches(mesh, per_device: List[DeviceBatch],
                  axis: str = DATA_AXIS) -> List[DeviceBatch]:
    """Lay out per-slot shards on the mesh: each of this process's slots
    gets its shard on its slot's device (a rank passes its one shard)."""
    if mesh.kind == "process":
        return [_to(per_device[0], mesh.device)]
    return [_to(b, dev) for b, dev in zip(per_device, mesh.devices)]
