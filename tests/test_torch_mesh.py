"""Port parity: the slot-mesh collectives (``parallel/mesh.py``) and the
multichip dry run (``entry.dryrun_multichip``), as ``tests/test_mesh.py``
and ``__graft_entry__.dryrun_multichip`` pin the JAX package's.

- At 8 local CPU slots beside the reference's 8 virtual devices
  (``tests/conftest.py``), on the same shards and the same partition ids:
  ``all_to_all_exchange`` (worst-case and truncated piece capacity),
  ``exchange_counts``, ``all_gather_batch``,
  ``distributed_aggregate_step`` and ``distributed_join_agg_step`` (its
  overflow flag included) give each slot the reference device's rows,
  shard by shard and in order.
- ``make_mesh``'s slot count comes from ``SRT_MESH_SLOTS``.
- The process-group mesh: three gloo ranks in ``spawn``-started
  processes (``tests/fixtures/torch_mesh_rank.py``) run
  ``exchange_counts``, ``all_to_all_exchange`` (worst-case and truncated
  piece capacity, string widths that differ by rank) and
  ``all_gather_batch``; each rank holds what slot r of a 3-slot local
  group holds on the same shards.
- ``dryrun_multichip(4, device="cpu")``: four gloo ranks in
  ``spawn``-started processes; each rank's groups equal the reference
  device's of the same index under ``distributed_join_agg_step`` over
  ``make_mesh(4)``.

All columns are integers or strings: every comparison is exact.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import multiprocessing
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.exprs.base import BoundReference as JRef
from spark_rapids_tpu.ops import AggSpec as JAggSpec
from spark_rapids_tpu.ops import CountStar as JCountStar
from spark_rapids_tpu.ops import HashAggregateExec as JHashAggregateExec
from spark_rapids_tpu.ops import Sum as JSum
from spark_rapids_tpu.ops.base import InMemorySourceExec as JSource
from spark_rapids_tpu.ops.join import ShuffledHashJoinExec as JJoin
from spark_rapids_tpu.parallel import HashPartitioning as JHash
from spark_rapids_tpu.parallel import mesh as JM
from spark_rapids_tpu.shims import shard_map

from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar import host as thost
from spark_rapids_tpu_torch.exprs.base import BoundReference as Ref
from spark_rapids_tpu_torch.ops import (
    AggSpec, CountStar, HashAggregateExec, InMemorySourceExec, Sum)
from spark_rapids_tpu_torch.parallel import mesh as M
from spark_rapids_tpu_torch.parallel.partitioning import HashPartitioning

N = 8
CAP, LIVE = 64, 53
SCHEMA = (("k", "int64"), ("v", "int64"), ("s", "string"))


def _shard_dicts(seed: int, n: int = N, live: int = LIVE):
    rng = np.random.default_rng(seed)
    return [{"k": rng.integers(0, 37, live).tolist(),
             "v": rng.integers(-1000, 1000, live).tolist(),
             "s": [f"t{int(i) % 7}" for i in rng.integers(0, 99, live)]}
            for _ in range(n)]


def _schema(D):
    return tuple((nm, D.type_named(t)) for nm, t in SCHEMA)


def _port_shards(dicts, cap=CAP):
    return [thost.host_to_device(thost.HostBatch.from_pydict(
        _schema(dt), d), capacity=cap, device="cpu") for d in dicts]


def _ref_shards(dicts, cap=CAP):
    return [jhost.host_to_device(jhost.HostBatch.from_pydict(
        _schema(jdt), d), capacity=cap) for d in dicts]


def _pids(seed: int, n: int = N, cap: int = CAP):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n, cap).astype(np.int32) for _ in range(n)]


def _ref_run(fn, n, *inputs):
    """``fn`` on every reference device's shard of ``inputs`` (lists of
    per-device batches or arrays) under ``shard_map``; the per-device
    outputs, as numpy pytrees."""
    mesh = JM.make_mesh(n)

    def inner(*stacked):
        local = [jax.tree.map(lambda x: x[0], s) for s in stacked]
        return jax.tree.map(lambda x: x[None], fn(*local))

    args = [JM.shard_batches(mesh, list(x)) if not isinstance(
        x[0], np.ndarray) else jnp.stack([jnp.asarray(a) for a in x])
        for x in inputs]
    f = jax.jit(shard_map(inner, mesh, in_specs=tuple(
        P("data") for _ in inputs), out_specs=P("data")))
    out = f(*args)
    return [jax.tree.map(lambda x: np.asarray(x)[d], out)
            for d in range(n)]


def _ref_rows(batch):
    return jhost.device_to_host(batch).to_pylist()


def _rows(batch):
    return thost.device_to_host(batch).to_pylist()


@pytest.fixture()
def mesh():
    return M.make_mesh(N, device="cpu")


def test_make_mesh_slots_from_env(monkeypatch):
    monkeypatch.setenv(M.SLOTS_ENV, "8")
    assert M.default_slots() == 8
    m = M.make_mesh(device="cpu")
    assert m.size == 8 and m.kind == "local"
    assert m.devices == [torch.device("cpu")] * 8
    assert m.axis_names == (M.DATA_AXIS,) == (JM.DATA_AXIS,)
    monkeypatch.setenv(M.SLOTS_ENV, "3")
    assert M.make_mesh(device="cpu").size == 3
    monkeypatch.delenv(M.SLOTS_ENV)
    assert M.default_slots() == (max(torch.cuda.device_count(), 1)
                                 if torch.cuda.is_available() else 1)


@pytest.mark.parametrize("piece_capacity", [None, 16, 4])
def test_all_to_all_exchange_matches_reference(mesh, piece_capacity):
    """Slot d receives the reference device d's rows in the same order:
    peer order, each piece the first rows bound for d, truncated to the
    piece capacity where one is given."""
    dicts, pids = _shard_dicts(1), _pids(2)
    want = _ref_run(lambda b, p: JM.all_to_all_exchange(
        b, p, N, piece_capacity=piece_capacity), N, _ref_shards(dicts),
        pids)
    got = M.all_to_all_exchange(
        mesh, _port_shards(dicts),
        [torch.from_numpy(p.astype(np.int64)) for p in pids],
        piece_capacity=piece_capacity)
    assert len(got) == N
    for d in range(N):
        assert got[d].capacity == want[d].capacity
        assert _rows(got[d]) == _ref_rows(want[d]), f"slot {d}"


def test_exchange_counts_matches_reference(mesh):
    dicts, pids = _shard_dicts(3), _pids(4)
    want = _ref_run(lambda b, p: JM.exchange_counts(b, p, N), N,
                    _ref_shards(dicts), pids)
    got = M.exchange_counts(
        mesh, _port_shards(dicts),
        [torch.from_numpy(p.astype(np.int64)) for p in pids])
    for d in range(N):
        assert got[d].tolist() == want[d].tolist(), f"slot {d}"
    # What slot d receives from its peers is what the exchange moves.
    ex = M.all_to_all_exchange(
        mesh, _port_shards(dicts),
        [torch.from_numpy(p.astype(np.int64)) for p in pids])
    assert [len(_rows(b)) for b in ex] == [int(c.sum()) for c in got]


def test_all_gather_batch_matches_reference(mesh):
    dicts = _shard_dicts(5, live=11)
    want = _ref_run(lambda b: JM.all_gather_batch(b, N), N,
                    _ref_shards(dicts, cap=16))
    got = M.all_gather_batch(mesh, _port_shards(dicts, cap=16))
    for d in range(N):
        assert _rows(got[d]) == _ref_rows(want[d]), f"slot {d}"
    assert _rows(got[0]) == [r for d in dicts
                             for r in zip(d["k"], d["v"], d["s"])]


def _kv_shards(n, cap=CAP, live=LIVE, seed=7, port=True):
    rng = np.random.default_rng(seed)
    H = thost if port else jhost
    D = dt if port else jdt
    out = []
    for _ in range(n):
        hb = H.HostBatch.from_pydict(
            [("k", D.INT64), ("v", D.INT64)],
            {"k": rng.integers(0, 37, live).tolist(),
             "v": rng.integers(0, 1000, live).tolist()})
        out.append(H.host_to_device(hb, capacity=cap, device="cpu")
                   if port else H.host_to_device(hb, capacity=cap))
    return out


def _agg(port: bool):
    if port:
        src = InMemorySourceExec((("k", dt.INT64), ("v", dt.INT64)), [[]],
                                 device="cpu")
        return HashAggregateExec(src, [("k", Ref(0, dt.INT64))],
                                 [AggSpec("s", Sum(Ref(1, dt.INT64))),
                                  AggSpec("n", CountStar(None))])
    src = JSource((("k", jdt.INT64), ("v", jdt.INT64)), [[]])
    return JHashAggregateExec(src, [("k", JRef(0, jdt.INT64))],
                              [JAggSpec("s", JSum(JRef(1, jdt.INT64))),
                               JAggSpec("n", JCountStar(None))])


def test_distributed_aggregate_step_matches_reference(mesh):
    jstep = JM.distributed_aggregate_step(
        JM.make_mesh(N), _agg(False), JHash([JRef(0, jdt.INT64)], N))
    jout = jstep(JM.shard_batches(JM.make_mesh(N),
                                  _kv_shards(N, port=False)))
    step = M.distributed_aggregate_step(
        mesh, _agg(True), HashPartitioning([Ref(0, dt.INT64)], N))
    got = step(M.shard_batches(mesh, _kv_shards(N)))
    seen = {}
    for d in range(N):
        want = _ref_rows(jax.tree.map(lambda x: np.asarray(x)[d], jout))
        rows = _rows(got[d])
        assert rows == want, f"slot {d}"
        for k, s, n in rows:
            assert k not in seen, f"group {k} on two slots"
            seen[k] = (s, n)
    assert sum(n for _, n in seen.values()) == N * LIVE


def _ref_join_agg_step(n, join_out_capacity=None):
    src = JSource((("k", jdt.INT64), ("v", jdt.INT64)), [[]])
    join = JJoin(src, src, [JRef(0, jdt.INT64)], [JRef(0, jdt.INT64)],
                 "inner")
    agg = JHashAggregateExec(
        src, [("k", JRef(0, jdt.INT64))],
        [JAggSpec("sv", JSum(JRef(1, jdt.INT64))),
         JAggSpec("sw", JSum(JRef(3, jdt.INT64))),
         JAggSpec("n", JCountStar(None))])
    part = JHash([JRef(0, jdt.INT64)], n)
    return JM.distributed_join_agg_step(
        JM.make_mesh(n), join, agg, part, part, part,
        join_out_capacity=join_out_capacity)


def _port_join_agg_step(mesh, join_out_capacity=None):
    from spark_rapids_tpu_torch.ops.join import ShuffledHashJoinExec
    src = InMemorySourceExec((("k", dt.INT64), ("v", dt.INT64)), [[]],
                             device="cpu")
    join = ShuffledHashJoinExec(src, src, [Ref(0, dt.INT64)],
                                [Ref(0, dt.INT64)], "inner")
    agg = HashAggregateExec(
        src, [("k", Ref(0, dt.INT64))],
        [AggSpec("sv", Sum(Ref(1, dt.INT64))),
         AggSpec("sw", Sum(Ref(3, dt.INT64))),
         AggSpec("n", CountStar(None))])
    part = HashPartitioning([Ref(0, dt.INT64)], mesh.size)
    return M.distributed_join_agg_step(
        mesh, join, agg, part, part, part,
        join_out_capacity=join_out_capacity)


@pytest.mark.parametrize("join_out_capacity", [None, 32])
def test_distributed_join_agg_step_matches_reference(mesh,
                                                     join_out_capacity):
    """The q3-shaped step: both sides exchanged by key, the local join,
    the partial aggregate, the second exchange, the final aggregate. At
    a pair buffer of 32 the join overflows on the same slots as the
    reference's devices."""
    live, cap = 12, 16
    jl = _kv_shards(N, cap, live, seed=11, port=False)
    jr = _kv_shards(N, cap, live, seed=12, port=False)
    jmesh = JM.make_mesh(N)
    jout, jover = _ref_join_agg_step(N, join_out_capacity)(
        JM.shard_batches(jmesh, jl), JM.shard_batches(jmesh, jr))
    jover = np.asarray(jover).reshape(-1).tolist()
    step = _port_join_agg_step(mesh, join_out_capacity)
    outs, over = step(M.shard_batches(mesh, _kv_shards(N, cap, live, 11)),
                      M.shard_batches(mesh, _kv_shards(N, cap, live, 12)))
    assert [bool(o) for o in over] == jover
    if join_out_capacity is None:
        assert not any(jover)
    else:
        assert any(jover)
    for d in range(N):
        want = _ref_rows(jax.tree.map(lambda x: np.asarray(x)[d], jout))
        assert _rows(outs[d]) == want, f"slot {d}"


def test_dryrun_multichip_gloo_ranks_match_reference():
    """Four gloo ranks, one process each, against the reference's
    4-device mesh on the dry run's shards (seeds d and 100 + d)."""
    n = 4
    per_rank = E.dryrun_multichip(n, device="cpu", timeout_s=240.0)
    assert len(per_rank) == n

    def shard(seed):
        r = np.random.default_rng(seed)
        hb = jhost.HostBatch.from_pydict(
            [("k", jdt.INT64), ("v", jdt.INT64)],
            {"k": r.integers(0, 7, E.DRYRUN_ROWS).tolist(),
             "v": r.integers(0, 100, E.DRYRUN_ROWS).tolist()})
        return jhost.host_to_device(hb, capacity=E.DRYRUN_ROWS)

    jmesh = JM.make_mesh(n)
    out, over = _ref_join_agg_step(n)(
        JM.shard_batches(jmesh, [shard(d) for d in range(n)]),
        JM.shard_batches(jmesh, [shard(100 + d) for d in range(n)]))
    assert not np.asarray(over).any()
    for d in range(n):
        want = _ref_rows(jax.tree.map(lambda x: np.asarray(x)[d], out))
        assert [tuple(r) for r in per_rank[d]] == want, f"rank {d}"
    assert sum(len(r) for r in per_rank) > 0


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def test_process_group_mesh_matches_local_group(tmp_path):
    """Counts then data over gloo, one rank a process, against the local
    group that the tests above hold to the reference."""
    sys.path.insert(0, FIXTURES)
    try:
        import torch_mesh_rank as R
    finally:
        sys.path.remove(FIXTURES)
    n = 3
    local = M.make_mesh(n, device="cpu")
    shards = [R.shard(r) for r in range(n)]
    want = R.rank_rows(local, [b for b, _ in shards],
                       [p for _, p in shards])
    mp = multiprocessing.get_context("spawn")
    results = mp.Queue()
    init = "file://" + str(tmp_path / "pg")
    sys.path.insert(0, FIXTURES)    # the children import the fixture
    try:
        procs = [mp.Process(target=R.run_rank,
                            args=(r, n, init, results)) for r in range(n)]
        for p in procs:
            p.start()
    finally:
        sys.path.remove(FIXTURES)
    try:
        got = {}
        for _ in range(n):
            rank, rows, err = results.get(timeout=120)
            assert err is None, f"rank {rank}:\n{err}"
            got[rank] = rows
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    for r in range(n):
        for key in want:
            assert got[r][key] == [want[key][r]], (r, key)
