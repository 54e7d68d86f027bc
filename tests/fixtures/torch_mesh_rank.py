"""Rank half of the port's process-group mesh test.

``run_rank`` is a ``multiprocessing`` (``spawn``) target: it joins a gloo
group of ``n`` ranks through a ``file://`` init, makes its shard of a
three-column table (a string column included) from its rank, and runs
``exchange_counts``, ``all_to_all_exchange`` (worst-case and truncated
piece capacity) and ``all_gather_batch`` over
``parallel/mesh.py``'s ``ProcessGroupMesh``. It puts its rows (or the
error) on ``results``; the parent holds them to a ``LocalGroup`` of
``n`` slots on the same shards.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

CAP, LIVE = 32, 27


def shard(rank: int):
    """Rank ``rank``'s shard and partition ids (a pure function of the
    rank: the parent makes the same ones)."""
    import torch

    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.host import (HostBatch,
                                                      host_to_device)
    rng = np.random.default_rng(40 + rank)
    # Ranks' strings differ in width: the exchange pads to a common one.
    width = 3 + 4 * rank
    hb = HostBatch.from_pydict(
        (("k", dt.INT64), ("v", dt.INT32), ("s", dt.STRING)),
        {"k": rng.integers(0, 50, LIVE).tolist(),
         "v": rng.integers(-9, 9, LIVE).tolist(),
         "s": ["x" * int(i) for i in rng.integers(0, width, LIVE)]})
    batch = host_to_device(hb, capacity=CAP, device="cpu")
    pids = torch.from_numpy(rng.integers(0, 3, CAP).astype(np.int64))
    return batch, pids


def rank_rows(mesh, batches, pids):
    """What this process's slots hold after each collective, as rows."""
    from spark_rapids_tpu_torch.columnar.host import device_to_host
    from spark_rapids_tpu_torch.parallel import mesh as M

    def rows(bs):
        return [device_to_host(b).to_pylist() for b in bs]

    return {"counts": [c.tolist() for c in
                       M.exchange_counts(mesh, batches, pids)],
            "a2a": rows(M.all_to_all_exchange(mesh, batches, pids)),
            "a2a4": rows(M.all_to_all_exchange(mesh, batches, pids,
                                               piece_capacity=4)),
            "gather": rows(M.all_gather_batch(mesh, batches))}


def run_rank(rank: int, n: int, init: str, results) -> None:
    import traceback
    try:
        import torch
        import torch.distributed as dist

        from spark_rapids_tpu_torch.parallel import mesh as M
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, world_size=n,
                                rank=rank)
        try:
            mesh = M.make_process_mesh("cpu")
            batch, pids = shard(rank)
            results.put((rank, rank_rows(mesh, [batch], [pids]), None))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, None, traceback.format_exc()))
