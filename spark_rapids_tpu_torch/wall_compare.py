"""Walls of TPC-H q1, q3, q4 and q2 at SF1 on the card, by wire codec,
for the port in any source tree.

    python3 spark_rapids_tpu_torch/wall_compare.py [--tree DIR]
        [--codecs v2,plain] [--runs 3] [--label NAME] [--kernels]

Run it by its path, not with ``-m``: it imports ``spark_rapids_tpu_torch``
from ``--tree`` (the root of a checkout; default the checkout holding this
file), so an older commit unpacked beside this one is measured by the same
code. It builds the tree's kernels (every ``csrc/*.cu``) first. For each
query: one first collect under each codec in turn (a tree with the wire
codec encodes and packs its scans there), then ``--runs`` rounds of one
warm collect under each codec in turn. Host-clock seconds, each collect
ended by a device sync; the rows of every codec's first collect must be
equal. A tree without the codec ignores the conf key and uploads its own
way. Prints one JSON line per query, then the card's name and power limit.

With ``--kernels`` it times K1 and K2 instead, through the functions the
operators call, so any tree is measured alike: ``stable_argsort_u32`` of
786,432 random u32 keys (a q1 partition's capacity) and
``segment_minmax_sorted`` min of 131,072 int64 values over nondecreasing
ids into 131,072 slots (q2's largest K2 launch). ``--runs`` rounds of
CUDA-event means over 200 back-to-back calls each; one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
QUERIES = ("q1", "q3", "q4", "q2")


def _import_tree(tree: str):
    """``spark_rapids_tpu_torch`` of ``tree``, with this file's own
    directory off the import path."""
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, tree)
    import spark_rapids_tpu_torch as pkg
    where = os.path.dirname(os.path.abspath(pkg.__file__))
    if where != os.path.join(tree, "spark_rapids_tpu_torch"):
        raise RuntimeError(f"imported the package from {where}, not from "
                           f"{tree}; run this file by its path")
    return pkg


def _source_times(ctx) -> dict:
    """Host seconds of the sources' timed metrics in one collect."""
    out = {}
    for m in ctx.metrics.values():
        if m.owner == "InMemorySourceExec":
            for k, v in m.values.items():
                if k.endswith("Time"):
                    out[k] = out.get(k, 0.0) + v / 1e9
    return out


def _kernel_times(label: str, runs: int) -> None:
    import numpy as np
    import torch
    from spark_rapids_tpu_torch.ops import native
    rng = np.random.default_rng(0)
    keys = torch.from_numpy(rng.integers(0, 2 ** 32, 786_432,
                                         dtype=np.int64)).cuda()
    cap = 131_072
    gid = torch.from_numpy(np.sort(rng.integers(0, cap * 3 // 4, cap))).cuda()
    vals = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, cap,
                                         dtype=np.int64)).cuda()
    order = native.stable_argsort_u32(keys)
    if not torch.equal(order.long(), torch.sort(keys, stable=True).indices):
        raise AssertionError(f"{label}: K1 differs from torch.sort")
    want = torch.full((cap,), 2 ** 63 - 1, dtype=torch.int64,
                      device="cuda").scatter_reduce_(0, gid, vals, "amin")
    if not torch.equal(native.segment_minmax_sorted(vals, gid, cap, "min"),
                       want):
        raise AssertionError(f"{label}: K2 differs from scatter_reduce_")
    calls = {"radix_sort_786432_ms": lambda: native.stable_argsort_u32(keys),
             "segment_min_131072_ms": lambda: native.segment_minmax_sorted(
                 vals, gid, cap, "min")}
    out = {name: [] for name in calls}
    for _ in range(runs):
        for name, fn in calls.items():
            for _w in range(5):
                fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _i in range(200):
                fn()
            end.record()
            end.synchronize()
            out[name].append(start.elapsed_time(end) / 200)
    print(json.dumps({"tree": label, "kernels": out}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(HERE))
    ap.add_argument("--codecs", default="v2,plain")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--label", default="")
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    _import_tree(tree)

    import torch
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.ops import ExecContext, cuda_build
    if not torch.cuda.is_available():
        raise RuntimeError("wall_compare needs a CUDA device")
    label = args.label or tree
    codecs = args.codecs.split(",")
    csrc = os.path.join(tree, "spark_rapids_tpu_torch", "csrc")
    t0 = time.perf_counter()
    cuda_build.build_all(sorted(f[:-3] for f in os.listdir(csrc)
                                if f.endswith(".cu")))
    build_s = time.perf_counter() - t0
    if args.kernels:
        print(f"{label}: kernels built in {build_s:.2f} s", flush=True)
        _kernel_times(label, args.runs)
        _print_device()
        return 0

    t0 = time.perf_counter()
    cols = entry.tpch_columns(1.0, seed=0)
    plans = {"q1": entry.tpch_q1_plan(
        entry.tpch_q1_host_batches(1.0, partitions=8, seed=0),
        device="cuda")}
    for q in QUERIES[1:]:
        plans[q] = getattr(entry, f"tpch_{q}_plan")(
            getattr(entry, f"tpch_{q}_tables")(cols), device="cuda")
    gen_s = time.perf_counter() - t0
    print(f"{label}: kernels built in {build_s:.2f} s, SF1 data and plans "
          f"in {gen_s:.2f} s", flush=True)

    def run(plan, codec):
        ctx = ExecContext(TpuConf({"spark.rapids.sql.wire.codec": codec}))
        t0 = time.perf_counter()
        rows = plan.collect(ctx)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, rows, _source_times(ctx)

    for q, plan in plans.items():
        first, warm, source = {}, {c: [] for c in codecs}, {}
        want = None
        for c in codecs:
            first[c], rows, _ = run(plan, c)
            if want is None:
                want = rows
            elif rows != want:
                raise AssertionError(f"{q}: rows under {c} differ from "
                                     f"{codecs[0]}")
        for _ in range(args.runs):
            for c in codecs:
                wall, _rows, source[c] = run(plan, c)
                warm[c].append(wall)
        print(json.dumps({"tree": label, "query": q, "first_s": first,
                          "warm_s": warm, "last_warm_source_s": source}),
              flush=True)
    _print_device()
    return 0


def _print_device() -> None:
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")


if __name__ == "__main__":
    raise SystemExit(main())
