"""Walls of TPC-H q1, q3, q4 and q2 at SF1 on the card, by wire codec,
for the port in any source tree.

    python3 spark_rapids_tpu_torch/wall_compare.py [--tree DIR]
        [--codecs v2,plain] [--runs 3] [--label NAME]

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(HERE))
    ap.add_argument("--codecs", default="v2,plain")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--label", default="")
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
