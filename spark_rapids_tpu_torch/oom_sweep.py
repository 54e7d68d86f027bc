"""TPC-H q18 at SF1 under a capped caching allocator, share by share, with
the port's two OOM degradations on and off, on the card.

    python3 -m spark_rapids_tpu_torch.oom_sweep [--partitions 1,8]
        [--shares 0.9,0.8,...] [--out oom_sweep.json]

For each partition count: one uncapped collect gives the rows and the
memory the caching allocator reserved above its start (the span), as
``chip_smoke.py`` phase 18 (e) measures it. Then, for each share from the
highest, two capped collects in turns (degradations on, off; the order
alternates share by share): the allocator may reserve what it holds
after ``empty_cache`` plus that share of the span
(``torch.cuda.set_per_process_memory_fraction``). "Off" replaces the
``split_on_oom`` of ``ops/join.py``, ``ops/aggregate.py`` and
``parallel/exchange.py`` with a single call of the step, makes the
exchange's map side re-raise an unmet OOM instead of going batch by
batch, and makes ``parallel/pipeline.py`` re-raise a stage wave's OOM,
as all did before the degradations existed. Each run reports its outcome (``ok``
with rows equal to the uncapped run's, bit for bit, or the error's type
and the frames that raised it), the last ladder's rungs,
``splitRetries``, ``serialStageRetries``, ``retriesAttempted`` and its
wall. One JSON object a run on stdout and in ``--out``; the card's name
and power limit first. Needs a card; builds the kernels first.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import traceback


def _settle(torch) -> int:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def _where(e: BaseException) -> str:
    tb = traceback.extract_tb(e.__traceback__)
    return " <- ".join(f"{os.path.basename(f.filename)}:{f.lineno}:{f.name}"
                       for f in reversed(tb[-10:]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--partitions", default="1,8")
    ap.add_argument("--shares", default="0.9,0.8,0.7,0.6,0.5,0.4,0.3,0.2")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("oom_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.memory import oom
    from spark_rapids_tpu_torch.ops import aggregate, cuda_build, join
    from spark_rapids_tpu_torch.ops.base import ExecContext
    from spark_rapids_tpu_torch.parallel import exchange, pipeline
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    cuda_build.build_all(["radix_rank", "join_probe", "seg_scan",
                          "rle_decode"])
    cols = entry.tpch_columns(args.scale)
    total = torch.cuda.get_device_properties(0).total_memory
    split_on, oom_only = join.split_on_oom, pipeline._oom_only
    unmet = exchange.is_unmet_oom

    def split_off(step, batch, offset=0):
        yield step(batch, offset)

    def degrade(on: bool) -> None:
        for mod in (join, aggregate, exchange):
            mod.split_on_oom = split_on if on else split_off
        exchange.is_unmet_oom = unmet if on else (lambda e: False)
        pipeline._oom_only = oom_only if on else (lambda errors: False)

    results = []
    for n in (int(x) for x in args.partitions.split(",")):
        s = TpuSession({"spark.rapids.sql.variableFloatAgg.enabled": True,
                        "spark.rapids.sql.shuffle.partitions": n})
        phys = tpch.QUERIES["q18"](s, tpch.tpch_tables(
            s, cols, ("q18",))["q18"])._physical()
        base = _settle(torch)
        torch.cuda.reset_peak_memory_stats()
        want = phys.collect()
        torch.cuda.synchronize()
        span = torch.cuda.max_memory_reserved() - base
        for i, share in enumerate(float(x) for x in args.shares.split(",")):
            for on in ((True, False) if i % 2 == 0 else (False, True)):
                limit = _settle(torch) + int(share * span)
                oom.last_ladder[:] = []
                degrade(on)
                ctx = ExecContext(phys.conf)
                r = dict(partitions=n, share=share, degrade=on,
                         span_bytes=span, limit_bytes=limit)
                torch.cuda.set_per_process_memory_fraction(limit / total)
                t0 = time.perf_counter()
                try:
                    rows = phys.collect(ctx)
                    torch.cuda.synchronize()
                    r["outcome"] = "ok" if rows == want else "rows differ"
                except Exception as e:  # noqa: BLE001 - reported per run
                    r["outcome"] = type(e).__name__
                    r["where"] = _where(e)
                finally:
                    torch.cuda.set_per_process_memory_fraction(1.0)
                    degrade(True)
                r["wall_s"] = time.perf_counter() - t0
                rec = ctx.metrics.get("Recovery@query")
                rec = dict(rec.values) if rec is not None else {}
                pm = ctx.metrics.get("Pipeline@query")
                pm = dict(pm.values) if pm is not None else {}
                r.update(ladder=list(oom.last_ladder),
                         splitRetries=rec.get("splitRetries", 0),
                         serialStageRetries=pm.get("serialStageRetries", 0),
                         retriesAttempted=rec.get("retriesAttempted", 0),
                         leaks=len(ctx.last_leak_report or []))
                print(json.dumps(r), flush=True)
                results.append(r)
                oom.reset_degradation()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "runs": results}, f, indent=1)
    print(f"nvidia-smi: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
