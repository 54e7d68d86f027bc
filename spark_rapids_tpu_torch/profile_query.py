"""Where the time of a TPC-H or suite query goes on the card.

    python3 -m spark_rapids_tpu_torch.profile_query [--query q1|q2|...]
        [--codec v2|v1|plain] [--scale 1.0] [--partitions 8]
        [--dataframe] [--trace q1_trace.json]

Runs ``tpch_q1_plan`` (or ``tpch_q2_plan`` / ``tpch_q3_plan`` /
``tpch_q4_plan``, over the generator's partitions) ``.collect()``, or with
``--dataframe`` the exec tree the planner builds from ``benchmarks/tpch.py``
(q1-q10, q12-q14, q16-q19, q21, ``variableFloatAgg`` on, over
``tpch_tables``) or ``benchmarks/suites.py`` (xbb_q5, xbb_q12, q67, ds_q3,
ds_q42, ds_q55, ds_q89 and ds_q98 over ``suite_tables``), on the
CUDA card under the wire codec ``--codec`` (default v2): one warm-up run
(the sources pack their batches there and keep them), then host-clock
times of the upload alone (split into a fresh host encode + pack of every
scan batch, and the host->device copies + device decode), and of whole
warm runs, then one run under ``torch.profiler`` (CPU + CUDA activity).
Prints the
host time per operator (the plan's own ``timed`` metrics), the top ops by
self device time and by self host time, and the device busy share (sum
of kernel time over the profiled wall time). ``--partitions`` applies to
the hand-built q1. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time


HAND_BUILT = ("q1", "q2", "q3", "q4")


def _dev_time(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.benchmarks import suites, tpch
    from spark_rapids_tpu_torch.columnar import wire
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.ops import ExecContext, native

    dataframe_only = tuple(q for q in (*tpch.QUERIES, *suites.QUERIES)
                           if q not in HAND_BUILT)
    ap = argparse.ArgumentParser()
    ap.add_argument("--query", choices=HAND_BUILT + dataframe_only,
                    default="q1")
    ap.add_argument("--codec", choices=wire.CODEC_MODES, default="v2")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--partitions", type=int, default=8)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--dataframe", action="store_true")
    ap.add_argument("--trace", default="")
    args = ap.parse_args()
    if args.query in dataframe_only and not args.dataframe:
        ap.error(f"{args.query} has no hand-built tree: add --dataframe")
    if not torch.cuda.is_available():
        raise RuntimeError("profile_query needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    if args.dataframe:
        from spark_rapids_tpu_torch.api import TpuSession
        from spark_rapids_tpu_torch.plan import logical as L
        session = TpuSession({"spark.rapids.sql.variableFloatAgg.enabled":
                              True})
        if args.query in suites.QUERIES:
            dfs = suites.suite_tables(session, suites.suite_columns(
                args.scale), (args.query,))[args.query]
            query = suites.QUERIES[args.query]
        else:
            cols = entry.tpch_columns(args.scale, seed=0)
            dfs = tpch.tpch_tables(session, cols, (args.query,))[args.query]
            query = tpch.QUERIES[args.query]
        tables = {t: df._plan.partitions for t, df in dfs.items()
                  if isinstance(df._plan, L.InMemoryScan)}
        phys = query(session, dfs)._physical()
        print(phys.tree())
        plan = phys.root
    elif args.query == "q1":
        tables = {"lineitem": entry.tpch_q1_host_batches(
            args.scale, args.partitions, seed=0)}
        plan = entry.tpch_q1_plan(tables["lineitem"], device="cuda")
    else:
        cols = entry.tpch_columns(args.scale, seed=0)
        tables = getattr(entry, f"tpch_{args.query}_tables")(cols)
        plan = getattr(entry, f"tpch_{args.query}_plan")(tables,
                                                          device="cuda")
    batches = [hb for parts in tables.values() for p in parts for hb in p]
    n_rows = sum(hb.num_rows for hb in batches)
    conf = TpuConf({"spark.rapids.sql.wire.codec": args.codec})
    plan.collect(ExecContext(conf))                  # warm-up (builds)
    torch.cuda.synchronize()

    wire.reset_counters()
    t0 = time.perf_counter()
    encs = [wire.pack_batch(hb) for hb in batches]
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for enc in encs:
        wire.upload_packed(enc, device="cuda")
    torch.cuda.synchronize()
    put_s = time.perf_counter() - t0
    codec = wire.counters()

    walls = []
    ctx = None
    for _ in range(args.runs):
        ctx = ExecContext(conf)
        t0 = time.perf_counter()
        plan.collect(ctx)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"{args.query} scale={args.scale} input rows={n_rows} codec="
          f"{args.codec}: warm wall s {walls}; upload alone "
          f"{pack_s + put_s:.4f} s = host encode + pack {pack_s:.4f} s + "
          f"copy + decode {put_s:.4f} s; staging "
          f"{int(codec.get('stagingBytes', 0))} B (raw "
          f"{int(codec.get('rawBytes', 0))} B)")
    print("host time per operator (last warm run, ms):")
    for key, m in ctx.metrics.items():
        vals = {k: round(v / 1e6, 3) for k, v in m.values.items()
                if k.endswith("Time")}
        print(f"  {m.owner}: {vals}")

    if args.query == "q1":
        # The group-sum scan's layout, both ways in this one call: (cap, k)
        # scanned over dim 0 (the outer dimension) vs (k, cap) over dim 1.
        cap, k = 786_432, 8
        m = torch.rand((cap, k), dtype=torch.float64, device="cuda")
        mt = m.T.contiguous()
        for label, fn in (("outer dim of (cap, k)", lambda: m.cumsum(0)),
                          ("inner dim of (k, cap)", lambda: mt.cumsum(1))):
            fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                fn()
            end.record()
            end.synchronize()
            print(f"f64 cumsum over the {label}, cap={cap} k={k}: "
                  f"{start.elapsed_time(end) / 5:.4f} ms")

    native.reset_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        plan.collect(ExecContext(conf))
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernel_us = sum(_dev_time(e) for e in events
                    if getattr(e, "device_type", None) is not None
                    and "CUDA" in str(e.device_type))
    print(f"profiled run: wall {prof_wall:.4f} s; device kernel time "
          f"{kernel_us / 1e3:.3f} ms; device busy share "
          f"{kernel_us / 1e6 / prof_wall:.4f}; kernel launches "
          f"{native.counters()}")
    print("top ops by self device time:")
    print(events.table(sort_by="self_cuda_time_total", row_limit=15,
                       max_name_column_width=60))
    print("top ops by self host time:")
    print(events.table(sort_by="self_cpu_time_total", row_limit=20,
                       max_name_column_width=60))
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps({"query": args.query, "dataframe": args.dataframe,
                      "codec": args.codec,
                      "rows": n_rows, "warm_wall_s": walls,
                      "upload_s": pack_s + put_s, "encode_pack_s": pack_s,
                      "copy_decode_s": put_s,
                      "staging_bytes": codec.get("stagingBytes", 0),
                      "raw_bytes": codec.get("rawBytes", 0),
                      "profiled_wall_s": prof_wall,
                      "device_kernel_ms": kernel_us / 1e3}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
