#!/usr/bin/env python3
"""On-card smoke run of spark_rapids_tpu_torch, the PyTorch + CUDA port.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero):

1. Device: the card's name, and its name and power limit as nvidia-smi
   reports them.
2. Build: the hand-written kernels compile from ``csrc/`` into the
   package's ignored ``build/`` directory (one nvcc per source, all
   started together): ``radix_rank.cu`` (K1), ``join_probe.cu`` (K3),
   ``seg_scan.cu`` (K2) and ``rle_decode.cu`` (K4).
3. Kernel: ``stable_argsort_u32`` (kernel K1, one C call a sort) on
   random, duplicate-heavy and 0/1 (three digits of one bucket) u32 keys,
   and on random keys through a row permutation, at capacities 512,
   786 432 and 4 194 304 must equal its plain-PyTorch version and
   ``torch.sort(stable=True)`` (gather, sort, gather with the
   permutation) bit for bit; kernel, plain and torch.sort times (CUDA
   events) beside the function's byte bound and the passes' byte bound.
   The profiler's device time of one 786 432-row sort is printed beside
   its CUDA-event time.
4. Path: TPC-H Q1 at scale factor 1 (8 partitions, seed 0) through
   ``tpch_q1_plan(...).collect()`` on the card, checked against a numpy
   oracle in this file (group keys and counts exact, sums and averages to
   rtol 1e-9); K1's launch counter must rise during the run.
5. Kernel: ``searchsorted_u64_pair`` (kernel K3) must equal its plain
   version bit for bit on edge cases (empty, 1- and 3-entry and
   all-sentinel builds, a run of equal keys longer than a pivot spacing,
   at every lane count the wrapper takes: 32, 16, 8 and 1), then on
   full-range u64 fingerprints with runs and a sentinel tail at (build x
   probe) 512 x 512 (32 lanes), 3 145 728 x 6 000 / 12 000 / 20 000 /
   150 000 (16, 8, 1 and 1 lanes) and 4 194 304 x 4 194 304 (1 lane, with
   its profiled device time);
   kernel and two-``torch.searchsorted`` times in turns (medians of 5),
   the plain version's time and the bound, with the lane count and
   search steps of each launch.
6. Paths: TPC-H Q3 and Q4 at scale factor 1 (seed 0; ORDERS and LINEITEM
   in 8 partitions, CUSTOMER in 4) through ``tpch_q3_plan`` /
   ``tpch_q4_plan``, checked against numpy oracles in this file (keys,
   counts and the top-10 order exact, revenue to rtol 1e-9). K3 must
   launch during Q4 (its semi join probes a build with runs of 7); Q3's
   joins take the dense table and its K3 launches are printed (0
   expected). K3 is then checked and timed again on the exact
   fingerprints of Q4's first probe, warm, by its profiled device time,
   and with a cold L2 (64 MiB written before each call, per-call CUDA
   events).
7. Kernel: ``seg_reduce`` (kernel K2, the per-group function in one C
   call) for every kind (sum, min and max over u32 and over u64 keys) at
   512, 786 432 and 4 194 304 rows, in segments of 1-64 rows and segments
   spanning many tiles, must equal its plain version (running scan +
   finish) bit for bit, 20 launches in a row at the largest size, also
   with the whole column one segment and with a capacity below the
   largest id; and one ``scatter_reduce_`` into an identity-filled output
   bit for bit. Times of K2, the plain version and the scatter_reduce
   beside the byte bound.
8. Path: TPC-H Q2 at scale factor 1 (PART and PARTSUPP in 4 partitions,
   SUPPLIER, NATION and REGION in 1) through ``tpch_q2_plan``, checked
   against a numpy oracle in this file: rows and their order exact. K2
   must launch during Q2 (its min aggregate) and K3 (the fast probe path);
   K1's launches and K2's and K3's shapes are printed. K2 is then checked
   (20 launches), timed and profiled again on Q2's largest launch, and K3
   on Q2's first probe.
9. Kernel: ``rle_decode`` (kernel K4, the wire codec's RLE expansion) at
   capacities 512, 786 432 and 4 194 304 for int8, int16, int32, int64,
   float32 and float64 run tables (-0.0 and NaN-payload runs among the
   values) with 1, 8, 2 048, 2 049, 4 096 and rows/4 runs and
   ``num_rows < cap``, full tables included, and a table of one run per
   row, must equal its plain version bit for bit; kernel and one
   ``torch.repeat_interleave`` times in turns (medians of 5), the plain
   version's time and the byte bound, and at 4 194 304 rows with rows/4
   runs the kernel's profiled device time. A table of at
   most ``native.RLE_SMEM_RUNS`` entries is staged whole by every block,
   a larger one is cut into block windows by searches; each log line
   names which.
10. Codec: the walls of q1, q3, q4 and q2 under the default ``v2`` wire
   codec and under ``plain`` (``ExecContext(conf)``): plain's first run
   (the sources pack their batches once per codec and keep them), then
   warm runs in turns (v2, plain, plain, v2), and the host encode time
   of one q1 partition split by column (its pack must equal the one q1's
   source kept). Each path above prints, for its first run, its
   ``codecCols.*`` counts and its encoded vs raw bytes; q3 must launch K4
   (its ``o_shippriority``
   ships as a run table: 8 launches expected), and K4 is checked and
   timed again on the exact inputs of q3's first launch.
11. DataFrame: TPC-H q1-q6 through ``TpuSession`` (``variableFloatAgg``
   on) and the port's ``benchmarks/tpch.py``, the reference's query text,
   over in-memory scans of the same SF1 columns: each query's planning
   time (host ms) and exec tree, its first run (launch counters around it
   alone) and warm runs, every run checked against its numpy oracle (q5
   and q6 have theirs here); q1-q4's rows must equal the hand-built
   trees' (floats to rtol 1e-9) in this process. K1 must launch in every
   query but q6, K2 in q2, K3 in q4 and q2, K4 in q3. The inputs of
   every K2, K3 and K4 launch of each first run are recorded; each launch
   of a shape no hand-built path gave (q4's one probe of its whole
   coalesced ORDERS side) must equal the kernel's plain version bit for
   bit, and the largest such launch of a query is timed against its
   plain version and library call, with its device time.
12. Default conf: q1-q6 through ``TpuSession()`` with no conf, whose
   float Sum/Avg aggregates the planner places on the host engine (numpy)
   between device subtrees, bridged by ``DeviceToHostExec`` and
   ``HostToDeviceExec``. Each query's host-tagged nodes must be the
   Aggregate in q1, q3, q5 and q6 and none in q2 and q4; its bridges and
   the rows and bytes each download moves are printed. Its first run
   (counters around it alone, every K1-K4 launch recorded) must match the
   numpy oracle and launch K1 in q1, q3, q5, q2 and q4, K2 in q2, K3 in
   q2 and q4, K4 in q3; each launch of a shape no earlier phase checked
   must equal the kernel's plain version bit for bit. Warm walls in turns
   beside the same query with ``variableFloatAgg`` on (phase 11's
   all-device tree), each run checked, with the host engine's share of
   each default-conf wall (host clock inside the host subtrees less the
   device subtrees and downloads below them).
13. Conditionals, IN lists, Divide and date parts: TPCxBB q5 (scale 1:
   4,000,000 clickstream rows, 100,000 customers, 20,000 demographics,
   18,000 items; the reference generator's stream replayed by
   ``benchmarks/suites.py``) and TPC-H q7, q8, q9, q12, q14 and q19
   (SF1) through ``TpuSession`` and the
   reference's query text, each once with ``variableFloatAgg`` on (every
   node on the card) and once under the default conf (the float Sum
   aggregates of q7, q8, q9, q14 and q19 on the host engine; q12's and
   xbb_q5's integer sums on the card). For each run: the plan's host
   nodes and bridges (checked), the rows and bytes each
   ``DeviceToHostExec`` downloads, the first run (counters around it
   alone, every K1-K4 launch recorded) and two warm runs, each checked
   against a numpy oracle in this file (keys, counts and order exact,
   floats to rtol 1e-9; xbb_q5 as a multiset, the query has no order).
   K1 must launch in xbb_q5, q7, q8, q9 and q12 under both confs. Each
   K1-K4 launch of a shape no earlier phase checked must equal the
   kernel's plain version bit for bit. The phase's time is printed.
14. Grouping sets and windows: TPC-DS q67, ds_q3, ds_q42, ds_q55, ds_q89
   and ds_q98 (scale 1: 2,880,000 store_sales rows, 18,000 items, 12
   stores, 731 dates; the reference generator's stream replayed by
   ``benchmarks/suites.py``) through ``TpuSession`` and the reference's
   query text, once with ``variableFloatAgg`` on and once under the
   default conf (each float Sum aggregate on the host engine, q67's
   ROLLUP ``ExpandExec`` with it; the windows and sorts on the card).
   For each run: host nodes and bridges (checked), rows and bytes
   downloaded, the first run (counters around it alone, every K1-K4
   launch recorded) and warm runs (one for q67 under the default conf,
   two for the rest), each checked against a numpy oracle in this file
   (q67, ds_q3, ds_q42 and ds_q55 exactly, their sums being of whole
   numbers; ds_q89's averages and ds_q98's ratios to rtol 1e-9), and the
   peak device memory of the warm runs. K1 must launch in every run, K2
   in ds_q89 and ds_q98 (the window's valid-row counts). Each K1-K4 launch
   of a shape no earlier phase checked must equal the kernel's plain
   version bit for bit; the largest new K1 shape is timed against its
   plain version and ``torch.sort``. The phase's time is printed.
15. COUNT DISTINCT and LIKE: TPCxBB xbb_q12 (scale 1: distinct
   non-NULL users per category over the 4,000,000 clickstream rows) and
   TPC-H q10, q13, q16, q17, q18 and q21 (SF1) through ``TpuSession`` and
   the reference's query text, once with ``variableFloatAgg`` on and once
   under the default conf (the float Sum/Avg aggregates of q10, q17 and
   q18 on the host engine; COUNT, COUNT DISTINCT and the joins on the
   card). For each run: host nodes and bridges (checked), rows and bytes
   downloaded, the first run (counters around it alone, every K1-K4
   launch recorded) and two warm runs, each checked against a numpy
   oracle in this file (keys, counts and order exact, floats to rtol
   1e-9; q10 as a set, as the reference compares it; the LIKE patterns
   of q13 and q16 evaluated by Python's ``re`` over the comment pools),
   and the peak device memory of the warm runs. K1 must launch in every
   run but q17 under the default conf, K3 in q13's left join and q21's
   self-joins, whose builds repeat keys. Each K1-K4 launch of a shape no
   earlier phase checked must equal the kernel's plain version bit for
   bit. The phase's time is printed.
16. The exchange: (a) ``repart`` (scale 1: all 4,000,000 clickstream
   rows through a 16-way hash exchange, then counted per bucket) under
   both confs, its bucket counts against a numpy murmur3 oracle in this
   file (they must sum to 4,000,000), and the repartition's
   ``ShuffleExchangeExec`` run alone: every row of output partition p
   must hash to p; (b) TPC-H q11, q15, q20 and q22 (SF1: cross joins for
   the scalar subqueries, a fixed-width cast, ``substr``) under both
   confs against numpy oracles (q11 as a set); (c) with
   ``spark.rapids.sql.shuffle.partitions=8``: q1 (hash and range
   exchanges), q4 (a shuffled semi join), q13 (a shuffled left join),
   q18, q21 (shuffled semi and anti joins with a residual), xbb_q12 (the
   distinct pipeline) and ds_q89 (a partitioned window), each against its
   oracle and its own one-partition run in this process (floats to rtol
   1e-9); (d) a full outer join of CUSTOMER (c_acctbal > 0) and ORDERS on
   the customer key at 1 and 8 partitions, its matched, left-only and
   right-only row counts against numpy. For each run: host nodes and
   bridges, rows downloaded, the first run (counters around it alone,
   every K1-K4 launch recorded), two warm walls and the peak device
   memory of the warm runs. K1 must launch in every run, K3 in the
   shuffled joins of (c) (q4, q13, q21) and (d), whose builds repeat keys,
   K2 in ds_q89. Each K1-K4 launch of a shape no earlier phase checked
   must equal the kernel's plain version bit for bit; the largest new
   K3 shape of each run is timed against two ``torch.searchsorted``
   calls, with its bound. The phase's time is printed.
18. The memory tier and out-of-core execution (runs after phase 16),
   each run under ``variableFloatAgg`` once in core and once under a
   ``spark.rapids.memory.tpu.budgetBytes`` chosen, and printed, so its
   mechanism engages: (a) every LINEITEM row (SF1: 5,997,887, with its
   ``l_linenumber``) ordered by supplier, part, order and line under
   128 MiB with a 160 MiB host tier (at least four range buckets, entries
   on disk through the native LZ4 codec), downloaded as numpy and held
   to ``np.lexsort`` bit for bit; (b) q67 under its window's in-core
   staged bytes (the window range-splits on ``i_category``), its rows
   equal to the in-core run's; (c) q21 and q4 at one partition under a
   third of their smallest LINEITEM build (grace joins of at least two
   buckets, K3 at least once per non-empty build bucket), against their
   numpy oracles; (d) q18 at 8 partitions under a quarter of the
   catalog's in-core high-water mark and a host tier of an eighth
   (exchange pieces spill device -> host -> disk), equal to its
   one-partition run; (e) q18 at one partition with the caching
   allocator capped (``torch.cuda.set_per_process_memory_fraction``) at
   a share of its in-core peak: a real ``torch.OutOfMemoryError`` inside
   a retry site must be recovered on the card by the ladder (the rungs
   printed), rows equal, the fraction restored. For each run: rows
   checked, first and two warm walls beside the in-core run's, the peak
   device memory of the warm runs beside the in-core peak,
   ``outOfCoreBuckets``, ``graceJoinPartitions``, the catalog's spill
   and restore counts and LZ4 bytes, the ladder, and K1-K4 launches;
   every K1-K4 launch of a shape no earlier phase checked must equal the
   plain version bit for bit. Every run's leak report must be empty and
   no run of phases 4-18 may fall back to the host engine. The phase's
   time is printed.
19. The numeric, date-time and row-source surface (runs after phase 18),
   through ``TpuSession`` and ``benchmarks/rowsource.py``, each run once
   under ``variableFloatAgg`` + ``improvedFloatOps`` (every node on the
   card) and once under the default conf: (a) ``session.range(0, 2^26,
   num_partitions=8)`` (16 batches of 4,194,304 built on the card) with
   ``rand(7)``, ``monotonically_increasing_id()``,
   ``spark_partition_id()`` and the hour, minute and second of
   ``from_unixtime(id * 37)``, grouped by ``pmod(id, 4096)`` (count,
   sums, min / max of rand and of the id), every column bit for bit
   against a numpy oracle that recomputes the SplitMix64 stream in
   uint64; (b) LINEITEM at SF1 (5,997,887 rows) through a 25-column
   projection (datediff, dayofweek, weekday, dayofyear, quarter,
   last_day, trunc MM, add_months, date_add, round, bround, floor, ceil,
   log, sqrt, exp, pow, least, greatest, abs, signum, isnan, nanvl,
   at_least_n_non_nulls), grouped by (month, day of week) with integer
   sums, min / max of every projected column and first / last of
   ``l_orderkey`` at one partition (floats to rtol 1e-9, the rest
   exact), and the projection's first 1,048,576 rows downloaded: dates,
   integers, round, bround, floor and ceil bit for bit, each
   transcendental (and sqrt) within 4 ulp of numpy, its largest distance
   printed (the head query projects those rows only); (c) ship and
   receipt dates as one column (UNION ALL, 11,995,774
   rows) by year and quarter, and range(0, 2^25) UNION ALL range(2^25,
   2^26) at 8 + 8 partitions counted by partition id. Under the default
   conf the projection (log / exp / pow) and union_dates' float sum run on
   the host engine. For each run: host nodes and bridges (checked), rows
   downloaded, the first run (counters around it alone, every K1-K4
   launch recorded), two warm walls and the peak device memory of the
   warm runs. K1 must launch in every run, K2 in (a) and (b) (Min/Max and
   the first / last picks); each K1-K4 launch of a shape no earlier phase
   checked must equal the kernel's plain version bit for bit, and the
   largest new K1 shape (the groups' 6,291,456-row sort) is timed against
   its plain version and ``torch.sort``. The phase's time is printed.
17. A ``{"kernels": [...]}`` line: each ported kernel's launches on the
   paths (q1 + q3 + q4 + q2 hand-built, then q1-q6 through the DataFrame
   front end, then q1-q6 under the default conf, then phase 13's
   fourteen runs, phase 14's twelve, phase 15's fourteen, phase 16's
   nineteen, phase 18's eleven and phase 19's ten), its error against the
   plain version,
   its
   time, the plain version's, its bound, and one PyTorch call's time for
   the same function (K1: the whole sort at 786 432 rows against
   ``torch.sort``; K2: the per-group function on q2's largest launch
   against the scatter_reduce).

Every query runs under the default ``v2`` wire codec unless a phase says
otherwise. The total time of the script is printed before the last line,
which is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The script imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
CAPS = (512, 786_432, 4_194_304)   # tiny, one q1 SF1 partition, batchSizeRows
PATH_CAP = 786_432
ORACLE_RTOL = 1e-9


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call over ``iters`` calls (CUDA
    events around the whole run, after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def turns_ms(fns: dict, iters: int, rounds: int = 5) -> dict:
    """Median over ``rounds`` of each function's :func:`cuda_ms`, the
    functions timed in turns (a, b, b, a, a, b, ...), so drift of the
    host or the card falls on all of them alike."""
    times = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(cuda_ms(fns[k], iters))
    return {k: float(np.median(v)) for k, v in times.items()}


def bytes_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# Phase 3: kernel K1 against its plain version and torch.sort
# ---------------------------------------------------------------------------

SORT_KINDS = ("random", "dups", "zero_one", "random+perm")


def make_keys(kind: str, cap: int, seed: int):
    """int64-carried u32 keys on the card: full-range random, five values
    with the extremes, or a 0/1 word (three digits of one bucket)."""
    import torch
    rng = np.random.default_rng(seed)
    if kind.startswith("random"):
        k = rng.integers(0, 2 ** 32, cap, dtype=np.int64)
    elif kind == "dups":
        k = rng.choice(np.array([0, 1, 0x00FF00FF, 0x7FFFFFFF, 0xFFFFFFFF],
                                np.int64), cap)
    else:
        k = rng.integers(0, 2, cap, dtype=np.int64)
    return torch.from_numpy(k).cuda()


def sort_bound(cap: int, key_bytes: int, perm: bool) -> dict:
    """The function's byte bound (keys, and perm, read once; the order
    written once) and the byte bound of the kernel's passes: the
    histogram and pass 1 read the keys (and perm), passes 1-3 write and
    passes 2-4 read a u32 key and an int32 index, pass 4 writes the
    index (or gathers and writes perm[index], 8 B each)."""
    p = 8.0 if perm else 0.0
    fn = key_bytes + p + (8.0 if perm else 4.0)
    passes = (key_bytes + p) * 2 + 8.0 + 16.0 * 2 + 8.0 + \
        (16.0 if perm else 4.0)
    return dict(bound_ms=bytes_ms(fn * cap), fn_bytes_per_row=fn,
                pass_bound_ms=bytes_ms(passes * cap),
                pass_bytes_per_row=passes)


def kernel_phase(native) -> dict:
    """K1 bit for bit against its plain version and
    ``torch.sort(stable=True)`` at every capacity and key kind, then the
    kernel, plain and torch.sort times beside the bounds."""
    import torch
    results = {}
    for cap in CAPS:
        for kind in SORT_KINDS:
            keys = make_keys(kind, cap, seed=cap + len(kind))
            perm = None
            if kind.endswith("perm"):
                perm = torch.from_numpy(np.random.default_rng(cap).permutation(
                    cap).astype(np.int64)).cuda()
            native.reset_counters()
            got = native.stable_argsort_u32(keys, perm)
            torch.cuda.synchronize()
            launches = native.counters()["radix_sort"]
            plain = native.stable_argsort_u32_plain(keys, perm)
            if perm is None:
                lib = torch.sort(keys, stable=True).indices.to(torch.int32)
            else:
                lib = perm[torch.sort(keys[perm], stable=True).indices]
            if launches != 1:
                raise AssertionError(f"K1 made {launches} C calls for one "
                                     f"sort at cap={cap} {kind}")
            err = max(max_abs_err(got, plain), max_abs_err(got, lib))
            if not torch.equal(got, plain) or err != 0:
                raise AssertionError(f"K1 != plain at cap={cap} {kind}")
            if not torch.equal(got, lib):
                raise AssertionError(f"K1 != torch.sort at cap={cap} {kind}")
            iters = 20 if cap < 4_000_000 else 10
            r = dict(sort_bound(cap, keys.element_size(), perm is not None),
                     max_abs_err=err, cap=cap, kind=kind)
            r["ms"] = cuda_ms(lambda: native.stable_argsort_u32(keys, perm),
                              iters)
            r["plain_ms"] = cuda_ms(
                lambda: native.stable_argsort_u32_plain(keys, perm), 3,
                warmup=1)
            if perm is None:
                r["library_ms"] = cuda_ms(
                    lambda: torch.sort(keys, stable=True), iters)
            else:
                r["library_ms"] = cuda_ms(lambda: perm.index_select(
                    0, torch.sort(keys.index_select(0, perm),
                                  stable=True).indices), iters)
            results[(cap, kind)] = r
            lib_name = "torch.sort" if perm is None \
                else "gather + torch.sort + gather"
            log(f"K1 stable_argsort_u32 cap={cap} keys={kind}: bit-identical"
                f" to plain and torch.sort, one C call; kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, {lib_name} "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['fn_bytes_per_row']:.0f} B/row), passes' bound "
                f"{r['pass_bound_ms']:.4f} ms ({r['pass_bytes_per_row']:.0f} "
                f"B/row)")
    return results


def device_ms(fn, iters: int):
    """Device milliseconds per call of ``fn`` from ``torch.profiler``: the
    sum of the CUDA kernel and memset events over ``iters`` calls, or None
    when the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
    return total / 1e3 / iters if total > 0 else None


def sort_profile_phase(native, k1: dict) -> dict:
    """One 786,432-row sort (random keys): the CUDA-event time of the
    whole call beside the profiler's device time of its memset and five
    kernels, so host and device time stand apart."""
    keys = make_keys("random", PATH_CAP, seed=1)
    dev = device_ms(lambda: native.stable_argsort_u32(keys), 20)
    event = k1[(PATH_CAP, "random")]["ms"]
    shown = "not measured (no device events)" if dev is None \
        else f"{dev:.4f} ms"
    log(f"K1 one sort at {PATH_CAP} rows: {event:.4f} ms a call (CUDA "
        f"events, back to back), device time {shown} (torch.profiler: "
        f"memset, histogram and four onesweep passes)")
    return dict(event_ms=event, device_ms=dev)


# ---------------------------------------------------------------------------
# Phase 4: TPC-H Q1 at SF1 against a numpy oracle
# ---------------------------------------------------------------------------

def q1_oracle(cols: dict, cutoff: int) -> list:
    """TPC-H Q1 over the LINEITEM columns in plain numpy: rows sorted by
    (returnflag, linestatus)."""
    keep = cols["l_shipdate"] <= cutoff
    rf = cols["l_returnflag"][keep].astype(np.int64)
    ls = cols["l_linestatus"][keep].astype(np.int64)
    qty = cols["l_quantity"][keep]
    price = cols["l_extendedprice"][keep]
    disc = cols["l_discount"][keep]
    tax = cols["l_tax"][keep]
    disc_price = price * (1.0 - disc)
    charge = price * (1.0 - disc) * (1.0 + tax)
    key = rf * 256 + ls
    uniq, inv = np.unique(key, return_inverse=True)
    cnt = np.bincount(inv)

    def s(v):
        return np.bincount(inv, weights=v)

    rows = []
    for g, k in enumerate(uniq):
        rows.append((chr(k // 256), chr(k % 256), s(qty)[g], s(price)[g],
                     s(disc_price)[g], s(charge)[g], s(qty)[g] / cnt[g],
                     s(price)[g] / cnt[g], s(disc)[g] / cnt[g],
                     int(cnt[g])))
    return rows


def check_q1(rows: list, want: list) -> None:
    if len(rows) != len(want):
        raise AssertionError(f"q1: {len(rows)} groups, oracle {len(want)}")
    for got, exp in zip(rows, want):
        if got[:2] != exp[:2] or got[9] != exp[9]:
            raise AssertionError(f"q1 keys/count differ: {got} vs {exp}")
        vals = np.array(got[2:9], np.float64)
        if not np.all(np.isfinite(vals)):
            raise AssertionError(f"q1 non-finite values: {got}")
        if not np.allclose(vals, np.array(exp[2:9], np.float64),
                           rtol=ORACLE_RTOL, atol=0.0):
            raise AssertionError(f"q1 values differ: {got} vs {exp}")


def path_phase(entry, native) -> dict:
    import torch
    t0 = time.perf_counter()
    cols = entry.tpch_q1_columns(1.0, seed=0)
    parts = entry.tpch_q1_host_batches(1.0, partitions=8, seed=0)
    n_rows = sum(p[0].num_rows for p in parts)
    want = q1_oracle(cols, entry.Q1_SHIPDATE_CUTOFF)
    log(f"q1 SF1: {n_rows} LINEITEM rows in {len(parts)} partitions "
        f"(generated + oracle in {time.perf_counter() - t0:.2f} s)")
    from spark_rapids_tpu_torch.columnar import wire
    plan = entry.tpch_q1_plan(parts, device="cuda")
    native.reset_counters()
    wire.reset_counters()
    t0 = time.perf_counter()
    rows = plan.collect()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = native.counters()
    codec = codec_summary("q1", wire.counters())
    check_q1(rows, want)
    if launches["radix_sort"] <= 0:
        raise AssertionError(f"q1 did not launch K1: {launches}")
    t0 = time.perf_counter()
    rows = plan.collect()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check_q1(rows, want)
    for r in rows:
        log(f"  {r}")
    log(f"q1 SF1 matches the numpy oracle (keys and counts exact, values "
        f"rtol {ORACLE_RTOL}); first run {first_s:.3f} s, warm run "
        f"{warm_s:.3f} s, {n_rows / warm_s:.0f} input rows/s (warm); "
        f"K1 launches {launches}")
    return dict(launches=launches, first_s=first_s, warm_s=warm_s,
                rows=n_rows, codec=codec, plan=plan, parts=parts)


# ---------------------------------------------------------------------------
# Phase 5: kernel K3 (the join probe) against its plain version
# ---------------------------------------------------------------------------

# (build, probe): a tiny launch (32 lanes a probe), a 3 * 2^20 build rung
# probed at 16, 8 and 1 lanes (probe_lanes on 132 SMs; 1 just past the
# k-ary cut and further on), and 4M x 4M at 1 lane.
PROBE_SHAPES = ((512, 512), (3_145_728, 6_000), (3_145_728, 12_000),
                (3_145_728, 20_000), (3_145_728, 150_000),
                (4_194_304, 4_194_304))
U64_MAX = 0xFFFFFFFFFFFFFFFF
INT64_MIN = -(1 << 63)
# H100 SXM float32 rate outside the tensor cores, taken as its 32-bit
# integer ALU rate.
ALU_OPS_PER_S = 67e12


def probe_inputs(cap_b: int, cap_p: int, seed: int):
    """Sorted full-range u64 build fingerprints with runs of 1-7 and a
    sentinel tail (about 40% of the build); probes half hits, half
    random, with 0, 2^64-1 and 2^63 among them. int64 bit patterns on
    the card."""
    import torch
    rng = np.random.default_rng(seed)
    n_live = int(cap_b * 0.6)
    distinct = rng.integers(0, U64_MAX, max(n_live, 1), dtype=np.uint64,
                            endpoint=True)
    live = np.repeat(distinct, rng.integers(1, 8, len(distinct)))[:n_live]
    build = np.concatenate([np.sort(live), np.full(cap_b - len(live),
                                                   U64_MAX, np.uint64)])
    probe = np.where(rng.random(cap_p) < 0.5, rng.choice(build, cap_p),
                     rng.integers(0, U64_MAX, cap_p, dtype=np.uint64,
                                  endpoint=True))
    probe[:3] = [0, U64_MAX, 1 << 63]
    return (torch.from_numpy(build.view(np.int64)).cuda(),
            torch.from_numpy(probe.view(np.int64)).cuda())


def probe_bound(cap_b: int, cap_p: int) -> tuple:
    """(bound_ms, bound_by). Bytes: probe fingerprints in and lo/hi out
    (16 B a row), plus the distinct 32-byte build sectors the searches
    read. The lo and hi searches read the same sectors until their last
    step, and the top floor(log2 cap_p) levels of the search tree, about
    cap_p sectors in all, are shared by every probe; each deeper level
    reads at most one sector a probe, and no search reads more than the
    whole build (cap_b / 4 sectors). Operations: 2 ceil(log2 cap_b)
    search steps a row at 4 32-bit ALU operations each."""
    steps = max((cap_b - 1).bit_length(), 1)        # ceil(log2 cap_b)
    shared = max(cap_p.bit_length() - 1, 0)         # floor(log2 cap_p)
    sectors = min(cap_b / 4.0, cap_p * max(steps - shared + 1, 1))
    nbytes = 16.0 * cap_p + 32.0 * sectors
    ops_ms = 2.0 * steps * 4.0 * cap_p / ALU_OPS_PER_S * 1e3
    b_ms = bytes_ms(nbytes)
    return (b_ms, "bytes") if b_ms >= ops_ms else (ops_ms, "operations")


def cold_ms(fn, iters: int, flush_bytes: int = 64 << 20) -> float:
    """Mean device milliseconds of one call with a cold L2: a write of
    ``flush_bytes`` (more than the H100's 50 MB L2) before each call, and
    CUDA events around each call alone."""
    import torch
    scratch = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    fn()
    total = 0.0
    for _ in range(iters):
        scratch.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def probe_design(native, cap_b: int, cap_p: int, device) -> str:
    """The lane count K3 takes for this launch, and its dependent steps:
    k-ary steps at G >= 2 lanes, halvings of the binary walk at 1."""
    lanes = native.probe_lanes(cap_p, native.sm_count(device))
    if lanes == 1:
        return (f"1 lane a probe, binary walk of "
                f"{max(cap_b - 1, 0).bit_length()} halvings")
    steps, t = 0, cap_b + 1
    while t > 1:
        t = (t + lanes) // (lanes + 1)
        steps += 1
    return f"{lanes} lanes a probe, {steps} k-ary steps"


def probe_check(native, build, probe, label: str, profiled: bool = False,
                cold: bool = False, timed: bool = True) -> dict:
    """K3 against its plain version (bit for bit); with ``timed``, then
    kernel and two-``torch.searchsorted`` times on the same inputs, in
    turns, and the plain version's; with ``profiled``, the kernel's device
    time; with ``cold``, also its time with a cold L2."""
    import torch
    cap_b, cap_p = build.numel(), probe.numel()
    lo, hi = native.searchsorted_u64_pair(build, probe)
    torch.cuda.synchronize()
    plo, phi = native.searchsorted_u64_pair_plain(build, probe)
    err = max((lo.to(torch.int64) - plo.to(torch.int64)).abs().max().item(),
              (hi.to(torch.int64) - phi.to(torch.int64)).abs().max().item())
    if err != 0 or not (torch.equal(lo, plo) and torch.equal(hi, phi)):
        raise AssertionError(f"K3 != plain at {label} ({cap_b} x {cap_p})")
    if not timed:
        return dict(max_abs_err=float(err), cap_b=cap_b, cap_p=cap_p)
    iters = 20 if cap_p >= 1_000_000 else 50
    bf, qf = build ^ INT64_MIN, probe ^ INT64_MIN

    def kernel():
        native.searchsorted_u64_pair(build, probe)

    def library():
        torch.searchsorted(bf, qf, side="left")
        torch.searchsorted(bf, qf, side="right")
    t = turns_ms({"ms": kernel, "library_ms": library}, iters)
    r = dict(t, plain_ms=cuda_ms(lambda: native.searchsorted_u64_pair_plain(
        build, probe), iters), max_abs_err=float(err), cap_b=cap_b,
        cap_p=cap_p, design=probe_design(native, cap_b, cap_p, probe.device))
    r["bound_ms"], r["bound_by"] = probe_bound(cap_b, cap_p)
    note = ""
    if profiled:
        dev = device_ms(kernel, 20)
        r["device_ms"] = dev
        note = "; device time " + (
            "not measured (no device events)" if dev is None
            else f"{dev:.4f} ms (torch.profiler)")
    if cold:
        r["cold_ms"] = cold_ms(kernel, 20)
        r["cold_library_ms"] = cold_ms(library, 20)
        note += (f"; cold L2 (64 MiB written before each call): kernel "
                 f"{r['cold_ms']:.4f} ms, two torch.searchsorted "
                 f"{r['cold_library_ms']:.4f} ms")
    log(f"K3 searchsorted_u64_pair {label} build={cap_b} probe={cap_p} "
        f"({r['design']}): bit-identical to plain; kernel {r['ms']:.4f} ms, "
        f"two torch.searchsorted {r['library_ms']:.4f} ms (medians of 5 "
        f"turns), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
        f"ms ({r['bound_by']}){note}")
    return r


def probe_edges(native) -> int:
    """K3 bit for bit against its plain version, untimed, at the edges of
    its design: an empty build, builds of 1 and 3 entries, all-sentinel
    builds, and a run of equal keys longer than a pivot spacing, each
    probed at every lane count ``probe_lanes`` gives on 132 SMs: 32
    (2,048 probes), 16 (8,192), 8 (12,000) and 1 (300,000)."""
    import torch
    sentinel = U64_MAX - (1 << 64)        # 2^64 - 1 as an int64 pattern
    cases = 0
    for cap_p in (2_048, 8_192, 12_000, 300_000):
        _b, probe = probe_inputs(1_000, cap_p, seed=cap_p)
        run_b, run_p = probe_inputs(3_145_728, cap_p, seed=cap_p + 1)
        run_b = run_b.clone()
        run_b[1_000_000:1_400_000] = run_b[1_000_000]   # a 400,000-key run
        run_p[:100] = run_b[1_000_000]
        builds = [torch.empty(0, dtype=torch.int64, device="cuda"),
                  probe[:1].sort().values, probe[:3].sort().values,
                  torch.full((1,), sentinel, dtype=torch.int64,
                             device="cuda"),
                  torch.full((6_291_456,), sentinel, dtype=torch.int64,
                             device="cuda"),
                  run_b]
        for build in builds:
            bu = build ^ INT64_MIN
            build = (bu.sort().values ^ INT64_MIN).contiguous()
            p = run_p if build.numel() == run_b.numel() else probe
            lo, hi = native.searchsorted_u64_pair(build, p)
            plo, phi = native.searchsorted_u64_pair_plain(build, p)
            torch.cuda.synchronize()
            if not (torch.equal(lo, plo) and torch.equal(hi, phi)):
                raise AssertionError(f"K3 != plain at build={build.numel()} "
                                     f"probe={p.numel()} (edge case)")
            cases += 1
    log(f"K3 edge cases: {cases} launches bit-identical to plain (empty, "
        f"1- and 3-entry, all-sentinel builds, a 400,000-key run; 32, 16, 8 "
        f"and 1 lanes)")
    return cases


def probe_phase(native) -> dict:
    probe_edges(native)
    return {shape: probe_check(native, *probe_inputs(*shape, seed=shape[0]),
                               label="synthetic",
                               profiled=shape == PROBE_SHAPES[-1])
            for shape in PROBE_SHAPES}


# ---------------------------------------------------------------------------
# Phase 6: TPC-H Q3 and Q4 at SF1 against numpy oracles
# ---------------------------------------------------------------------------

def _semi_hit(sorted_keys, keys):
    """keys found in sorted_keys (a searchsorted membership test)."""
    if not len(sorted_keys):
        return np.zeros(len(keys), bool)
    pos = np.clip(np.searchsorted(sorted_keys, keys), 0, len(sorted_keys) - 1)
    return sorted_keys[pos] == keys


def q3_oracle(cols: dict, E) -> list:
    """TPC-H Q3 in plain numpy: (l_orderkey, o_orderdate,
    o_shippriority, revenue), top 10 by revenue desc, o_orderdate asc."""
    c, o, li = cols["customer"], cols["orders"], cols["lineitem"]
    seg = E.SEGMENTS.index(E.Q3_SEGMENT)
    cust = np.unique(c["c_custkey"][c["c_mktsegment"] == seg])
    om = o["o_orderdate"] < E.Q3_DATE
    om[om] = _semi_hit(cust, o["o_custkey"][om])
    okey = o["o_orderkey"][om]
    odate = o["o_orderdate"][om]
    oprio = o["o_shippriority"][om]
    order = np.argsort(okey, kind="stable")
    okey_s = okey[order]
    lm = li["l_shipdate"] > E.Q3_DATE
    lkey = li["l_orderkey"][lm]
    rev = li["l_extendedprice"][lm] * (1.0 - li["l_discount"][lm])
    hit = _semi_hit(okey_s, lkey)
    at = order[np.searchsorted(okey_s, lkey[hit])]
    keys, inv = np.unique(lkey[hit], return_inverse=True)
    revenue = np.bincount(inv, weights=rev[hit])
    gdate = np.zeros(len(keys), np.int64)
    gprio = np.zeros(len(keys), np.int64)
    gdate[inv] = odate[at]
    gprio[inv] = oprio[at]
    top = np.lexsort((gdate, -revenue))[:E.Q3_LIMIT]
    return [(int(keys[i]), int(gdate[i]), int(gprio[i]), float(revenue[i]))
            for i in top]


def check_q3(rows: list, want: list) -> None:
    if len(rows) != len(want):
        raise AssertionError(f"q3: {len(rows)} rows, oracle {len(want)}")
    for got, exp in zip(rows, want):
        if tuple(got[:3]) != exp[:3]:
            raise AssertionError(f"q3 keys/order differ: {got} vs {exp}")
        if not np.isfinite(got[3]) or not np.isclose(
                got[3], exp[3], rtol=ORACLE_RTOL, atol=0.0):
            raise AssertionError(f"q3 revenue differs: {got} vs {exp}")


def q4_oracle(cols: dict, E) -> list:
    """TPC-H Q4 in plain numpy: (o_orderpriority, order_count) by
    priority."""
    o, li = cols["orders"], cols["lineitem"]
    late = np.unique(li["l_orderkey"][li["l_commitdate"]
                                      < li["l_receiptdate"]])
    om = (o["o_orderdate"] >= E.Q4_DATE_LO) & (o["o_orderdate"]
                                               < E.Q4_DATE_HI)
    prio = o["o_orderpriority"][om][_semi_hit(late, o["o_orderkey"][om])]
    counts = np.bincount(prio, minlength=len(E.PRIORITIES))
    return [(E.PRIORITIES[i], int(n)) for i, n in enumerate(counts) if n]


def check_q4(rows: list, want: list) -> None:
    if [tuple(r) for r in rows] != want:
        raise AssertionError(f"q4 differs: {rows} vs oracle {want}")


def _strings(m: np.ndarray) -> list:
    """Rows of a zero-padded (n, w) uint8 matrix as str."""
    return [bytes(r).rstrip(b"\0").decode() for r in m]


def q2_oracle(cols: dict, E) -> list:
    """TPC-H Q2 in plain numpy: for BRASS parts of size 15, the EUROPE
    suppliers at the part's minimum EUROPE supply cost, as (s_acctbal,
    s_name, n_name, p_partkey, p_mfgr, s_address, s_phone, s_comment),
    top 100 by s_acctbal desc, n_name, s_name, p_partkey."""
    p, ps, s, n = (cols["part"], cols["partsupp"], cols["supplier"],
                   cols["nation"])
    europe = E.REGIONS.index(E.Q2_REGION_NAME)
    supp_ok = (n["n_regionkey"] == europe)[s["s_nationkey"]]
    ps_ok = supp_ok[ps["ps_suppkey"] - 1]
    pk, cost = ps["ps_partkey"], ps["ps_supplycost"]
    minc = np.full(len(p["p_partkey"]) + 1, np.inf)
    np.minimum.at(minc, pk[ps_ok], cost[ps_ok])
    ptype = p["p_type"]
    plen = (ptype != 0).sum(axis=1)
    suffix = np.frombuffer(E.Q2_TYPE_SUFFIX.encode(), np.uint8)
    at = plen[:, None] - len(suffix) + np.arange(len(suffix))[None, :]
    ends = (plen >= len(suffix)) & np.all(
        np.take_along_axis(ptype, np.clip(at, 0, ptype.shape[1] - 1), 1)
        == suffix, axis=1)
    part_ok = (p["p_size"] == E.Q2_SIZE) & ends
    hit = np.flatnonzero(ps_ok & part_ok[pk - 1] & (cost == minc[pk]))
    si = ps["ps_suppkey"][hit] - 1
    pi = pk[hit] - 1
    nations = [nm for nm, _ in E.NATIONS]
    comments = E.S_COMMENTS
    names, phones = _strings(s["s_name"][si]), _strings(s["s_phone"][si])
    mfgrs = _strings(p["p_mfgr"][pi])
    rows = [(float(s["s_acctbal"][a]), names[i],
             nations[int(s["s_nationkey"][a])], int(p["p_partkey"][b]),
             mfgrs[i], comments[int(s["s_address"][a])], phones[i],
             comments[int(s["s_comment"][a])])
            for i, (a, b) in enumerate(zip(si, pi))]
    rows.sort(key=lambda r: (-r[0], r[2], r[1], r[3]))
    return rows[:E.Q2_LIMIT]


def check_q2(rows: list, want: list) -> None:
    if not want:
        raise AssertionError("q2 oracle is empty: nothing would be checked")
    if [tuple(r) for r in rows] != want:
        raise AssertionError(f"q2 differs: {len(rows)} rows, oracle "
                             f"{len(want)}; first rows {rows[:3]} vs "
                             f"{want[:3]}")


def run_path(name: str, plan, native, check, want, show: int = 10) -> dict:
    """First and warm runs of one plan on the card, each checked; the
    launch counters are read around the first run alone. Prints the first
    ``show`` rows."""
    import torch
    from spark_rapids_tpu_torch.columnar import wire
    native.reset_counters()
    wire.reset_counters()
    t0 = time.perf_counter()
    rows = plan.collect()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = native.counters()
    codec = codec_summary(name, wire.counters())
    check(rows, want)
    t0 = time.perf_counter()
    rows = plan.collect()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(rows, want)
    for r in rows[:show]:
        log(f"  {r}")
    log(f"{name} SF1 matches the numpy oracle ({len(rows)} rows); first run "
        f"{first_s:.3f} s, warm run {warm_s:.3f} s; launches {launches}")
    return dict(launches=launches, first_s=first_s, warm_s=warm_s,
                codec=codec)


def codec_summary(name: str, counters: dict) -> dict:
    """The wire codec's per-kind column counts and encoded vs raw bytes
    of one run, printed."""
    cols = {k.split(".", 1)[1]: int(v) for k, v in sorted(counters.items())
            if k.startswith("codecCols.")}
    raw, enc = counters.get("rawBytes", 0), counters.get("encodedBytes", 0)
    log(f"{name} wire codec: columns {cols}; encoded {int(enc)} B vs raw "
        f"{int(raw)} B (ratio {raw / max(enc, 1):.3f}); staging "
        f"{int(counters.get('stagingBytes', 0))} B in "
        f"{int(counters.get('uploadTransfers', 0))} transfers")
    return dict(cols=cols, raw_bytes=raw, encoded_bytes=enc)


# The launch functions of K3, K2 and K4 (each wrapper's one launch site),
# the counter each adds to, and the shape of one launch's arguments.
LAUNCHES = {
    "join_probe": ("join_probe", lambda b, p, _lo, _hi: (
        b.numel(), p.numel())),
    "seg_reduce": ("seg_reduce", lambda g, k, kind, cap, _i: (
        g.numel(), str(k.dtype).replace("torch.", ""), kind, cap)),
    "rle_expand": ("rle_decode", lambda v, _e, n, out: (
        v.numel(), str(v.dtype).replace("torch.", ""), n, out.numel())),
}


@contextlib.contextmanager
def recording(native, seen: dict):
    """While the block runs, keep the arguments of every K3, K2 and K4
    launch in ``seen`` (launch function -> list of argument tuples); the
    launches themselves, and their counts, are unchanged."""
    saved = {fn: getattr(native, fn) for fn in LAUNCHES}

    def keeper(fn, launch):
        def recorder(*args):
            seen.setdefault(fn, []).append(args)
            return launch(*args)
        return recorder
    for fn, launch in saved.items():
        setattr(native, fn, keeper(fn, launch))
    try:
        yield seen
    finally:
        for fn, launch in saved.items():
            setattr(native, fn, launch)


def first_run(seen: dict, launches: dict) -> dict:
    """The recorded launches of a path's first run (``launches``: its
    counters), which come before its warm runs'."""
    return {fn: seen.get(fn, [])[:launches[counter]]
            for fn, (counter, _shape) in LAUNCHES.items()}


def launch_shapes(fn: str, calls: list) -> list:
    return sorted({LAUNCHES[fn][1](*args) for args in calls})


def join_paths_phase(entry, native, cols: dict) -> dict:
    t0 = time.perf_counter()
    want3 = q3_oracle(cols, entry)
    want4 = q4_oracle(cols, entry)
    q3 = entry.tpch_q3_plan(entry.tpch_q3_tables(cols), device="cuda")
    q4 = entry.tpch_q4_plan(entry.tpch_q4_tables(cols), device="cuda")
    log(f"q3/q4 SF1: {len(cols['lineitem']['l_orderkey'])} LINEITEM, "
        f"{len(cols['orders']['o_orderkey'])} ORDERS, "
        f"{len(cols['customer']['c_custkey'])} CUSTOMER rows (generated + "
        f"oracles in {time.perf_counter() - t0:.2f} s)")
    # Keep the inputs of every K4 launch of q3 (its o_shippriority ships
    # as a run table) and every K3 launch of q4: each kernel is then
    # checked and timed on the main path's own inputs.
    seen3, seen4 = {}, {}
    with recording(native, seen3):
        out = {"q3": run_path("q3", q3, native, check_q3, want3)}
    log(f"q3 K3 launches: {out['q3']['launches']['join_probe']} (its joins "
        f"take the dense table)")
    first = first_run(seen3, out["q3"]["launches"])["rle_expand"]
    if not first:
        raise AssertionError("q3 did not launch K4 (rle_decode) under the "
                             "default wire codec")
    log(f"q3 K4 launches {len(first)} (8 expected: one per ORDERS "
        f"partition) over (run_cap, value type, num_rows, cap) "
        f"{launch_shapes('rle_expand', first)}")
    vals, ends, nrows, out_t = first[0]
    out["q3_rle"] = rle_check(native, vals, ends, out_t.numel(), nrows,
                              "q3 first launch", timed=True, profiled=True)
    with recording(native, seen4):
        out["q4"] = run_path("q4", q4, native, check_q4, want4)
    probes = first_run(seen4, out["q4"]["launches"])["join_probe"]
    if not probes:
        raise AssertionError("q4 did not launch K3 (join_probe)")
    log(f"q4 K3 launches {len(probes)} over (build x probe) shapes "
        f"{launch_shapes('join_probe', probes)}")
    out["q4_probe"] = probe_check(native, *probes[0][:2],
                                  label="q4 first probe", profiled=True,
                                  cold=True)
    out["seen"] = [first_run(seen3, out["q3"]["launches"]),
                   first_run(seen4, out["q4"]["launches"])]
    out["plans"] = {"q3": q3, "q4": q4}
    return out


# ---------------------------------------------------------------------------
# Phase 7: kernel K2 (the sorted-segment reduce) against its plain version
# ---------------------------------------------------------------------------

SEG_KINDS = (("sum", 32), ("sum", 64), ("min", 32), ("max", 32),
             ("min", 64), ("max", 64))
SEG_NEUTRAL = {"sum": 0, "min": -1, "max": 0}
SEG_REPEATS = 20       # launches compared at the largest size


def seg_inputs(cap: int, bits: int, seed: int):
    """Nondecreasing int64 group ids, three quarters of the rows in
    segments of 1-64 rows and the last quarter in segments of 20,000 to
    60,000 rows (many 2,048-row tiles each), and full-range u32 or u64
    keys with 0 and the maximum salted in, as int32 / int64 bit patterns
    on the card."""
    import torch
    rng = np.random.default_rng(seed)
    head = cap - cap // 4
    lens = rng.integers(1, 65, head // 16 + 1)
    gid = np.repeat(np.arange(len(lens)), lens)[:head]
    tail = cap - len(gid)
    long_lens = rng.integers(20_000, 60_001, tail // 20_000 + 1)
    gid = np.concatenate([gid, len(lens) + np.repeat(
        np.arange(len(long_lens)), long_lens)[:tail]]).astype(np.int64)
    hi = (1 << bits) - 1
    k = rng.integers(0, hi, cap, dtype=np.uint64, endpoint=True)
    k[rng.random(cap) < 0.05] = hi
    k[rng.random(cap) < 0.05] = 0
    keys = k.astype(np.uint32).view(np.int32) if bits == 32 \
        else k.view(np.int64)
    return (torch.from_numpy(gid).cuda(),
            torch.from_numpy(np.ascontiguousarray(keys)).cuda())


def seg_bound(n: int, key_bytes: int, capacity: int) -> tuple:
    """(bound_ms, bound_by): each row's gid (8 B) and key read once and
    each of the ``capacity`` per-group slots written once, at 3.35 TB/s;
    one add or compare a row at the 32-bit ALU rate is far below it."""
    b_ms = bytes_ms(n * (8.0 + key_bytes) + capacity * key_bytes)
    ops_ms = n / ALU_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= ops_ms else (ops_ms, "operations")


def seg_check(native, gid, keys, kind: str, capacity: int, identity: int,
              label: str, repeats: int = 1, timed: bool = True,
              profiled: bool = False) -> dict:
    """K2 (the per-group function, one C call) against its plain version
    (running scan + finish) bit for bit over ``repeats`` launches, and
    again with the whole column one segment and with a capacity below the
    largest id; against one ``scatter_reduce_`` into an identity-filled
    output bit for bit where every id fits; with ``timed``, the times of
    K2, the plain version and the scatter_reduce beside the bound; with
    ``profiled``, also K2's device time."""
    import torch
    n = keys.numel()
    sign = -(1 << 31) if keys.dtype == torch.int32 else INT64_MIN
    plain = native.seg_reduce_plain(gid, keys, kind, capacity, identity)
    native.reset_counters()
    for i in range(repeats):
        got = native.seg_reduce(gid, keys, kind, capacity, identity)
        torch.cuda.synchronize()
        wrong = int((got != plain).sum())
        err = max_abs_err(got, plain, unsigned=True)
        if wrong or err != 0:
            raise AssertionError(f"K2 != plain at {label} {kind} n={n} "
                                 f"capacity={capacity}, launch {i}: {wrong} "
                                 f"slots differ, max abs err {err}")
    if native.counters()["seg_reduce"] != repeats:
        raise AssertionError(f"K2 made {native.counters()['seg_reduce']} C "
                             f"calls for {repeats} reductions")
    top = int(gid[-1])
    zero = torch.zeros_like(gid)
    for g, cap_ in ((zero, capacity), (gid, max(top // 2, 1))):
        if not torch.equal(native.seg_reduce(g, keys, kind, cap_, identity),
                           native.seg_reduce_plain(g, keys, kind, cap_,
                                                   identity)):
            raise AssertionError(f"K2 != plain at {label} {kind} (one "
                                 f"segment, or capacity {cap_} < max id)")
    lib_in = keys if kind == "sum" else keys ^ sign
    reduce = {"sum": "sum", "min": "amin", "max": "amax"}[kind]
    fill = identity if kind == "sum" else identity ^ sign

    def library():
        return torch.full((capacity,), fill, dtype=keys.dtype,
                          device=keys.device).scatter_reduce_(
                              0, gid, lib_in, reduce)

    r = dict(max_abs_err=err, n=n, capacity=capacity, kind=kind,
             key_bits=8 * keys.element_size(), library_ms=None)
    if top < capacity:
        lib = library() if kind == "sum" else library() ^ sign
        if not torch.equal(got, lib):
            raise AssertionError(f"K2 != scatter_reduce at {label} {kind}")
    if not timed:
        return r
    iters = 20 if n >= 1_000_000 else 50
    r["ms"] = cuda_ms(lambda: native.seg_reduce(gid, keys, kind, capacity,
                                                identity), iters)
    r["plain_ms"] = cuda_ms(lambda: native.seg_reduce_plain(
        gid, keys, kind, capacity, identity), 3, warmup=1)
    if top < capacity:
        r["library_ms"] = cuda_ms(library, iters)
    r["bound_ms"], r["bound_by"] = seg_bound(n, keys.element_size(),
                                             capacity)
    lib_ms = "n/a (ids past capacity)" if r["library_ms"] is None \
        else f"{r['library_ms']:.4f} ms"
    note = ""
    if profiled:
        r["device_ms"] = device_ms(lambda: native.seg_reduce(
            gid, keys, kind, capacity, identity), 20)
        note = "; device time " + (
            "not measured (no device events)" if r["device_ms"] is None
            else f"{r['device_ms']:.4f} ms (torch.profiler)")
    log(f"K2 seg_reduce {label} {kind}{r['key_bits']} n={n} "
        f"capacity={capacity}: bit-identical to plain over {repeats} "
        f"launch(es); kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"scatter_reduce {lib_ms}, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}){note}")
    return r


def seg_phase(native) -> dict:
    out = {}
    for cap in CAPS:
        for kind, bits in SEG_KINDS:
            gid, keys = seg_inputs(cap, bits, seed=cap + bits)
            repeats = SEG_REPEATS if cap == CAPS[-1] else 2
            out[(cap, kind, bits)] = seg_check(
                native, gid, keys, kind, cap, SEG_NEUTRAL[kind], "synthetic",
                repeats=repeats)
    return out


# ---------------------------------------------------------------------------
# Phase 8: TPC-H Q2 at SF1 against a numpy oracle
# ---------------------------------------------------------------------------

def q2_phase(entry, native, cols: dict) -> dict:
    t0 = time.perf_counter()
    want = q2_oracle(cols, entry)
    plan = entry.tpch_q2_plan(entry.tpch_q2_tables(cols), device="cuda")
    log(f"q2 SF1: {len(cols['partsupp']['ps_partkey'])} PARTSUPP, "
        f"{len(cols['part']['p_partkey'])} PART, "
        f"{len(cols['supplier']['s_suppkey'])} SUPPLIER rows (oracle and "
        f"scans in {time.perf_counter() - t0:.2f} s)")
    # Keep the inputs of every K2 and K3 launch: each kernel is then
    # checked and timed on the main path's own launches (K2's largest,
    # K3's first).
    seen = {}
    with recording(native, seen):
        r = run_path("q2", plan, native, check_q2, want, show=5)
    c = r["launches"]
    r["seen"] = first_run(seen, c)
    first, probes = r["seen"]["seg_reduce"], r["seen"]["join_probe"]
    if not first:
        raise AssertionError("q2 did not launch K2 (seg_reduce)")
    if not probes:
        raise AssertionError("q2 did not launch K3 (join_probe)")
    log(f"q2 K2 launches {c['seg_reduce']} over (rows, key type, kind, "
        f"capacity) {launch_shapes('seg_reduce', first)}; K3 launches "
        f"{c['join_probe']} (the fast path, about 4 expected) over (build x "
        f"probe) {launch_shapes('join_probe', probes)}; K1 sorts "
        f"{c['radix_sort']}")
    gid, keys, kind, capacity, identity = max(
        first, key=lambda s: (s[1].numel(), s[1].element_size()))
    r["k2"] = seg_check(native, gid, keys, kind, capacity, identity,
                        "q2 largest launch", repeats=SEG_REPEATS,
                        profiled=True)
    r["k3"] = probe_check(native, *probes[0][:2], label="q2 first probe",
                          profiled=True)
    r["plan"] = plan
    return r


# ---------------------------------------------------------------------------
# Phase 11: TPC-H q1-q6 through the DataFrame front end
# ---------------------------------------------------------------------------

def q5_oracle(cols: dict, E) -> list:
    """TPC-H Q5 in plain numpy: (n_name, revenue) of the ASIA customers'
    1994 orders whose line's supplier shares the customer's nation, by
    revenue desc. Keys are positions: o_orderkey, c_custkey and
    s_suppkey count from 1, n_nationkey from 0."""
    n, c, o, li, s = (cols["nation"], cols["customer"], cols["orders"],
                      cols["lineitem"], cols["supplier"])
    asia = (n["n_regionkey"] == E.REGIONS.index(E.Q5_REGION_NAME))
    cust_nat = c["c_nationkey"]
    om = (o["o_orderdate"] >= E.Q5_DATE_LO) & (o["o_orderdate"]
                                               < E.Q5_DATE_HI)
    om &= asia[cust_nat[o["o_custkey"] - 1]]
    order_nat = np.full(len(o["o_orderkey"]) + 1, -1, np.int64)
    order_nat[o["o_orderkey"][om]] = cust_nat[o["o_custkey"][om] - 1]
    line_nat = order_nat[li["l_orderkey"]]
    hit = (line_nat >= 0) & (s["s_nationkey"][li["l_suppkey"] - 1]
                             == line_nat)
    rev = li["l_extendedprice"][hit] * (1.0 - li["l_discount"][hit])
    sums = np.bincount(line_nat[hit], weights=rev, minlength=25)
    present = np.bincount(line_nat[hit], minlength=25) > 0
    rows = [(E.NATIONS[k][0], float(sums[k])) for k in range(25)
            if present[k]]
    rows.sort(key=lambda r: -r[1])
    return rows


def check_q5(rows: list, want: list) -> None:
    if not want:
        raise AssertionError("q5 oracle is empty: nothing would be checked")
    if [r[0] for r in rows] != [w[0] for w in want]:
        raise AssertionError(f"q5 nations/order differ: {rows} vs {want}")
    for got, exp in zip(rows, want):
        if not np.isfinite(got[1]) or not np.isclose(
                got[1], exp[1], rtol=ORACLE_RTOL, atol=0.0):
            raise AssertionError(f"q5 revenue differs: {got} vs {exp}")


def q6_oracle(cols: dict, E) -> list:
    """TPC-H Q6 in plain numpy: one row, the 1994 revenue of lines with a
    discount of 0.05-0.07 and a quantity below 24 (NULL when none)."""
    li = cols["lineitem"]
    m = ((li["l_shipdate"] >= E.Q6_DATE_LO)
         & (li["l_shipdate"] < E.Q6_DATE_HI)
         & (li["l_discount"] >= E.Q6_DISCOUNT_LO)
         & (li["l_discount"] <= E.Q6_DISCOUNT_HI)
         & (li["l_quantity"] < E.Q6_QUANTITY_BELOW))
    if not m.any():
        return [(None,)]
    return [(float(np.sum(li["l_extendedprice"][m] * li["l_discount"][m])),)]


def check_q6(rows: list, want: list) -> None:
    if len(rows) != 1 or len(rows[0]) != 1:
        raise AssertionError(f"q6: expected one value, got {rows}")
    got, exp = rows[0][0], want[0][0]
    if exp is None or got is None:
        if got != exp:
            raise AssertionError(f"q6 differs: {rows} vs {want}")
    elif not np.isfinite(got) or not np.isclose(got, exp, rtol=ORACLE_RTOL,
                                                atol=0.0):
        raise AssertionError(f"q6 revenue differs: {rows} vs {want}")


def rows_close(a: list, b: list) -> bool:
    """Same rows in the same order: floats within ORACLE_RTOL, every other
    value exact."""
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                if not np.isclose(x, y, rtol=ORACLE_RTOL, atol=0.0):
                    return False
            elif x != y:
                return False
    return True


# Each query's numpy oracle and check; the kernels each must launch on the
# DataFrame path.
DF_QUERIES = ("q1", "q6", "q3", "q5", "q2", "q4")
DF_MUST_LAUNCH = {"q1": ("radix_sort",), "q6": (), "q3": (
    "radix_sort", "rle_decode"), "q5": ("radix_sort",), "q2": (
    "radix_sort", "seg_reduce", "join_probe"), "q4": (
    "radix_sort", "join_probe")}
DF_WARM_RUNS = 3


def df_oracles(cols: dict, E) -> dict:
    return {
        "q1": (check_q1, q1_oracle(cols["lineitem"], E.Q1_SHIPDATE_CUTOFF)),
        "q6": (check_q6, q6_oracle(cols, E)),
        "q3": (check_q3, q3_oracle(cols, E)),
        "q5": (check_q5, q5_oracle(cols, E)),
        "q2": (check_q2, q2_oracle(cols, E)),
        "q4": (check_q4, q4_oracle(cols, E))}


def dataframe_phase(native, cols: dict, hand: dict, hand_seen: list) -> dict:
    """q1-q6 through ``TpuSession`` and the port's ``benchmarks/tpch.py``
    (the reference's query text) on the card: each query planned (host
    ms), run once (launch counters around that run alone, K2-K4's inputs
    recorded) and ``DF_WARM_RUNS`` times warm, every run checked against
    its numpy oracle; q1-q4's rows against the hand-built trees'
    (``hand``: query -> (plan, launches of its first run)) in this
    process. Then every K2, K3 and K4 launch whose shape no hand-built
    path gave (``hand_seen``: their recorded first runs) is held to the
    kernel's plain version: see :func:`df_kernel_checks`."""
    import torch
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.columnar import wire
    t0 = time.perf_counter()
    session = TpuSession({"spark.rapids.sql.variableFloatAgg.enabled": True})
    tables = tpch.tpch_tables(session, cols)
    oracles = df_oracles(cols, E)
    log(f"DataFrame phase: tables and oracles in "
        f"{time.perf_counter() - t0:.2f} s")
    out = {}
    for q in DF_QUERIES:
        check, want = oracles[q]
        t0 = time.perf_counter()
        df = tpch.QUERIES[q](session, tables[q])
        phys = df._physical()
        plan_ms = (time.perf_counter() - t0) * 1e3
        log(f"{q} DataFrame plan ({plan_ms:.2f} ms host, query text to "
            f"exec tree):")
        for line in phys.tree().splitlines():
            log(f"  {line}")
        for line in phys.explain().splitlines():
            if "join strategy" in line:
                log(f"  note: {line.strip()}")
        native.reset_counters()
        wire.reset_counters()
        seen = {}
        with recording(native, seen):
            t0 = time.perf_counter()
            rows = df.collect()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        launches = native.counters()
        check(rows, want)
        missing = [k for k in DF_MUST_LAUNCH[q] if launches[k] <= 0]
        if missing:
            raise AssertionError(f"{q} on the DataFrame path launched no "
                                 f"{missing}: {launches}")
        warm = []
        for _ in range(DF_WARM_RUNS):
            t0 = time.perf_counter()
            rows = df.collect()
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
            check(rows, want)
        note = ""
        if q in hand:
            plan, hand_launches = hand[q]
            hand_rows = plan.collect()
            check(hand_rows, want)
            if not rows_close(rows, hand_rows):
                raise AssertionError(f"{q}: DataFrame rows differ from the "
                                     f"hand-built tree's: {rows[:3]} vs "
                                     f"{hand_rows[:3]}")
            same = "identical" if rows == hand_rows else \
                "equal within the oracle's tolerance"
            note = (f"; rows {same} to the hand-built tree's, whose first "
                    f"run launched {hand_launches}")
        log(f"{q} DataFrame path matches the numpy oracle ({len(rows)} "
            f"rows): plan {plan_ms:.2f} ms, first run {first_s:.3f} s, warm "
            f"{[round(w, 4) for w in warm]} s; launches {launches}{note}")
        out[q] = dict(plan_ms=plan_ms, first_s=first_s, warm_s=warm,
                      launches=launches, seen=first_run(seen, launches))
    out["kernel_checks"] = df_kernel_checks(
        native, {q: out[q]["seen"] for q in DF_QUERIES}, hand_seen)
    return out


def df_kernel_checks(native, df_seen: dict, hand_seen: list) -> list:
    """Each K2, K3 and K4 launch of the DataFrame path (``df_seen``: query
    -> recorded first run) whose shape no hand-built path launched
    (``hand_seen``) held to the kernel's plain version bit for bit; the
    largest such launch of a query and kernel also timed against its
    plain version and library call, with its device time. Shapes the
    hand-built paths gave were checked there."""
    known = {fn: set() for fn in LAUNCHES}
    for seen in hand_seen:
        for fn, calls in seen.items():
            known[fn].update(launch_shapes(fn, calls))
    out = []
    for q, seen in df_seen.items():
        for fn, calls in seen.items():
            if not calls:
                continue
            new = {}
            for args in calls:
                shape = LAUNCHES[fn][1](*args)
                if shape not in known[fn]:
                    new.setdefault(shape, args)
            log(f"{q} DataFrame {fn}: {len(calls)} launches, shapes "
                f"{launch_shapes(fn, calls)}; not launched by a hand-built "
                f"path: {sorted(new) or 'none'}")
            largest = max(new, default=None, key=lambda sh: [
                x for x in sh if isinstance(x, int)])
            for shape, args in sorted(new.items()):
                timed = shape == largest
                label = f"DataFrame {q} {'largest new' if timed else 'new'}"
                if fn == "join_probe":
                    r = probe_check(native, *args[:2], label=label,
                                    profiled=timed, timed=timed)
                elif fn == "seg_reduce":
                    r = seg_check(native, *args, label, timed=timed,
                                  profiled=timed)
                else:
                    vals, ends, nrows, out_t = args
                    r = rle_check(native, vals, ends, out_t.numel(), nrows,
                                  label, timed=timed, profiled=timed)
                out.append(dict(r, query=q, kernel=fn, shape=shape))
    return out


# ---------------------------------------------------------------------------
# Phase 12: TPC-H q1-q6 under the default conf (mixed device/host plans)
# ---------------------------------------------------------------------------

# The logical nodes the default conf places on the host (its float Sum/Avg
# aggregates), and the kernels each query must launch in this phase.
DEFAULT_HOST_NODES = {"q1": ["LogicalAggregate"], "q6": ["LogicalAggregate"],
                      "q3": ["LogicalAggregate"], "q5": ["LogicalAggregate"],
                      "q2": [], "q4": []}
DEFAULT_MUST_LAUNCH = {"q1": ("radix_sort",), "q6": (), "q3": (
    "radix_sort", "rle_decode"), "q5": ("radix_sort",), "q2": (
    "radix_sort", "seg_reduce", "join_probe"), "q4": (
    "radix_sort", "join_probe")}
DEFAULT_TURNS = 3
# Phase 3's K1 shapes: (rows, key dtype, with a permutation).
K1_CHECKED = {(cap, "int64", perm) for cap in CAPS for perm in (False, True)}


@contextlib.contextmanager
def recording_k1(native, seen: list):
    """While the block runs, keep the (keys, perm) of every K1 launch in
    ``seen``; the launches and their counts are unchanged."""
    launch = native.radix_sort

    def recorder(keys, perm, out):
        seen.append((keys, perm))
        return launch(keys, perm, out)
    native.radix_sort = recorder
    try:
        yield seen
    finally:
        native.radix_sort = launch


def k1_shape(keys, perm) -> tuple:
    return (keys.numel(), str(keys.dtype).replace("torch.", ""),
            perm is not None)


def k1_checks(native, q: str, calls: list, known=K1_CHECKED) -> list:
    """Each K1 launch of a shape not in ``known`` (default: phase 3's),
    again through the wrapper, bit for bit against the plain version."""
    import torch
    out = []
    for shape in sorted({k1_shape(*a) for a in calls} - set(known)):
        keys, perm = next(a for a in calls if k1_shape(*a) == shape)
        got = native.stable_argsort_u32(keys, perm)
        plain = native.stable_argsort_u32_plain(keys, perm)
        torch.cuda.synchronize()
        err = max_abs_err(got, plain)
        if not torch.equal(got, plain):
            raise AssertionError(f"{q}: K1 != plain at {shape}")
        out.append(dict(query=q, kernel="radix_sort", shape=shape,
                        max_abs_err=err))
    if out:
        log(f"{q} K1: {len(calls)} launches; new shapes "
            f"(rows, key type, perm) {[r['shape'] for r in out]} "
            f"bit-identical to the plain version")
    return out


def _bridges(e, parent=None, out=None) -> list:
    """(transition exec, its parent, its child) of every bridge."""
    out = [] if out is None else out
    name = type(e).__name__
    if name in ("DeviceToHostExec", "HostToDeviceExec"):
        out.append((e, parent, type(e.children[0]).__name__))
    for c in e.children:
        _bridges(c, name, out)
    return out


def host_engine_ms(ctx, wall_ms: float, root_on_device: bool) -> float:
    """The host engine's share of one run: the host clock inside the
    host subtrees (each HostToDeviceExec's pulls, or the whole wall when
    the root is on the host) less the device subtrees and downloads
    below them (each DeviceToHostExec's)."""
    h2d = d2h = 0.0
    for m in ctx.metrics.values():
        if m.owner == "HostToDeviceExec":
            h2d += m.values.get("hostTime", 0) / 1e6
        elif m.owner == "DeviceToHostExec":
            d2h += (m.values.get("deviceTime", 0)
                    + m.values.get("downloadTime", 0)) / 1e6
    return max((h2d if root_on_device else wall_ms) - d2h, 0.0)


def run_checked(native, label: str, phys, check, want, expect_hosted: list,
                must_launch, known_seen: list, known_k1=K1_CHECKED,
                collect=None) -> dict:
    """One query's checked first run on the card: the plan's host nodes
    against ``expect_hosted`` and its bridges (printed), the launch
    counters around the run alone with every K1-K4 launch recorded, the
    rows against the oracle, the kernels of ``must_launch`` launched, the
    rows and bytes each ``DeviceToHostExec`` downloads (printed), and
    every launch of a shape not in ``known_seen`` / ``known_k1`` held to
    its plain version bit for bit. ``collect(phys, ctx)`` runs the query
    (default ``phys.collect``). Returns the rows, ``first_s``,
    ``launches``, ``moved``, ``hosted``, ``seen`` (the recorded run),
    ``checks`` (the kernel checks made) and ``ctx``."""
    import torch
    from spark_rapids_tpu_torch.ops.base import ExecContext
    hosted = phys.host_fallback_nodes()
    if hosted != expect_hosted:
        raise AssertionError(f"{label} placed {hosted} on the host, "
                             f"expected {expect_hosted}")
    bridges = _bridges(phys.root)
    if bool(hosted) != bool(bridges):
        raise AssertionError(f"{label}: host nodes {hosted} but bridges "
                             f"{bridges}")
    log(f"{label}: host nodes {hosted}; root on the "
        f"{'device' if phys.root_on_device else 'host'}; bridges "
        + (", ".join(f"{type(b).__name__} under {p} over {c}"
                     for b, p, c in bridges) or "none"))
    native.reset_counters()
    seen, seen_k1 = {}, []
    ctx = ExecContext(phys.conf)
    with recording(native, seen), recording_k1(native, seen_k1):
        t0 = time.perf_counter()
        rows = (collect or type(phys).collect)(phys, ctx)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    launches = native.counters()
    check(rows, want)
    missing = [k for k in must_launch if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{label} launched no {missing}: {launches}")
    moved = [(ctx.metrics_for(b).values.get("downloadRows", 0),
              ctx.metrics_for(b).values.get("downloadBytes", 0))
             for b, _p, _c in bridges
             if type(b).__name__ == "DeviceToHostExec"]
    for r, nb in moved:
        log(f"  {label} DeviceToHostExec downloaded {int(r)} rows, "
            f"{int(nb)} B")
    first = first_run(seen, launches)
    checks = df_kernel_checks(native, {label: first}, known_seen) \
        + k1_checks(native, label, seen_k1, known_k1)
    return dict(rows=rows, first_s=first_s, launches=launches, moved=moved,
                hosted=hosted, seen=first, checks=checks, ctx=ctx)


def default_conf_phase(native, cols: dict, known_seen: list) -> dict:
    """q1-q6 through ``TpuSession()`` with no conf: float Sum/Avg
    aggregates run on the host engine between device subtrees. Each
    query's placement (host-tagged nodes, bridges, rows and bytes each
    download moves) is printed and checked; its first run is checked
    against the numpy oracle, with the launch counters around it alone
    and every K1-K4 launch recorded; new launch shapes are held to the
    plain versions. Then warm walls in turns beside the same query with
    ``variableFloatAgg`` on (the all-device tree), with the host
    engine's share of each default-conf wall."""
    import torch
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.ops.base import ExecContext
    t0 = time.perf_counter()
    session = TpuSession()
    tables = tpch.tpch_tables(session, cols)
    vsession = TpuSession({"spark.rapids.sql.variableFloatAgg.enabled": True})
    vtables = tpch.tpch_tables(vsession, cols)
    oracles = df_oracles(cols, E)
    log(f"default-conf phase: tables and oracles in "
        f"{time.perf_counter() - t0:.2f} s")
    out = {"kernel_checks": []}
    for q in DF_QUERIES:
        check, want = oracles[q]
        phys = tpch.QUERIES[q](session, tables[q])._physical()
        vphys = tpch.QUERIES[q](vsession, vtables[q])._physical()
        r = run_checked(native, f"{q} default conf", phys, check, want,
                        DEFAULT_HOST_NODES[q], DEFAULT_MUST_LAUNCH[q],
                        known_seen)
        first_s, launches = r["first_s"], r["launches"]
        out["kernel_checks"] += r["checks"]
        check(vphys.collect(), want)             # warms the all-device tree
        walls = {"default": [], "vfa": []}
        host = []
        for turn in range(DEFAULT_TURNS):
            for which in (("default", "vfa") if turn % 2 == 0
                          else ("vfa", "default")):
                p = phys if which == "default" else vphys
                c = ExecContext(p.conf)
                t0 = time.perf_counter()
                rows = p.collect(c)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                check(rows, want)
                walls[which].append(wall)
                if which == "default":
                    host.append(host_engine_ms(c, wall, p.root_on_device))
        med = {k: float(np.median(v)) for k, v in walls.items()}
        shown = {k: [round(w, 2) for w in v] for k, v in walls.items()}
        share = float(np.median([h / w for h, w in zip(
            host, walls["default"])]))
        log(f"{q} default conf matches the numpy oracle ({len(rows)} rows):"
            f" first run {first_s:.3f} s, warm {med['default']:.2f} ms "
            f"(median of {DEFAULT_TURNS}; {shown['default']}), host engine "
            f"{share * 100:.1f}% of it; all-device warm {med['vfa']:.2f} ms "
            f"({shown['vfa']}); "
            f"launches {launches}")
        out[q] = dict(first_s=first_s, warm_ms=med["default"],
                      vfa_warm_ms=med["vfa"], host_share=share,
                      launches=launches, moved=r["moved"],
                      hosted=r["hosted"], seen=r["seen"])
    return out


# ---------------------------------------------------------------------------
# Phase 13: TPCxBB q5 and TPC-H q7, q8, q9, q12, q14 and q19 (conditionals,
# IN lists, Divide and date parts) under both confs
# ---------------------------------------------------------------------------

def _years(days: np.ndarray) -> np.ndarray:
    """Calendar year of each day count (numpy's datetime64, not the
    port's arithmetic)."""
    return days.astype("datetime64[D]").astype("datetime64[Y]") \
        .astype(np.int64) + 1970


def _matrix_rows(m: np.ndarray, value: str) -> np.ndarray:
    """Rows of a zero-padded (n, w) uint8 string matrix equal to
    ``value``."""
    b = np.frombuffer(value.encode(), np.uint8)
    if len(b) > m.shape[1]:
        return np.zeros(len(m), bool)
    rest = m[:, len(b):]
    return np.all(m[:, :len(b)] == b, axis=1) & ~np.any(rest != 0, axis=1)


def _matrix_contains(m: np.ndarray, value: str) -> np.ndarray:
    b = np.frombuffer(value.encode(), np.uint8)
    hit = np.zeros(len(m), bool)
    for j in range(m.shape[1] - len(b) + 1):
        hit |= np.all(m[:, j:j + len(b)] == b, axis=1)
    return hit


def _group_sums(keys: list, *values) -> tuple:
    """(unique key rows, the sum of each value per key row): ``keys`` is a
    list of int arrays grouped together."""
    uniq, inv = np.unique(np.stack(keys, axis=1), axis=0,
                          return_inverse=True)
    inv = inv.reshape(-1)
    return uniq, [np.bincount(inv, weights=v, minlength=len(uniq))
                  for v in values]


def q7_oracle(cols: dict, E) -> list:
    """TPC-H Q7 in plain numpy: (supp_nation, cust_nation, l_year,
    revenue) of 1995-1996 lines shipped between FRANCE and GERMANY."""
    li, o, c, s = (cols["lineitem"], cols["orders"], cols["customer"],
                   cols["supplier"])
    names = [n for n, _ in E.NATIONS]
    fr, de = names.index("FRANCE"), names.index("GERMANY")
    m = (li["l_shipdate"] >= E.days("1995-01-01")) & (
        li["l_shipdate"] <= E.days("1996-12-31"))
    sn = s["s_nationkey"][li["l_suppkey"][m] - 1]
    cn = c["c_nationkey"][o["o_custkey"][li["l_orderkey"][m] - 1] - 1]
    keep = ((sn == fr) & (cn == de)) | ((sn == de) & (cn == fr))
    vol = (li["l_extendedprice"][m] * (1.0 - li["l_discount"][m]))[keep]
    yr = _years(li["l_shipdate"][m][keep])
    uniq, (rev,) = _group_sums([sn[keep], cn[keep], yr], vol)
    rows = [(names[a], names[b], int(y), float(r))
            for (a, b, y), r in zip(uniq, rev)]
    rows.sort(key=lambda r: r[:3])
    return rows


def q8_oracle(cols: dict, E) -> list:
    """TPC-H Q8 in plain numpy: (o_year, BRAZIL's share of the AMERICA
    customers' 1995-1996 volume of ECONOMY ANODIZED STEEL parts)."""
    li, o, c, s, p, n = (cols["lineitem"], cols["orders"],
                         cols["customer"], cols["supplier"], cols["part"],
                         cols["nation"])
    america = E.REGIONS.index("AMERICA")
    brazil = [nm for nm, _ in E.NATIONS].index("BRAZIL")
    part_ok = _matrix_rows(p["p_type"], "ECONOMY ANODIZED STEEL")
    cust_ok = n["n_regionkey"][c["c_nationkey"]] == america
    od = o["o_orderdate"]
    order_ok = (od >= E.days("1995-01-01")) & (od <= E.days("1996-12-31")) \
        & cust_ok[o["o_custkey"] - 1]
    oi = li["l_orderkey"] - 1
    m = part_ok[li["l_partkey"] - 1] & order_ok[oi]
    vol = li["l_extendedprice"][m] * (1.0 - li["l_discount"][m])
    is_br = s["s_nationkey"][li["l_suppkey"][m] - 1] == brazil
    uniq, (br, tot) = _group_sums([_years(od[oi[m]])],
                                  np.where(is_br, vol, 0.0), vol)
    return [(int(y), float(b / t)) for (y,), b, t in zip(uniq, br, tot)]


def q9_oracle(cols: dict, E) -> list:
    """TPC-H Q9 in plain numpy: (nation, o_year, sum_profit) of the lines
    of '%green%' parts, by nation asc and year desc."""
    li, o, s, p, ps = (cols["lineitem"], cols["orders"], cols["supplier"],
                       cols["part"], cols["partsupp"])
    names = [nm for nm, _ in E.NATIONS]
    m = _matrix_contains(p["p_name"], "green")[li["l_partkey"] - 1]
    pk, sk = li["l_partkey"][m], li["l_suppkey"][m]
    # Each line's supplier is one of its part's four partsupp rows.
    cand = (pk - 1)[:, None] * 4 + np.arange(4)[None, :]
    which = np.argmax(ps["ps_suppkey"][cand] == sk[:, None], axis=1)
    row = cand[np.arange(len(pk)), which]
    if not np.all(ps["ps_suppkey"][row] == sk):
        raise AssertionError("q9 oracle: a line's supplier is not one of "
                             "its part's")
    amount = li["l_extendedprice"][m] * (1.0 - li["l_discount"][m]) \
        - ps["ps_supplycost"][row] * li["l_quantity"][m]
    nat = s["s_nationkey"][sk - 1]
    yr = _years(o["o_orderdate"][li["l_orderkey"][m] - 1])
    uniq, (prof,) = _group_sums([nat, yr], amount)
    rows = [(names[a], int(y), float(v)) for (a, y), v in zip(uniq, prof)]
    rows.sort(key=lambda r: (r[0], -r[1]))
    return rows


def q12_oracle(cols: dict, E) -> list:
    """TPC-H Q12 in plain numpy: (l_shipmode, high_line_count,
    low_line_count) of the MAIL and SHIP lines received in 1994 late."""
    li, o = cols["lineitem"], cols["orders"]
    modes = [E.SHIPMODES.index(x) for x in ("MAIL", "SHIP")]
    r = li["l_receiptdate"]
    m = np.isin(li["l_shipmode"], modes) \
        & (li["l_commitdate"] < r) & (li["l_shipdate"] < li["l_commitdate"]) \
        & (r >= E.days("1994-01-01")) & (r < E.days("1995-01-01"))
    prio = o["o_orderpriority"][li["l_orderkey"][m] - 1]
    high = np.isin(prio, [E.PRIORITIES.index("1-URGENT"),
                          E.PRIORITIES.index("2-HIGH")])
    mode = li["l_shipmode"][m]
    rows = [(E.SHIPMODES[k], int(np.sum(high[mode == k])),
             int(np.sum(~high[mode == k]))) for k in np.unique(mode)]
    rows.sort()
    return rows


def q14_oracle(cols: dict, E) -> list:
    """TPC-H Q14 in plain numpy: one row, 100 x the PROMO parts' share of
    September 1995's revenue (NULL when no line shipped)."""
    li, p = cols["lineitem"], cols["part"]
    m = (li["l_shipdate"] >= E.days("1995-09-01")) & (
        li["l_shipdate"] < E.days("1995-10-01"))
    if not m.any():
        return [(None,)]
    rev = li["l_extendedprice"][m] * (1.0 - li["l_discount"][m])
    promo = _matrix_rows(p["p_type"][:, :5], "PROMO")[li["l_partkey"][m]
                                                      - 1]
    return [(float(np.sum(np.where(promo, rev, 0.0)) * 100.0
                   / np.sum(rev)),)]


Q19_BRANCHES = (("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"),
                 1.0, 11.0, 5),
                ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"),
                 10.0, 20.0, 10),
                ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"),
                 20.0, 30.0, 15))


def q19_oracle(cols: dict, E) -> list:
    """TPC-H Q19 in plain numpy: one row, the revenue of AIR / REG AIR
    lines delivered in person whose part meets one of three brand,
    container, quantity and size branches (NULL when none does)."""
    li, p = cols["lineitem"], cols["part"]
    m = np.isin(li["l_shipmode"], [E.SHIPMODES.index("AIR"),
                                   E.SHIPMODES.index("REG AIR")]) \
        & (li["l_shipinstruct"] == E.SHIPINSTRUCT.index("DELIVER IN PERSON"))
    pi = li["l_partkey"][m] - 1
    qty = li["l_quantity"][m]
    hit = np.zeros(len(pi), bool)
    for brand, conts, lo, hi, size in Q19_BRANCHES:
        cont = np.zeros(len(p["p_partkey"]), bool)
        for x in conts:
            cont |= _matrix_rows(p["p_container"], x)
        part_ok = _matrix_rows(p["p_brand"], brand) & cont & (
            p["p_size"] >= 1) & (p["p_size"] <= size)
        hit |= part_ok[pi] & (qty >= lo) & (qty <= hi)
    if not hit.any():
        return [(None,)]
    rev = li["l_extendedprice"][m][hit] * (1.0 - li["l_discount"][m][hit])
    return [(float(np.sum(rev)),)]


def xbb_q5_oracle(cols: dict, S) -> list:
    """TPCxBB q5 in plain numpy: per user with a click, (wcs_user_sk,
    clicks in Books, college education, male, clicks in category ids
    1-7); a multiset (the query has no order)."""
    w, it, c, cd = (cols["web_clickstreams"], cols["item"], cols["customer"],
                    cols["customer_demographics"])
    user = w["wcs_user_sk"]
    ok = ~np.ma.getmaskarray(user)
    u = np.ma.getdata(user)[ok]
    item = w["wcs_item_sk"][ok] - 1
    users, inv = np.unique(u, return_inverse=True)
    n = len(users)
    books = np.bincount(inv, weights=(it["i_category"][item]
                                      == S.CATEGORIES.index("Books")),
                        minlength=n)
    ids = [np.bincount(inv, weights=(it["i_category_id"][item] == i),
                       minlength=n) for i in range(1, 8)]
    demo = c["c_current_cdemo_sk"][users - 1] - 1
    college = np.isin(cd["cd_education_status"][demo],
                      [S.EDU.index(x) for x in (
                          "Advanced Degree", "College", "4 yr Degree",
                          "2 yr Degree")])
    male = cd["cd_gender"][demo] == S.GENDERS.index("M")
    cols_out = [users, books, college, male] + ids
    return [tuple(int(v[i]) for v in cols_out) for i in range(n)]


def check_rows(name: str, rows: list, want: list,
               multiset: bool = False, exact: bool = False) -> None:
    """Rows against an oracle: same count, keys, counts and order exact
    (``multiset``: the same rows in any order), floats within
    ORACLE_RTOL (``exact``: equal) and finite; a NULL only where the
    oracle has one."""
    if not want:
        raise AssertionError(f"{name} oracle is empty: nothing would be "
                             "checked")
    rows = [tuple(r) for r in rows]
    if multiset:
        rows, want = sorted(rows), sorted(want)
    if len(rows) != len(want):
        raise AssertionError(f"{name}: {len(rows)} rows, oracle "
                             f"{len(want)}; first {rows[:3]} vs {want[:3]}")
    for got, exp in zip(rows, want):
        if len(got) != len(exp):
            raise AssertionError(f"{name} row width differs: {got} vs {exp}")
        for a, b in zip(got, exp):
            if isinstance(b, float):
                if not isinstance(a, float) or not np.isfinite(a) or \
                        not (a == b if exact else np.isclose(
                            a, b, rtol=ORACLE_RTOL, atol=0.0)):
                    raise AssertionError(f"{name} differs: {got} vs {exp}")
            elif a != b or type(a) is not type(b):
                raise AssertionError(f"{name} differs: {got} vs {exp}")


MORE_TPCH = ("q7", "q8", "q9", "q12", "q14", "q19")
MORE_QUERIES = ("xbb_q5",) + MORE_TPCH
# The logical nodes the default conf places on the host (the float Sum
# aggregates), and the kernels each query must launch under both confs.
MORE_DEFAULT_HOST = {"xbb_q5": [], "q7": ["LogicalAggregate"],
                       "q8": ["LogicalAggregate"],
                       "q9": ["LogicalAggregate"], "q12": [],
                       "q14": ["LogicalAggregate"],
                       "q19": ["LogicalAggregate"]}
MORE_MUST_LAUNCH = {q: ("radix_sort",) for q in (
    "xbb_q5", "q7", "q8", "q9", "q12")}
MORE_WARM_RUNS = 2


def more_oracles(cols: dict, xcols: dict, E, S) -> dict:
    """chip_smoke.py's (check, expected rows) of each phase-13 query."""
    def check(name, multiset=False):
        return lambda rows, want: check_rows(name, rows, want, multiset)
    out = {"xbb_q5": (check("xbb_q5", multiset=True),
                      xbb_q5_oracle(xcols, S))}
    for q, oracle in (("q7", q7_oracle), ("q8", q8_oracle),
                      ("q9", q9_oracle), ("q12", q12_oracle),
                      ("q14", q14_oracle), ("q19", q19_oracle)):
        out[q] = (check(q), oracle(cols, E))
    return out


def more_queries_phase(native, cols: dict, known_seen: list,
                       known_k1: set) -> dict:
    """TPCxBB q5 (scale 1) and TPC-H q7, q8, q9, q12, q14 and q19 (SF1)
    through ``TpuSession()`` on the card, once with ``variableFloatAgg``
    on and once under the default conf. For each run: the plan's host
    nodes and bridges (checked against the reference's placement), the
    rows and bytes each ``DeviceToHostExec`` downloads, the first run
    (launch counters around it alone, every K1-K4 launch recorded) and
    ``MORE_WARM_RUNS`` warm runs, each checked against its numpy
    oracle. Every K1-K4 launch of a shape no earlier phase checked
    (``known_seen``: recorded K2-K4 first runs; ``known_k1``: K1 shapes)
    is held to the kernel's plain version bit for bit."""
    import torch
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import suites as S
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.ops.base import ExecContext
    t_phase = time.perf_counter()
    xcols = S.suite_columns(1.0, seed=0)
    oracles = more_oracles(cols, xcols, E, S)
    log(f"phase 13: TPCxBB scale 1 "
        f"({len(xcols['web_clickstreams']['wcs_item_sk'])} clickstream "
        f"rows) and oracles in {time.perf_counter() - t_phase:.2f} s")
    known_seen = list(known_seen)
    out = {"kernel_checks": []}
    for conf_name, conf in (("vfa", {
            "spark.rapids.sql.variableFloatAgg.enabled": True}),
            ("default", {})):
        session = TpuSession(conf)
        tables = dict(tpch.tpch_tables(session, cols, MORE_TPCH),
                      **S.suite_tables(session, xcols, ("xbb_q5",)))
        for q in MORE_QUERIES:
            check, want = oracles[q]
            run = S.QUERIES[q] if q in S.QUERIES else tpch.QUERIES[q]
            t0 = time.perf_counter()
            phys = run(session, tables[q])._physical()
            plan_ms = (time.perf_counter() - t0) * 1e3
            label = f"{q} ({conf_name})"
            r = run_checked(native, label, phys, check, want,
                            MORE_DEFAULT_HOST[q] if conf_name == "default"
                            else [], MORE_MUST_LAUNCH.get(q, ()),
                            known_seen, known_k1)
            known_seen.append(r["seen"])
            known_k1 |= {c["shape"] for c in r["checks"]
                         if c["kernel"] == "radix_sort"}
            out["kernel_checks"] += r["checks"]
            warm = []
            for _ in range(MORE_WARM_RUNS):
                t0 = time.perf_counter()
                rows = phys.collect(ExecContext(phys.conf))
                torch.cuda.synchronize()
                warm.append(time.perf_counter() - t0)
                check(rows, want)
            log(f"{label} matches the numpy oracle ({len(rows)} rows): "
                f"plan {plan_ms:.2f} ms, first run {r['first_s']:.3f} s, "
                f"warm {[round(w, 4) for w in warm]} s; launches "
                f"{r['launches']}")
            out[(q, conf_name)] = dict(
                plan_ms=plan_ms, first_s=r["first_s"], warm_s=warm,
                launches=r["launches"], moved=r["moved"],
                hosted=r["hosted"])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 13 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 14: TPC-DS q67, ds_q3, ds_q42, ds_q55, ds_q89 and ds_q98 (grouping
# sets and windows) under both confs
# ---------------------------------------------------------------------------

def _ds_joined(cols: dict, date_ok: np.ndarray, item_ok=None) -> tuple:
    """The store_sales rows whose date passes ``date_ok`` (and item
    ``item_ok``), as (date index, item index, row mask)."""
    ss = cols["store_sales"]
    d = ss["ss_sold_date_sk"] - 1
    i = ss["ss_item_sk"] - 1
    m = date_ok[d]
    if item_ok is not None:
        m &= item_ok[i]
    return d[m], i[m], m


def _mixed_key(parts: list, n: int) -> np.ndarray:
    """One int64 key for each of ``n`` rows from (small non-negative int
    column, its radix) pairs: 0 for every row when there are none."""
    key = np.zeros(n, np.int64)
    for v, radix in parts:
        key = key * radix + v
    return key


def _decode_key(key: np.ndarray, radixes: list) -> list:
    out = []
    for radix in reversed(radixes):
        out.append(key % radix)
        key = key // radix
    return out[::-1]


def q67_oracle(cols: dict, S) -> list:
    """TPC-DS q67 in plain numpy: the ROLLUP of sum(price * qty) over the
    eight keys (nine levels), rank() of sumsales descending within
    i_category (the grand total alone in the NULL partition), rk <= 100,
    the eight keys ascending nulls first, then sumsales and rk, first
    100 rows. Sums of whole numbers: exact."""
    dd, it, st = cols["date_dim"], cols["item"], cols["store"]
    ss = cols["store_sales"]
    ms = dd["d_month_seq"]
    d, i, m = _ds_joined(cols, (ms >= 1178) & (ms <= 1189))
    sales = ss["ss_sales_price"][m] * ss["ss_quantity"][m]
    store = ss["ss_store_sk"][m] - 1
    keys = [(it["i_category"][i], len(S.CATEGORIES)),
            (it["i_class"][i], len(S.CLASSES)),
            (it["i_brand"][i], len(S.BRANDS)),
            (it["i_product_name"][i], len(S.PRODUCTS)),
            (dd["d_year"][d] - 1998, 3), (dd["d_qoy"][d] - 1, 4),
            (dd["d_moy"][d] - 1, 12), (st["s_store_id"][store],
                                       len(st["s_store_id"]))]
    radixes = [r for _, r in keys]
    levels = []           # (level, decoded key columns, sums)
    for lvl in range(len(keys), -1, -1):
        key = _mixed_key(keys[:lvl], len(sales))
        uniq, inv = np.unique(key, return_inverse=True)
        sums = np.bincount(inv.reshape(-1), weights=sales,
                           minlength=len(uniq))
        levels.append((lvl, _decode_key(uniq, radixes[:lvl]), sums))
    n = sum(len(s) for _, _, s in levels)
    # Per output row: each key's value, or -1 for a rolled-up NULL.
    kv = np.full((len(keys), n), -1, np.int64)
    sumsales = np.empty(n)
    at = 0
    for lvl, dec, sums in levels:
        for k in range(lvl):
            kv[k, at:at + len(sums)] = dec[k]
        sumsales[at:at + len(sums)] = sums
        at += len(sums)
    # rank() over (partition by i_category order by sumsales desc).
    cat = kv[0]
    order = np.lexsort((-sumsales, cat))
    sc, sv = cat[order], sumsales[order]
    idx = np.arange(n)
    new_part = np.r_[True, sc[1:] != sc[:-1]]
    new_peer = new_part | np.r_[True, sv[1:] != sv[:-1]]
    rank_sorted = np.maximum.accumulate(np.where(new_peer, idx, 0)) - \
        np.maximum.accumulate(np.where(new_part, idx, 0)) + 1
    rk = np.empty(n, np.int64)
    rk[order] = rank_sorted
    keep = np.flatnonzero(rk <= 100)
    # ORDER BY the keys ascending, nulls first (a category by its name;
    # the other pools are in name order), then sumsales and rk.
    cat_rank = np.argsort(np.argsort(np.array(S.CATEGORIES)))
    sort_cols = [np.where(kv[0] < 0, -1, cat_rank[np.maximum(kv[0], 0)])] \
        + [kv[k] for k in range(1, len(keys))]
    sel = keep[np.lexsort(tuple([rk[keep], sumsales[keep]]
                                + [c[keep] for c in sort_cols[::-1]]))][:100]
    pools = (S.CATEGORIES, S.CLASSES, S.BRANDS, S.PRODUCTS)
    rows = []
    for r in sel.tolist():
        v = kv[:, r].tolist()
        row = [None if v[k] < 0 else pools[k][v[k]] for k in range(4)]
        row += [None if v[4] < 0 else v[4] + 1998,
                None if v[5] < 0 else v[5] + 1,
                None if v[6] < 0 else v[6] + 1,
                None if v[7] < 0 else S.STORE_IDS[v[7]]]
        rows.append(tuple(row) + (float(sumsales[r]), int(rk[r])))
    return rows


def _ds_group(keys: list, values: np.ndarray) -> tuple:
    """(unique key rows as columns, the sum of ``values`` per key row)."""
    uniq, sums = _group_sums(keys, values)
    return [uniq[:, k] for k in range(uniq.shape[1])], sums[0]


def ds_q3_oracle(cols: dict, S) -> list:
    """(d_year, i_brand, sum_agg) of November sales of category id 1,
    by year ascending, sum descending, brand ascending; first 100."""
    dd, it, ss = cols["date_dim"], cols["item"], cols["store_sales"]
    d, i, m = _ds_joined(cols, dd["d_moy"] == 11,
                         it["i_category_id"] == 1)
    (year, brand), s = _ds_group([dd["d_year"][d], it["i_brand"][i]],
                                 ss["ss_sales_price"][m])
    o = np.lexsort((brand, -s, year))[:100]
    return [(int(year[j]), S.BRANDS[brand[j]], float(s[j])) for j in o]


def ds_q42_oracle(cols: dict, S) -> list:
    """(d_year, d_qoy, i_category, revenue) of 1999, by revenue
    descending, then year, quarter and category name; first 100."""
    dd, it, ss = cols["date_dim"], cols["item"], cols["store_sales"]
    d, i, m = _ds_joined(cols, dd["d_year"] == 1999)
    (year, qoy, cat), s = _ds_group(
        [dd["d_year"][d], dd["d_qoy"][d], it["i_category"][i]],
        ss["ss_sales_price"][m])
    name = np.array(S.CATEGORIES)[cat]
    o = np.lexsort((name, qoy, year, -s))[:100]
    return [(int(year[j]), int(qoy[j]), str(name[j]), float(s[j]))
            for j in o]


def ds_q55_oracle(cols: dict, S) -> list:
    """(i_brand, ext_price) of December 1998, by revenue descending, then
    brand; first 100."""
    dd, it, ss = cols["date_dim"], cols["item"], cols["store_sales"]
    d, i, m = _ds_joined(cols, (dd["d_moy"] == 12) & (dd["d_year"] == 1998))
    (brand,), s = _ds_group([it["i_brand"][i]], ss["ss_sales_price"][m])
    o = np.lexsort((brand, -s))[:100]
    return [(S.BRANDS[brand[j]], float(s[j])) for j in o]


def ds_q89_oracle(cols: dict, S) -> list:
    """(i_category, i_class, d_moy, sum_sales, avg_monthly_sales) of
    1999: monthly class sales above 110% of the class's average month,
    by category name, class and month."""
    dd, it, ss = cols["date_dim"], cols["item"], cols["store_sales"]
    d, i, m = _ds_joined(cols, dd["d_year"] == 1999)
    (cat, cls, moy), s = _ds_group(
        [it["i_category"][i], it["i_class"][i], dd["d_moy"][d]],
        ss["ss_sales_price"][m])
    cc, inv = np.unique(np.stack([cat, cls], axis=1), axis=0,
                        return_inverse=True)
    inv = inv.reshape(-1)
    avg = (np.bincount(inv, weights=s) / np.bincount(inv))[inv]
    keep = (s - avg) / avg > 0.1
    name = np.array(S.CATEGORIES)[cat]
    o = [j for j in np.lexsort((moy, cls, name)) if keep[j]]
    return [(str(name[j]), S.CLASSES[cls[j]], int(moy[j]), float(s[j]),
             float(avg[j])) for j in o]


def ds_q98_oracle(cols: dict, S) -> list:
    """(i_category, i_class, itemrevenue, revenueratio) of 1999 for
    Books, Home and Sports: class revenue and its percent of the
    category's, by category name and class."""
    dd, it, ss = cols["date_dim"], cols["item"], cols["store_sales"]
    picked = np.isin(it["i_category"], [S.CATEGORIES.index(c) for c in (
        "Books", "Home", "Sports")])
    d, i, m = _ds_joined(cols, dd["d_year"] == 1999, picked)
    (cat, cls), s = _ds_group([it["i_category"][i], it["i_class"][i]],
                              ss["ss_sales_price"][m])
    total = np.bincount(cat, weights=s, minlength=len(S.CATEGORIES))[cat]
    ratio = s * 100.0 / total
    name = np.array(S.CATEGORIES)[cat]
    o = np.lexsort((cls, name))
    return [(str(name[j]), S.CLASSES[cls[j]], float(s[j]), float(ratio[j]))
            for j in o]


DS_QUERIES = ("q67", "ds_q3", "ds_q42", "ds_q55", "ds_q89", "ds_q98")
# Queries whose every number is a sum of whole numbers (exact on both
# engines); ds_q89's average and ds_q98's ratio are divisions.
DS_EXACT = ("q67", "ds_q3", "ds_q42", "ds_q55")
# Under the default conf the float Sum aggregate of each runs on the host
# engine (q67's ExpandExec with it); the window and the sort stay on the
# card.
DS_DEFAULT_HOST = {q: ["LogicalAggregate"] for q in DS_QUERIES}
DS_MUST_LAUNCH = dict({q: ("radix_sort",) for q in DS_QUERIES},
                      ds_q89=("radix_sort", "seg_reduce"),
                      ds_q98=("radix_sort", "seg_reduce"))
DS_WARM_RUNS = {("q67", "default"): 1}


def ds_oracles(cols: dict, S) -> dict:
    """chip_smoke.py's (check, expected rows) of each phase-14 query."""
    out = {}
    for q in DS_QUERIES:
        oracle = globals()[f"{q}_oracle"]
        out[q] = ((lambda q: lambda rows, want: check_rows(
            q, rows, want, exact=q in DS_EXACT))(q), oracle(cols, S))
    return out


def k1_time(native, keys, perm, label: str) -> dict:
    """One K1 launch shape timed: kernel, plain version and one PyTorch
    call for the same function (``torch.sort``, gathered through
    ``perm`` when there is one) in turns, beside the byte bound."""
    import torch
    r = dict(sort_bound(keys.numel(), keys.element_size(), perm is not None))
    fns = {"ms": lambda: native.stable_argsort_u32(keys, perm)}
    if perm is None:
        fns["library_ms"] = lambda: torch.sort(keys, stable=True)
    else:
        fns["library_ms"] = lambda: perm.index_select(0, torch.sort(
            keys.index_select(0, perm), stable=True).indices)
    r.update(turns_ms(fns, 10))
    r["plain_ms"] = cuda_ms(
        lambda: native.stable_argsort_u32_plain(keys, perm), 3, warmup=1)
    r["device_ms"] = device_ms(fns["ms"], 5)
    log(f"{label} K1 {k1_shape(keys, perm)}: kernel {r['ms']:.4f} ms "
        f"(device {r['device_ms']}), plain {r['plain_ms']:.4f} ms, "
        f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")
    return r


def ds_queries_phase(native, known_seen: list, known_k1: set) -> dict:
    """TPC-DS q67, ds_q3, ds_q42, ds_q55, ds_q89 and ds_q98 (scale 1)
    through ``TpuSession()`` on the card, once with ``variableFloatAgg``
    on and once under the default conf. For each run: the plan's host
    nodes and bridges, the rows and bytes each ``DeviceToHostExec``
    downloads, the first run (launch counters around it alone, every
    K1-K4 launch recorded) checked against its numpy oracle and the
    kernels it must launch, warm runs, and the peak device memory. Every
    K1-K4 launch of a shape no earlier phase checked is held to the
    kernel's plain version bit for bit; the largest new K1 shape (q67's
    window sort) is timed against its plain version and ``torch.sort``."""
    import torch
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import suites as S
    from spark_rapids_tpu_torch.ops.base import ExecContext
    t_phase = time.perf_counter()
    cols = S.suite_columns(1.0, seed=0)
    oracles = ds_oracles(cols, S)
    log(f"phase 14: TPC-DS scale 1 "
        f"({len(cols['store_sales']['ss_item_sk'])} store_sales rows) and "
        f"oracles in {time.perf_counter() - t_phase:.2f} s")
    known_seen = list(known_seen)
    known_k1 = set(known_k1)
    out = {"kernel_checks": []}
    new_k1 = {}
    for conf_name, conf in (("vfa", {
            "spark.rapids.sql.variableFloatAgg.enabled": True}),
            ("default", {})):
        session = TpuSession(conf)
        tables = S.suite_tables(session, cols, DS_QUERIES)
        for q in DS_QUERIES:
            check, want = oracles[q]
            t0 = time.perf_counter()
            phys = S.QUERIES[q](session, tables[q])._physical()
            plan_ms = (time.perf_counter() - t0) * 1e3
            label = f"{q} ({conf_name})"
            k1_calls = []
            with recording_k1(native, k1_calls):
                r = run_checked(native, label, phys, check, want,
                                DS_DEFAULT_HOST[q] if conf_name == "default"
                                else [], DS_MUST_LAUNCH[q], known_seen,
                                known_k1)
            for a in k1_calls:
                if k1_shape(*a) not in known_k1:
                    new_k1.setdefault(k1_shape(*a), a)
            del k1_calls
            known_seen.append(r["seen"])
            known_k1 |= {c["shape"] for c in r["checks"]
                         if c["kernel"] == "radix_sort"}
            out["kernel_checks"] += r["checks"]
            warm = []
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            for _ in range(DS_WARM_RUNS.get((q, conf_name), 2)):
                t0 = time.perf_counter()
                rows = phys.collect(ExecContext(phys.conf))
                torch.cuda.synchronize()
                warm.append(time.perf_counter() - t0)
                check(rows, want)
            peak = torch.cuda.max_memory_allocated()
            log(f"{label} matches the numpy oracle ({len(rows)} rows): "
                f"plan {plan_ms:.2f} ms, first run {r['first_s']:.3f} s, "
                f"warm {[round(w, 4) for w in warm]} s, peak device memory "
                f"in the warm runs {peak / 2**30:.3f} GiB ({held / 2**30:.3f}"
                f" GiB held before them); launches {r['launches']}")
            out[(q, conf_name)] = dict(
                plan_ms=plan_ms, first_s=r["first_s"], warm_s=warm,
                launches=r["launches"], moved=r["moved"],
                hosted=r["hosted"], peak_bytes=peak, held_bytes=held)
    if new_k1:
        keys, perm = new_k1[max(new_k1)]
        out["k1"] = k1_time(native, keys, perm, "phase 14 largest new")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 14 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 15: COUNT DISTINCT and LIKE (TPCxBB xbb_q12; TPC-H q10, q13, q16,
# q17, q18 and q21) under both confs
# ---------------------------------------------------------------------------

def _like_pool(pool, pattern: str) -> np.ndarray:
    """Which entries of a string pool match a LIKE pattern of ``%`` and
    ``_`` (no escapes), by Python's ``re``."""
    import re
    rx = re.compile("(?s)^" + "".join(
        ".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
        for ch in pattern) + "$")
    return np.array([rx.match(v) is not None for v in pool])


def q10_oracle(cols: dict, E) -> list:
    """TPC-H Q10 in plain numpy: returned-item revenue per customer of
    the orders of 1993Q4, the top 20 as (c_custkey, c_name, revenue,
    c_acctbal, n_name, c_address, c_phone, c_comment); a set (near-equal
    revenues may swap, as the reference's ``_SET_COMPARE`` allows)."""
    o, li, c = cols["orders"], cols["lineitem"], cols["customer"]
    om = (o["o_orderdate"] >= E.days("1993-10-01")) & \
        (o["o_orderdate"] < E.days("1994-01-01"))
    lm = (li["l_returnflag"] == ord("R")) & om[li["l_orderkey"] - 1]
    cust = o["o_custkey"][li["l_orderkey"][lm] - 1]
    rev = li["l_extendedprice"][lm] * (1.0 - li["l_discount"][lm])
    keys, inv = np.unique(cust, return_inverse=True)
    revenue = np.bincount(inv.reshape(-1), weights=rev)
    top = np.argsort(-revenue, kind="stable")[:20]
    ci = keys[top] - 1
    names, phones = _strings(c["c_name"][ci]), _strings(c["c_phone"][ci])
    nations = [nm for nm, _ in E.NATIONS]
    return [(int(keys[t]), names[i], float(revenue[t]),
             float(c["c_acctbal"][ci[i]]),
             nations[int(c["c_nationkey"][ci[i]])],
             E.O_COMMENTS[int(c["c_address"][ci[i]])], phones[i],
             E.O_COMMENTS[int(c["c_comment"][ci[i]])])
            for i, t in enumerate(top)]


def q13_oracle(cols: dict, E) -> list:
    """TPC-H Q13 in plain numpy: for each count of non-'special requests'
    orders a customer has (0 for a customer with none: the left join's
    NULL is not counted), how many customers have it; by custdist desc,
    c_count desc."""
    o, c = cols["orders"], cols["customer"]
    keep = ~_like_pool(E.O_COMMENTS, "%special%requests%")[o["o_comment"]]
    n_cust = len(c["c_custkey"])
    c_count = np.bincount(o["o_custkey"][keep], minlength=n_cust + 1)[
        c["c_custkey"]]
    counts, custdist = np.unique(c_count, return_counts=True)
    order = np.lexsort((-counts, -custdist))
    return [(int(counts[i]), int(custdist[i])) for i in order]


def q16_oracle(cols: dict, E) -> list:
    """TPC-H Q16 in plain numpy: distinct suppliers without complaints
    per (p_brand, p_type, p_size) of the chosen parts; by supplier_cnt
    desc, then brand, type and size."""
    p, ps, s = cols["part"], cols["partsupp"], cols["supplier"]
    bad = _like_pool(E.S_COMMENTS, "%Customer%Complaints%")[s["s_comment"]]
    brands, types = _strings(p["p_brand"]), _strings(p["p_type"])
    sizes = {49, 14, 23, 45, 19, 3, 36, 9}
    ok = np.array([b != "Brand#45" and not t.startswith("MEDIUM POLISHED")
                   and int(z) in sizes
                   for b, t, z in zip(brands, types, p["p_size"])])
    psm = ok[ps["ps_partkey"] - 1] & ~bad[ps["ps_suppkey"] - 1]
    groups: dict = {}
    for pk, sk in zip(ps["ps_partkey"][psm].tolist(),
                      ps["ps_suppkey"][psm].tolist()):
        i = pk - 1
        groups.setdefault((brands[i], types[i], int(p["p_size"][i])),
                          set()).add(sk)
    rows = [k + (len(v),) for k, v in groups.items()]
    rows.sort(key=lambda r: (-r[3], r[0], r[1], r[2]))
    return rows


def q17_oracle(cols: dict, E) -> list:
    """TPC-H Q17 in plain numpy: the yearly loss of the Brand#23 / MED BOX
    lines below a fifth of their part's average quantity (NULL when no
    line is)."""
    p, li = cols["part"], cols["lineitem"]
    pm = _matrix_rows(p["p_brand"], "Brand#23") & \
        _matrix_rows(p["p_container"], "MED BOX")
    lm = pm[li["l_partkey"] - 1]
    pk, qty = li["l_partkey"][lm], li["l_quantity"][lm]
    keys, inv = np.unique(pk, return_inverse=True)
    inv = inv.reshape(-1)
    avg = np.bincount(inv, weights=qty) / np.bincount(inv)
    small = qty < avg[inv] * 0.2
    if not small.any():
        return [(None,)]            # SUM of no rows is NULL
    return [(float(li["l_extendedprice"][lm][small].sum()) / 7.0,)]


def q18_oracle(cols: dict, E) -> list:
    """TPC-H Q18 in plain numpy: the orders whose lines hold more than 300
    units, as (c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
    sum_qty), by o_totalprice desc, o_orderdate, top 100."""
    o, li, c = cols["orders"], cols["lineitem"], cols["customer"]
    qty = np.bincount(li["l_orderkey"], weights=li["l_quantity"])
    big = np.flatnonzero(qty > 300.0)
    oi = big - 1
    order = np.lexsort((o["o_orderdate"][oi], -o["o_totalprice"][oi]))
    oi = oi[order][:100]
    ci = o["o_custkey"][oi] - 1
    names = _strings(c["c_name"][ci])
    return [(names[i], int(c["c_custkey"][ci[i]]),
             int(o["o_orderkey"][k]), int(o["o_orderdate"][k]),
             float(o["o_totalprice"][k]), float(qty[o["o_orderkey"][k]]))
            for i, k in enumerate(oi)]


def q21_oracle(cols: dict, E) -> list:
    """TPC-H Q21 in plain numpy: late lines of SAUDI ARABIA suppliers in
    fulfilled orders where another supplier shipped too and none of the
    others was late, counted per supplier; by numwait desc, s_name."""
    o, li, s = cols["orders"], cols["lineitem"], cols["supplier"]
    saudi = [nm for nm, _ in E.NATIONS].index("SAUDI ARABIA")
    key, supp = li["l_orderkey"], li["l_suppkey"]
    late = li["l_receiptdate"] > li["l_commitdate"]
    # Lines are contiguous per order: one segment each.
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    seg = np.cumsum(np.r_[True, key[1:] != key[:-1]]) - 1
    big = np.iinfo(np.int64).max
    lo = np.minimum.reduceat(supp, starts)[seg]
    hi = np.maximum.reduceat(supp, starts)[seg]
    late_lo = np.minimum.reduceat(np.where(late, supp, big), starts)[seg]
    late_hi = np.maximum.reduceat(np.where(late, supp, -1), starts)[seg]
    other = (lo != supp) | (hi != supp)
    other_late = (late_lo != supp) | (late_hi != supp)
    ok = late & (o["o_orderstatus"][key - 1] == ord("F")) & other & \
        ~other_late & (s["s_nationkey"][supp - 1] == saudi)
    counts = np.bincount(supp[ok], minlength=len(s["s_suppkey"]) + 1)
    names = _strings(s["s_name"])
    rows = [(names[k - 1], int(counts[k])) for k in np.flatnonzero(counts)]
    rows.sort(key=lambda r: (-r[1], r[0]))
    return rows[:100]


def xbb_q12_oracle(cols: dict, S) -> list:
    """TPCxBB q12 in plain numpy: distinct non-NULL users per item
    category, by category."""
    w, it = cols["web_clickstreams"], cols["item"]
    user = w["wcs_user_sk"]
    ok = ~np.ma.getmaskarray(user)
    cat = it["i_category"][w["wcs_item_sk"][ok] - 1]
    pairs = np.unique(np.stack([cat, np.ma.getdata(user)[ok]], axis=1),
                      axis=0)
    counts = np.bincount(pairs[:, 0], minlength=len(S.CATEGORIES))
    return sorted((S.CATEGORIES[i], int(n)) for i, n in enumerate(counts)
                  if n)


DISTINCT_TPCH = ("q10", "q13", "q16", "q17", "q18", "q21")
DISTINCT_QUERIES = ("xbb_q12",) + DISTINCT_TPCH
# Under the default conf the float Sum/Avg aggregates run on the host
# engine: q10's revenue sum, q17's average and sum, q18's two quantity
# sums. COUNT and COUNT DISTINCT stay on the card.
DISTINCT_DEFAULT_HOST = {"xbb_q12": [], "q10": ["LogicalAggregate"],
                         "q13": [], "q16": [],
                         "q17": ["LogicalAggregate", "LogicalAggregate"],
                         "q18": ["LogicalAggregate", "LogicalAggregate"],
                         "q21": []}
# Each query's group-by or sort on the card launches K1 under both confs,
# except q17 under the default conf, whose two aggregates are on the host
# and which has no sort; q13's left join and q21's self-joins probe builds
# with repeated keys (K3).
DISTINCT_MUST_LAUNCH = {
    (q, c): () if (q, c) == ("q17", "default") else
    ("radix_sort", "join_probe") if q in ("q13", "q21") else ("radix_sort",)
    for q in DISTINCT_QUERIES for c in ("vfa", "default")}
DISTINCT_WARM_RUNS = 2


def distinct_oracles(cols: dict, xcols: dict, E, S) -> dict:
    """chip_smoke.py's (check, expected rows) of each phase-15 query; q10
    as a set of rows."""
    out = {"xbb_q12": ((lambda rows, want: check_rows(
        "xbb_q12", rows, want)), xbb_q12_oracle(xcols, S))}
    for q in DISTINCT_TPCH:
        out[q] = ((lambda q: lambda rows, want: check_rows(
            q, rows, want, multiset=q == "q10"))(q),
            globals()[f"{q}_oracle"](cols, E))
    return out


def distinct_queries_phase(native, cols: dict, known_seen: list,
                           known_k1: set) -> dict:
    """TPCxBB xbb_q12 (scale 1) and TPC-H q10, q13, q16, q17, q18 and q21
    (SF1) through ``TpuSession()`` on the card, once with
    ``variableFloatAgg`` on and once under the default conf. For each
    run: the plan's host nodes and bridges, the rows and bytes each
    ``DeviceToHostExec`` downloads, the first run (launch counters around
    it alone, every K1-K4 launch recorded) checked against its numpy
    oracle and the kernels it must launch, ``DISTINCT_WARM_RUNS`` warm
    runs, each checked, and the peak device memory of the warm runs.
    Every K1-K4 launch of a shape no earlier phase checked is held to the
    kernel's plain version bit for bit."""
    import torch
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import suites as S
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.ops.base import ExecContext
    t_phase = time.perf_counter()
    xcols = S.suite_columns(1.0, seed=0)
    oracles = distinct_oracles(cols, xcols, E, S)
    log(f"phase 15: oracles in {time.perf_counter() - t_phase:.2f} s")
    known_seen = list(known_seen)
    known_k1 = set(known_k1)
    out = {"kernel_checks": []}
    for conf_name, conf in (("vfa", {
            "spark.rapids.sql.variableFloatAgg.enabled": True}),
            ("default", {})):
        session = TpuSession(conf)
        tables = dict(tpch.tpch_tables(session, cols, DISTINCT_TPCH),
                      **S.suite_tables(session, xcols, ("xbb_q12",)))
        for q in DISTINCT_QUERIES:
            check, want = oracles[q]
            run = S.QUERIES[q] if q in S.QUERIES else tpch.QUERIES[q]
            t0 = time.perf_counter()
            phys = run(session, tables[q])._physical()
            plan_ms = (time.perf_counter() - t0) * 1e3
            label = f"{q} ({conf_name})"
            r = run_checked(native, label, phys, check, want,
                            DISTINCT_DEFAULT_HOST[q]
                            if conf_name == "default" else [],
                            DISTINCT_MUST_LAUNCH[q, conf_name], known_seen,
                            known_k1)
            known_seen.append(r["seen"])
            known_k1 |= {c["shape"] for c in r["checks"]
                         if c["kernel"] == "radix_sort"}
            out["kernel_checks"] += r["checks"]
            warm = []
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            for _ in range(DISTINCT_WARM_RUNS):
                t0 = time.perf_counter()
                rows = phys.collect(ExecContext(phys.conf))
                torch.cuda.synchronize()
                warm.append(time.perf_counter() - t0)
                check(rows, want)
            peak = torch.cuda.max_memory_allocated()
            log(f"{label} matches the numpy oracle ({len(rows)} rows): "
                f"plan {plan_ms:.2f} ms, first run {r['first_s']:.3f} s, "
                f"warm {[round(w, 4) for w in warm]} s, peak device memory "
                f"in the warm runs {peak / 2**30:.3f} GiB ({held / 2**30:.3f}"
                f" GiB held before them); launches {r['launches']}")
            out[(q, conf_name)] = dict(
                plan_ms=plan_ms, first_s=r["first_s"], warm_s=warm,
                launches=r["launches"], moved=r["moved"],
                hosted=r["hosted"], peak_bytes=peak, held_bytes=held)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 15 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 16: the shuffle exchange, the shuffled and nested-loop joins,
# Substring and the fixed-width Cast
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mix_k1(k1):
    k1 = (k1 * 0xCC9E2D51) & _M32
    k1 = ((k1 << 15) | (k1 >> 17)) & _M32
    return (k1 * 0x1B873593) & _M32


def _mix_h1(h1, k1):
    h1 ^= k1
    h1 = ((h1 << 13) | (h1 >> 19)) & _M32
    return (h1 * 5 + 0xE6546B64) & _M32


def murmur3_long(v: np.ndarray, seed: int = 42) -> np.ndarray:
    """Spark's murmur3 (Murmur3_x86_32.hashLong) of int64 values with
    ``seed``, as int32, in numpy uint64 lanes masked to 32 bits."""
    u = v.astype(np.int64).view(np.uint64)
    h = np.full(len(u), seed, np.uint64)
    h = _mix_h1(h, _mix_k1(u & np.uint64(_M32)))
    h = _mix_h1(h, _mix_k1(u >> np.uint64(32)))
    h ^= np.uint64(8)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & np.uint64(_M32)
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & np.uint64(_M32)
    h ^= h >> np.uint64(16)
    return h.astype(np.uint32).view(np.int32)


def repart_buckets(keys: np.ndarray, n: int) -> np.ndarray:
    """pmod(murmur3(key), n) of each key."""
    return np.mod(murmur3_long(keys).astype(np.int64), n)


def repart_oracle(cols: dict, S) -> list:
    """repart in plain numpy: rows per hash bucket of wcs_item_sk."""
    key = np.ma.getdata(cols["web_clickstreams"]["wcs_item_sk"])
    counts = np.bincount(repart_buckets(key, S.REPART_N),
                         minlength=S.REPART_N)
    return [(b, int(c)) for b, c in enumerate(counts) if c]


def _nation(E, name: str) -> int:
    return [nm for nm, _ in E.NATIONS].index(name)


def q11_oracle(cols: dict, E) -> list:
    """TPC-H Q11 in plain numpy: the stock value of each part held by
    GERMANY's suppliers above 0.0001 of the total, by value desc (a set:
    near-equal values may swap, as the reference's ``_SET_COMPARE``
    allows)."""
    ps, s = cols["partsupp"], cols["supplier"]
    ger = s["s_nationkey"] == _nation(E, "GERMANY")
    keep = ger[ps["ps_suppkey"] - 1]
    value = ps["ps_supplycost"][keep] * ps["ps_availqty"][keep]
    total = value.sum()
    keys, inv = np.unique(ps["ps_partkey"][keep], return_inverse=True)
    sums = np.bincount(inv.reshape(-1), weights=value)
    hit = sums > total * 0.0001
    order = np.argsort(-sums[hit], kind="stable")
    return [(int(k), float(v)) for k, v in
            zip(keys[hit][order], sums[hit][order])]


def q15_oracle(cols: dict, E) -> list:
    """TPC-H Q15 in plain numpy: the supplier(s) of the largest revenue
    shipped in 1996Q1, by s_suppkey."""
    li, s = cols["lineitem"], cols["supplier"]
    m = (li["l_shipdate"] >= E.days("1996-01-01")) & \
        (li["l_shipdate"] < E.days("1996-04-01"))
    rev = li["l_extendedprice"][m] * (1.0 - li["l_discount"][m])
    keys, inv = np.unique(li["l_suppkey"][m], return_inverse=True)
    sums = np.bincount(inv.reshape(-1), weights=rev)
    top = np.flatnonzero(sums == sums.max())
    si = keys[top] - 1
    names, phones = _strings(s["s_name"][si]), _strings(s["s_phone"][si])
    return [(int(keys[t]), names[i], E.S_COMMENTS[int(s["s_address"][
        si[i]])], phones[i], float(sums[t])) for i, t in enumerate(top)]


def q20_oracle(cols: dict, E) -> list:
    """TPC-H Q20 in plain numpy: CANADA's suppliers of 'forest' parts
    whose stock exceeds half the quantity they shipped in 1994, by
    s_name."""
    p, li, ps, s = (cols["part"], cols["lineitem"], cols["partsupp"],
                    cols["supplier"])
    b = np.frombuffer(b"forest", np.uint8)
    forest = np.all(p["p_name"][:, :len(b)] == b, axis=1)
    m = (li["l_shipdate"] >= E.days("1994-01-01")) & \
        (li["l_shipdate"] < E.days("1995-01-01"))
    pair, sums = _group_sums([li["l_partkey"][m], li["l_suppkey"][m]],
                             li["l_quantity"][m])
    sums = sums[0]
    code = pair[:, 0] * (1 << 32) + pair[:, 1]
    order = np.argsort(code)
    ps_code = ps["ps_partkey"] * (1 << 32) + ps["ps_suppkey"]
    pos = np.clip(np.searchsorted(code[order], ps_code), 0,
                  max(len(code) - 1, 0))
    found = code[order][pos] == ps_code
    qty = sums[order][pos]
    ok = forest[ps["ps_partkey"] - 1] & found & \
        (ps["ps_availqty"].astype(np.float64) > qty * 0.5)
    supp = np.unique(ps["ps_suppkey"][ok])
    canada = s["s_nationkey"][supp - 1] == _nation(E, "CANADA")
    names = _strings(s["s_name"][supp[canada] - 1])
    return sorted((nm, E.S_COMMENTS[int(s["s_address"][k - 1])])
                  for nm, k in zip(names, supp[canada]))


def q22_oracle(cols: dict, E) -> list:
    """TPC-H Q22 in plain numpy: customers of seven phone country codes
    with an above-average positive balance and no orders, counted and
    summed per code, by code."""
    c, o = cols["customer"], cols["orders"]
    cc = (c["c_phone"][:, 0].astype(np.int64) - 48) * 10 + \
        (c["c_phone"][:, 1].astype(np.int64) - 48)
    sel = np.isin(cc, [13, 31, 23, 29, 30, 18, 17])
    bal = c["c_acctbal"]
    avg = bal[sel & (bal > 0.0)].mean()
    has_order = np.zeros(len(bal) + 1, bool)
    has_order[o["o_custkey"]] = True
    ok = sel & (bal > avg) & ~has_order[c["c_custkey"]]
    codes, inv = np.unique(cc[ok], return_inverse=True)
    inv = inv.reshape(-1)
    counts = np.bincount(inv, minlength=len(codes))
    sums = np.bincount(inv, weights=bal[ok], minlength=len(codes))
    return [(f"{int(k):02d}", int(n), float(t))
            for k, n, t in zip(codes, counts, sums)]


LAST_TPCH = ("q11", "q15", "q20", "q22")
LAST_QUERIES = ("repart",) + LAST_TPCH
# Under the default conf the float Sum/Avg aggregates run on the host
# engine: q11's total and per-part sums, q15's revenue sum (twice: the
# plan reads it on both sides of the cross join), q20's quantity sum,
# q22's average and its final sum. repart counts, on the card.
LAST_DEFAULT_HOST = {
    "repart": [], "q11": ["LogicalAggregate", "LogicalAggregate"],
    "q15": ["LogicalAggregate", "LogicalAggregate"],
    "q20": ["LogicalAggregate"],
    "q22": ["LogicalAggregate", "LogicalAggregate"]}
# repart's 16-way exchange sorts by partition id (K1) under both confs;
# each other query sorts its output on the card.
LAST_MUST_LAUNCH = {(q, c): ("radix_sort",) for q in LAST_QUERIES
                    for c in ("vfa", "default")}
# The 8-partition runs, each held to its oracle and to its one-partition
# run; the shuffled joins of q4, q13 and q21 probe builds with repeated
# keys, so K3 launches there.
SHUFFLED = ("q1", "q4", "q13", "q18", "q21", "xbb_q12", "ds_q89")
SHUFFLED_MUST_LAUNCH = dict(
    {q: ("radix_sort",) for q in SHUFFLED},
    q4=("radix_sort", "join_probe"), q13=("radix_sort", "join_probe"),
    q21=("radix_sort", "join_probe"), ds_q89=("radix_sort", "seg_reduce"))
SHUFFLE_PARTITIONS = 8
LAST_WARM_RUNS = 2


def last_oracles(cols: dict, xcols: dict, E, S) -> dict:
    """chip_smoke.py's (check, expected rows) of each phase-16 query;
    q11 as a set of rows."""
    out = {"repart": ((lambda rows, want: check_rows(
        "repart", rows, want)), repart_oracle(xcols, S))}
    for q in LAST_TPCH:
        out[q] = ((lambda q: lambda rows, want: check_rows(
            q, rows, want, multiset=q == "q11"))(q),
            globals()[f"{q}_oracle"](cols, E))
    return out


def full_join_frames(session, cols: dict, E, L):
    """CUSTOMER (with c_acctbal > 0) full outer join ORDERS on the
    customer key, as the count of its matched, left-only and right-only
    rows (kind 0, 1 and 2)."""
    from spark_rapids_tpu_torch.api import DataFrame
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    cschema = (("c_custkey", dt.INT64), ("c_acctbal", dt.FLOAT64))
    oschema = (("o_orderkey", dt.INT64), ("o_custkey", dt.INT64))
    cust = DataFrame(session, L.InMemoryScan(cschema, E.table_partitions(
        cols["customer"], cschema, E.TABLE_PARTITIONS["customer"])))
    orders = DataFrame(session, L.InMemoryScan(oschema, E.table_partitions(
        cols["orders"], oschema, E.TABLE_PARTITIONS["orders"])))
    j = cust.filter(L.col("c_acctbal") > 0.0).join_on(
        orders, ["c_custkey"], ["o_custkey"], how="full")
    kind = L.when(L.col("c_custkey").isNull(), 2) \
        .when(L.col("o_orderkey").isNull(), 1).otherwise(0)
    return j.group_by(kind.alias("kind")).agg(
        L.agg_count().alias("n")).order_by("kind")


def full_join_oracle(cols: dict) -> list:
    c, o = cols["customer"], cols["orders"]
    keep = np.zeros(len(c["c_custkey"]) + 1, bool)
    keep[c["c_custkey"][c["c_acctbal"] > 0.0]] = True
    matched = int(keep[o["o_custkey"]].sum())
    has_order = np.zeros_like(keep)
    has_order[o["o_custkey"]] = True
    left_only = int((keep & ~has_order).sum())
    right_only = len(o["o_custkey"]) - matched
    return [(k, n) for k, n in enumerate((matched, left_only, right_only))
            if n]


def _warm(phys, check, want, runs: int) -> tuple:
    """Warm walls of ``runs`` checked runs and their peak device memory
    (bytes, and bytes held before them)."""
    import torch
    from spark_rapids_tpu_torch.ops.base import ExecContext
    warm = []
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for _ in range(runs):
        t0 = time.perf_counter()
        rows = phys.collect(ExecContext(phys.conf))
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        check(rows, want)
    return warm, torch.cuda.max_memory_allocated(), held


def _exchanges(e, out=None) -> list:
    out = [] if out is None else out
    if type(e).__name__ == "ShuffleExchangeExec":
        out.append(e)
    for c in e.children:
        _exchanges(c, out)
    return out


def repart_direct(phys, S) -> int:
    """Run repart's repartition exchange alone: every row of output
    partition p must hash to p, and every row must arrive once."""
    from spark_rapids_tpu_torch.columnar.host import download_batches
    from spark_rapids_tpu_torch.ops.base import ExecContext
    ex = next(e for e in _exchanges(phys.root)
              if e.partitioning.num_partitions == S.REPART_N)
    ctx = ExecContext(phys.conf)
    ctx.cache["engine"] = "device"
    total = 0
    for p in range(ex.num_partitions(ctx)):
        hbs = download_batches(list(ex.execute_device(ctx, p)))
        keys = np.concatenate([hb.columns[0].data for hb in hbs]) if hbs \
            else np.zeros(0, np.int64)
        bad = int((repart_buckets(keys, S.REPART_N) != p).sum())
        if bad:
            raise AssertionError(f"repart partition {p}: {bad} rows hash "
                                 "to another partition")
        total += len(keys)
    log(f"repart exchange alone: {ex.num_partitions(ctx)} partitions, "
        f"{total} rows, every row in the partition its key hashes to")
    return total


def exchange_phase(native, cols: dict, known_seen: list,
                   known_k1: set) -> dict:
    """(a) repart and (b) TPC-H q11, q15, q20 and q22 through
    ``TpuSession`` on the card under ``variableFloatAgg`` and under the
    default conf, against numpy oracles; (c) q1, q4, q13, q18, q21,
    xbb_q12 and ds_q89 at ``shuffle.partitions=8`` against their oracles
    and their one-partition runs; (d) a full outer join of CUSTOMER and
    ORDERS at one and eight partitions against numpy counts. For each
    run: host nodes and bridges, rows downloaded, the first run with
    every K1-K4 launch recorded (new shapes against the plain versions),
    two warm walls and the peak device memory of the warm runs."""
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import suites as S
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.plan import logical as L
    t_phase = time.perf_counter()
    xcols = S.suite_columns(1.0, seed=0)
    n_clicks = len(xcols["web_clickstreams"]["wcs_item_sk"])
    oracles = last_oracles(cols, xcols, E, S)
    oracles.update({q: v for q, v in df_oracles(cols, E).items()
                    if q in SHUFFLED})
    oracles.update({q: v for q, v in distinct_oracles(
        cols, xcols, E, S).items() if q in SHUFFLED})
    oracles["ds_q89"] = ds_oracles(xcols, S)["ds_q89"]
    fj_want = full_join_oracle(cols)
    oracles["full_join"] = ((lambda rows, want: check_rows(
        "full_join", rows, want)), fj_want)
    log(f"phase 16: oracles in {time.perf_counter() - t_phase:.2f} s")
    known_seen = list(known_seen)
    known_k1 = set(known_k1)
    out = {"kernel_checks": []}

    def run(label, phys, q, hosted, must, warm_runs=LAST_WARM_RUNS):
        check, want = oracles[q]
        r = run_checked(native, label, phys, check, want, hosted, must,
                        known_seen, known_k1)
        known_seen.append(r["seen"])
        known_k1.update(c["shape"] for c in r["checks"]
                        if c["kernel"] == "radix_sort")
        out["kernel_checks"] += r["checks"]
        warm, peak, held = _warm(phys, check, want, warm_runs)
        log(f"{label} matches the numpy oracle ({len(r['rows'])} rows): "
            f"first run {r['first_s']:.3f} s, warm "
            f"{[round(w, 4) for w in warm]} s, peak device memory in the "
            f"warm runs {peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB "
            f"held before them); launches {r['launches']}")
        out[label] = dict(first_s=r["first_s"], warm_s=warm,
                          launches=r["launches"], moved=r["moved"],
                          hosted=r["hosted"], peak_bytes=peak,
                          held_bytes=held)
        return r["rows"]

    # (a) and (b): repart and q11, q15, q20, q22 under both confs.
    for conf_name, conf in (("vfa", {
            "spark.rapids.sql.variableFloatAgg.enabled": True}),
            ("default", {})):
        session = TpuSession(conf)
        tables = dict(tpch.tpch_tables(session, cols, LAST_TPCH),
                      **S.suite_tables(session, xcols, ("repart",)))
        for q in LAST_QUERIES:
            fn = S.QUERIES[q] if q in S.QUERIES else tpch.QUERIES[q]
            phys = fn(session, tables[q])._physical()
            rows = run(f"{q} ({conf_name})", phys, q,
                       LAST_DEFAULT_HOST[q] if conf_name == "default"
                       else [], LAST_MUST_LAUNCH[q, conf_name])
            if q == "repart":
                if sum(n for _b, n in rows) != n_clicks:
                    raise AssertionError(f"repart counted {rows}, not "
                                         f"{n_clicks} rows")
                if repart_direct(phys, S) != n_clicks:
                    raise AssertionError("repart's exchange lost rows")

    # (c): the 8-partition runs against their one-partition runs.
    vfa = {"spark.rapids.sql.variableFloatAgg.enabled": True}
    by_n = {}
    for n in (1, SHUFFLE_PARTITIONS):
        session = TpuSession(dict(
            vfa, **{"spark.rapids.sql.shuffle.partitions": n}))
        tables = dict(tpch.tpch_tables(session, cols, [
            q for q in SHUFFLED if q in tpch.QUERIES]),
            **S.suite_tables(session, xcols, ("xbb_q12", "ds_q89")))
        for q in SHUFFLED:
            fn = S.QUERIES[q] if q in S.QUERIES else tpch.QUERIES[q]
            phys = fn(session, tables[q])._physical()
            if n == 1:
                by_n[q] = phys.collect()
                continue
            rows = run(f"{q} ({n} partitions)", phys, q, [],
                       SHUFFLED_MUST_LAUNCH[q])
            if not rows_close(rows, by_n[q]):
                raise AssertionError(f"{q} at {n} partitions differs from "
                                     "its one-partition run")
        if n != 1:
            log(f"{', '.join(SHUFFLED)} at {n} partitions equal their "
                "one-partition runs")

    # (d): a full outer join at one and eight partitions.
    for n in (1, SHUFFLE_PARTITIONS):
        session = TpuSession(dict(
            vfa, **{"spark.rapids.sql.shuffle.partitions": n}))
        phys = full_join_frames(session, cols, E, L)._physical()
        run(f"full outer join ({n} partitions)", phys, "full_join", [],
            ("radix_sort", "join_probe"))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 16 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 18: the memory tier and out-of-core execution
# ---------------------------------------------------------------------------

OOC_WARM_RUNS = 2
# (a): a device budget far below the sort's staged bytes (so at least four
# range buckets) and a host tier below them too (so entries reach disk).
SORT_BUDGET = 128 << 20
SORT_HOST_BYTES = 160 << 20
SORT_KEYS = ("l_suppkey", "l_partkey", "l_orderkey", "l_linenumber")
# (e): shares of the memory q18's uncapped one-partition run reserves
# above its start that the process may reserve, tried in turn until one
# raises a real OOM. Near the peak the overshoot is small, so spilling the
# catalog's exchange pieces covers it; far below it (0.6 and under, on an
# H100 80GB HBM3) the ladder can run out, and the run then fails.
OOM_SHARES = (0.9, 0.8, 0.7)
_BUDGET_KEY = "spark.rapids.memory.tpu.budgetBytes"
_HOST_KEY = "spark.rapids.memory.host.spillStorageSize"


def lineitem_with_linenumber(cols: dict) -> dict:
    """Every LINEITEM row's key, part, supplier and price, with its
    ``l_linenumber`` (the line's position in its order, from 1:
    (l_orderkey, l_linenumber) is the table's primary key; the generator
    keeps an order's lines together)."""
    li = cols["lineitem"]
    key = li["l_orderkey"]
    n = len(key)
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    line = (np.arange(n) - np.repeat(starts, np.diff(np.r_[starts, n]))
            + 1).astype(np.int32)
    return {"l_orderkey": key, "l_linenumber": line,
            "l_partkey": li["l_partkey"], "l_suppkey": li["l_suppkey"],
            "l_extendedprice": li["l_extendedprice"]}


def lineitem_sort_frame(session, tcols: dict, E, L):
    """``tcols`` in LINEITEM's eight partitions, ordered by supplier,
    part, order and line."""
    from spark_rapids_tpu_torch.api import DataFrame
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    schema = (("l_orderkey", dt.INT64), ("l_linenumber", dt.INT32),
              ("l_partkey", dt.INT64), ("l_suppkey", dt.INT64),
              ("l_extendedprice", dt.FLOAT64))
    df = DataFrame(session, L.InMemoryScan(schema, E.table_partitions(
        tcols, schema, E.TABLE_PARTITIONS["lineitem"])))
    return df.order_by(*SORT_KEYS)


def sort_oracle(tcols: dict) -> dict:
    """The sorted columns by ``np.lexsort``, after a check that the sort
    key is unique (so the order is fully determined)."""
    pk = tcols["l_orderkey"] * 8 + tcols["l_linenumber"]
    if len(np.unique(pk)) != len(pk):
        raise AssertionError("(l_orderkey, l_linenumber) is not unique")
    order = np.lexsort(tuple(tcols[k] for k in reversed(SORT_KEYS)))
    return {k: v[order] for k, v in tcols.items()}


def check_sorted(hbs: list, want: dict) -> None:
    """Downloaded host batches against the numpy sort, column by column,
    bit for bit, with no NULL."""
    n = len(want["l_orderkey"])
    got_n = sum(hb.num_rows for hb in hbs)
    if got_n != n:
        raise AssertionError(f"sort returned {got_n} rows, not {n}")
    for ci, name in enumerate(hbs[0].names):
        data = np.concatenate([np.asarray(hb.columns[ci].data)
                               for hb in hbs])
        valid = np.concatenate([np.asarray(hb.columns[ci].validity)
                                for hb in hbs])
        if not valid.all() or data.tobytes() != want[name].tobytes():
            raise AssertionError(f"sorted column {name} differs from "
                                 "np.lexsort's")


def ooc_counts(ctx) -> dict:
    """One run's out-of-core and recovery counts: operator metrics summed
    over operators (the Recovery@query entry apart), the window's staged
    bytes, each shuffled join's build bytes, and the catalog's counters."""
    ops, window_staged, builds = {}, 0, []
    for key, m in ctx.metrics.items():
        if key == "Recovery@query":
            continue
        for k in ("outOfCoreBuckets", "stagedBytes", "graceJoinPartitions",
                  "graceJoinBuildBuckets"):
            if k in m.values:
                ops[k] = ops.get(k, 0) + int(m.values[k])
        if m.owner == "WindowExec":
            window_staged += int(m.values.get("stagedBytes", 0))
        if "buildBytes" in m.values:
            builds.append(int(m.values["buildBytes"]))
    rec = ctx.metrics.get("Recovery@query")
    return dict(ops=ops, window_staged=window_staged, builds=builds,
                recovery={k: int(v) for k, v in rec.values.items()}
                if rec is not None else {},
                catalog=dict(ctx.last_spill_metrics or {}))


def check_teardown(label: str, ctx) -> dict:
    """No leak in one run; its counts."""
    if ctx.last_leak_report != []:
        raise AssertionError(f"{label}: leak report {ctx.last_leak_report}")
    return ooc_counts(ctx)


def ooc_runs(native, label: str, phys, check, want, must, known_seen: list,
             known_k1: set, collect=None) -> dict:
    """A checked first run (every K1-K4 launch recorded, new shapes held
    to the plain versions) and ``OOC_WARM_RUNS`` checked warm runs, with
    the peak device memory of the warm runs and each run's teardown
    checked."""
    import torch
    from spark_rapids_tpu_torch.ops.base import ExecContext
    collect = collect or type(phys).collect
    r = run_checked(native, label, phys, check, want, [], must, known_seen,
                    known_k1, collect=collect)
    known_seen.append(r["seen"])
    known_k1.update(c["shape"] for c in r["checks"]
                    if c["kernel"] == "radix_sort")
    counts = check_teardown(label, r["ctx"])
    recovery = dict(counts["recovery"])
    warm = []
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for _ in range(OOC_WARM_RUNS):
        ctx = ExecContext(phys.conf)
        t0 = time.perf_counter()
        rows = collect(phys, ctx)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        check(rows, want)
        add_counts(recovery, check_teardown(label, ctx)["recovery"])
        del rows
    peak = torch.cuda.max_memory_allocated()
    rows = r["rows"]
    n_rows = sum(hb.num_rows for hb in rows) \
        if rows and hasattr(rows[0], "num_rows") else len(rows)
    return dict(rows=rows, n_rows=n_rows, first_s=r["first_s"], warm_s=warm,
                launches=r["launches"], checks=r["checks"], counts=counts,
                recovery=recovery, peak_bytes=peak, held_bytes=held)


def add_counts(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def log_pair(label: str, budget: int, inc: dict, ooc: dict, note: str = ""):
    c = ooc["counts"]
    cat = c["catalog"]
    ratio = (cat.get("disk_bytes_raw", 0) /
             max(cat.get("disk_bytes_stored", 0), 1))
    log(f"{label} under budgetBytes={budget} ({budget / 2**20:.1f} MiB)"
        f"{note}: {ooc['n_rows']} rows checked in each run (in core "
        f"{inc['n_rows']}); first {ooc['first_s']:.3f} s, warm "
        f"{[round(w, 4) for w in ooc['warm_s']]} s (in core: first "
        f"{inc['first_s']:.3f} s, warm {[round(w, 4) for w in inc['warm_s']]}"
        f" s); peak device memory {ooc['peak_bytes'] / 2**30:.3f} GiB (in "
        f"core {inc['peak_bytes'] / 2**30:.3f} GiB; held before "
        f"{ooc['held_bytes'] / 2**30:.3f} / {inc['held_bytes'] / 2**30:.3f}"
        f" GiB); outOfCoreBuckets {c['ops'].get('outOfCoreBuckets', 0)}, "
        f"graceJoinPartitions {c['ops'].get('graceJoinPartitions', 0)} "
        f"({c['ops'].get('graceJoinBuildBuckets', 0)} non-empty build "
        f"buckets); catalog {cat} (LZ4 ratio {ratio:.2f}); ladder "
        f"{c['recovery'] or 'none'}; launches {ooc['launches']} (in core "
        f"{inc['launches']})")


def out_of_core_phase(native, cols: dict, known_seen: list,
                      known_k1: set) -> dict:
    """(a) An out-of-core sort of every LINEITEM row, (b) q67 with its
    window range-split, (c) q21 and q4 with grace joins, (d) q18 at
    eight partitions with its exchange pieces spilled, each beside its
    in-core run, and (e) a real device OOM recovered by the ladder. See
    the module doc for what each run checks and prints."""
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import suites as S
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.memory import compression, oom
    from spark_rapids_tpu_torch.plan import logical as L
    t_phase = time.perf_counter()
    if not isinstance(compression.get_codec("lz4"), compression.Lz4Codec):
        raise AssertionError("the lz4 codec is not the native one")
    oom.reset_degradation()
    xcols = S.suite_columns(1.0, seed=0)
    known_seen = list(known_seen)
    known_k1 = set(known_k1)
    vfa = {"spark.rapids.sql.variableFloatAgg.enabled": True}
    # Each run's Recovery@query metrics, summed over the phase.
    out = {"kernel_checks": [], "runs": [], "recovery": {}}
    log(f"phase 18: TPC-DS scale 1 columns in "
        f"{time.perf_counter() - t_phase:.2f} s")

    def pair(label, make, check, want, must, budget_of, collect=None,
             extra=None):
        """The in-core run, then the run under the budget ``budget_of``
        picks from the in-core run's counts."""
        inc = ooc_runs(native, f"{label} in core", make(vfa)._physical(),
                       check, want, must, known_seen, known_k1, collect)
        budget, conf, note = budget_of(inc)
        ooc = ooc_runs(native, f"{label} out of core",
                       make(dict(vfa, **conf))._physical(), check, want,
                       must, known_seen, known_k1, collect)
        out["kernel_checks"] += inc["checks"] + ooc["checks"]
        out["runs"] += [inc["launches"], ooc["launches"]]
        add_counts(out["recovery"], inc["recovery"])
        add_counts(out["recovery"], ooc["recovery"])
        log_pair(label, budget, inc, ooc, note)
        if extra is not None:
            extra(inc, ooc)
        return inc, ooc

    # (a) The sort.
    t0 = time.perf_counter()
    tcols = lineitem_with_linenumber(cols)
    sort_want = sort_oracle(tcols)
    log(f"(a) sort oracle ({len(sort_want['l_orderkey'])} rows) in "
        f"{time.perf_counter() - t0:.2f} s")

    def sort_budget(inc):
        return SORT_BUDGET, {_BUDGET_KEY: SORT_BUDGET,
                             _HOST_KEY: SORT_HOST_BYTES}, (
            f", spillStorageSize {SORT_HOST_BYTES}; the sort staged "
            f"{inc['counts']['ops'].get('stagedBytes', 0)} B in core")

    def sort_extra(inc, ooc):
        c = ooc["counts"]
        if c["ops"].get("outOfCoreBuckets", 0) < 4:
            raise AssertionError(f"(a) sort made {c['ops']} buckets, not 4+")
        if not c["catalog"]["spill_to_disk"] or \
                not c["catalog"]["restore_from_disk"]:
            raise AssertionError(f"(a) sort never reached disk: {c}")
        if not 0 < c["catalog"]["disk_bytes_stored"] < \
                c["catalog"]["disk_bytes_raw"]:
            raise AssertionError(f"(a) LZ4 did not shrink the spill: {c}")

    pair("(a) LINEITEM sort",
         lambda conf: lineitem_sort_frame(TpuSession(conf), tcols, E, L),
         check_sorted, sort_want, ("radix_sort",), sort_budget,
         collect=lambda phys, ctx: phys.collect_batches(ctx),
         extra=sort_extra)

    # (b) q67 with its window range-split on i_category.
    q67_check, q67_want = ds_oracles(xcols, S)["q67"]

    def make_q67(conf):
        session = TpuSession(conf)
        return S.QUERIES["q67"](session, S.suite_tables(
            session, xcols, ("q67",))["q67"])

    def q67_budget(inc):
        budget = inc["counts"]["window_staged"]
        return budget, {_BUDGET_KEY: budget}, (
            " (the window's staged bytes in core)")

    def q67_extra(inc, ooc):
        if ooc["counts"]["ops"].get("outOfCoreBuckets", 0) < 2:
            raise AssertionError(f"(b) q67 window did not split: "
                                 f"{ooc['counts']}")
        if ooc["rows"] != inc["rows"]:
            raise AssertionError("(b) q67 under the budget differs from "
                                 "its in-core run")

    pair("(b) q67", make_q67, q67_check, q67_want, ("radix_sort",),
         q67_budget, extra=q67_extra)

    # (c) q21 and q4 at one partition with grace joins.
    oracles = {"q21": ((lambda rows, want: check_rows("q21", rows, want)),
                       q21_oracle(cols, E)),
               "q4": df_oracles(cols, E)["q4"]}
    for q in ("q21", "q4"):
        check, want = oracles[q]

        def make_q(conf, q=q):
            session = TpuSession(conf)
            return tpch.QUERIES[q](session, tpch.tpch_tables(
                session, cols, (q,))[q])

        def grace_budget(inc, q=q):
            builds = inc["counts"]["builds"]
            big = [b for b in builds if b >= max(builds) // 4]
            budget = min(big) // 3
            return budget, {_BUDGET_KEY: budget}, (
                f" (a third of the smallest LINEITEM build of {big})")

        def grace_extra(inc, ooc, q=q):
            c = ooc["counts"]["ops"]
            if c.get("graceJoinPartitions", 0) < 2:
                raise AssertionError(f"(c) {q}: no grace join: {c}")
            if ooc["launches"]["join_probe"] < c["graceJoinBuildBuckets"]:
                raise AssertionError(
                    f"(c) {q}: {ooc['launches']['join_probe']} K3 launches "
                    f"for {c['graceJoinBuildBuckets']} non-empty buckets")

        pair(f"(c) {q}", make_q, check, want, ("radix_sort", "join_probe"),
             grace_budget, extra=grace_extra)

    # (d) q18 at eight partitions with its exchange pieces spilled.
    q18_check, q18_want = ((lambda rows, want: check_rows("q18", rows, want)),
                           q18_oracle(cols, E))

    def make_q18(conf, n=SHUFFLE_PARTITIONS):
        session = TpuSession(dict(conf, **{
            "spark.rapids.sql.shuffle.partitions": n}))
        return tpch.QUERIES["q18"](session, tpch.tpch_tables(
            session, cols, ("q18",))["q18"])

    one_phys = make_q18(vfa, 1)._physical()
    by_one = one_phys.collect()
    q18_check(by_one, q18_want)

    def q18_budget(inc):
        peak = inc["counts"]["catalog"]["peak_device_bytes"]
        budget = peak // 4
        return budget, {_BUDGET_KEY: budget, _HOST_KEY: budget // 2}, (
            f", spillStorageSize {budget // 2} (a quarter and an eighth of "
            f"the {peak} B the catalog held in core)")

    def q18_extra(inc, ooc):
        cat = ooc["counts"]["catalog"]
        if not (cat["spill_to_host"] and cat["spill_to_disk"]
                and cat["restore_from_host"] + cat["restore_from_disk"]):
            raise AssertionError(f"(d) q18 pieces did not spill to host "
                                 f"and disk: {cat}")
        if not rows_close(ooc["rows"], by_one):
            raise AssertionError("(d) q18 differs from its one-partition "
                                 "run")

    pair("(d) q18 (8 partitions)", make_q18, q18_check, q18_want,
         ("radix_sort",), q18_budget, extra=q18_extra)

    # (e) A real OOM: the process may reserve only part of q18's in-core
    # peak; the ladder must recover on the card.
    out["oom"] = real_oom(one_phys, q18_check, q18_want)
    out["runs"].append(out["oom"]["launches"])
    add_counts(out["recovery"], out["oom"]["recovery"])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 18 took {out['seconds']:.1f} s")
    return out


def real_oom(phys, check, want) -> dict:
    """Measure the reserved memory (the caching allocator's, which its
    cap counts) of one uncapped run, then cap the allocator
    (``set_per_process_memory_fraction``) at what it reserves now plus a
    share of that run's reserved peak above its start, for each share of
    ``OOM_SHARES`` in turn, until a run raises a real
    ``torch.OutOfMemoryError`` inside a retry site. That run must recover
    on the card (a rung fired) and match its oracle.
    The fraction is restored after every run."""
    import gc
    import torch
    from spark_rapids_tpu_torch.memory import oom
    from spark_rapids_tpu_torch.ops import native
    from spark_rapids_tpu_torch.ops.base import ExecContext
    total = torch.cuda.get_device_properties(0).total_memory

    def settle() -> int:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    base = settle()
    torch.cuda.reset_peak_memory_stats()
    check(phys.collect(), want)
    torch.cuda.synchronize()
    span = torch.cuda.max_memory_reserved() - base
    for share in OOM_SHARES:
        limit = settle() + int(share * span)
        native.reset_counters()
        oom.last_ladder[:] = []
        ctx = ExecContext(phys.conf)
        torch.cuda.set_per_process_memory_fraction(limit / total)
        try:
            t0 = time.perf_counter()
            rows = phys.collect(ctx)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        launches = native.counters()
        check(rows, want)
        c = check_teardown("(e) q18 under a memory cap", ctx)
        rec = c["recovery"]
        log(f"(e) q18 (1 partition) capped at {limit / 2**30:.3f} GiB "
            f"({share:.2f} of the {span / 2**30:.3f} GiB its uncapped run "
            f"reserved above {base / 2**30:.3f} GiB): {wall:.3f} s, rows "
            f"match; ladder {list(oom.last_ladder)}, recovery {rec}, "
            f"catalog {c['catalog']}")
        if rec.get("retriesAttempted", 0) > 0:
            if not oom.last_ladder:
                raise AssertionError("(e) a retry with no rung")
            return dict(share=share, limit=limit, span=span, wall_s=wall,
                        ladder=list(oom.last_ladder), recovery=rec,
                        launches=launches)
    raise AssertionError(f"(e) no share of {OOM_SHARES} raised an OOM")


# ---------------------------------------------------------------------------
# Phase 9: kernel K4 (the wire codec's RLE decode) against its plain version
# ---------------------------------------------------------------------------

# Run values per wire type, as tests/test_native.py RLE_POOLS, with a NaN
# of a non-default payload among the floats (bit patterns, so -0.0 and the
# payload must survive the expansion).
RLE_POOLS = {
    "int8": (np.int8, [1, 2, -3]),
    "int16": (np.int16, [100, -2000]),
    "int32": (np.int32, [7, -9, 2 ** 30]),
    "int64": (np.int64, [2 ** 40, -5, 0]),
    "float32": (np.float32, [1.5, -0.0, np.nan, 0.0,
                             np.array(0x7FC00123, np.uint32)
                             .view(np.float32)]),
    "float64": (np.float64, [np.nan, -0.0, 0.0, 3.25, np.inf,
                             np.array(0x7FF8000000000123, np.uint64)
                             .view(np.float64)]),
}
RLE_RUNS = (1, 8, 2048, 2049, 4096, "n/4", "n")
_INT_OF = {1: "int8", 2: "int16", 4: "int32", 8: "int64"}


def rle_inputs(cap: int, name: str, runs, seed: int):
    """A run table as the wire encoder builds it (``_try_rle``): ``runs``
    runs of random lengths over ``n`` rows (``n`` = cap - cap/8, or cap
    for one run per row), values drawn from the type's pool, zero-valued
    padding runs ending at cap. Returns (run_vals, run_ends, num_rows) on
    the card."""
    import torch
    from spark_rapids_tpu_torch.columnar.batch import bucket_capacity
    rng = np.random.default_rng(seed)
    n = cap if runs == "n" else cap - cap // 8
    runs = {"n": n, "n/4": n // 4}.get(runs, runs)
    runs = max(1, min(runs, n))
    np_t, pool = RLE_POOLS[name]
    pool = np.asarray(pool, np_t)
    run_cap = bucket_capacity(runs)
    cuts = np.sort(rng.choice(np.arange(1, n), runs - 1, replace=False)) \
        if runs > 1 else np.zeros(0, np.int64)
    vals = np.zeros(run_cap, np_t)
    vals[:runs] = pool[rng.integers(0, len(pool), runs)]
    ends = np.full(run_cap, cap, np.int32)
    ends[:runs - 1] = cuts
    ends[runs - 1] = n
    return (torch.from_numpy(vals).cuda(), torch.from_numpy(ends).cuda(),
            n)


def _as_bits(t):
    import torch
    return t.view(getattr(torch, _INT_OF[t.element_size()]))


def _as_f64(t, unsigned: bool):
    """Values as float64; integer bit patterns read as unsigned when
    ``unsigned`` (a u64 as hi * 2^32 + lo)."""
    import torch
    if t.is_floating_point() or not unsigned:
        return t.to(torch.float64)
    if t.element_size() < 8:
        return (t.to(torch.int64) & ((1 << 8 * t.element_size()) - 1)).to(
            torch.float64)
    hi = ((t >> 32) & 0xFFFFFFFF).to(torch.float64)
    return hi * 4294967296.0 + (t & 0xFFFFFFFF).to(torch.float64)


def max_abs_err(got, plain, unsigned: bool = False) -> float:
    """Largest |got - plain| over the elements: 0 where the bit patterns
    agree, inf where they differ but the values compare equal or NaN
    (-0.0, NaN payloads)."""
    import torch
    same = _as_bits(got) == _as_bits(plain)
    d = (_as_f64(got, unsigned) - _as_f64(plain, unsigned)).abs()
    d = torch.where(same, torch.zeros_like(d),
                    torch.where(torch.isnan(d) | (d == 0),
                                torch.full_like(d, float("inf")), d))
    return float(d.max()) if d.numel() else 0.0


def rle_check(native, vals, ends, cap: int, nrows: int, label: str,
              timed: bool, profiled: bool = False) -> dict:
    """K4 against its plain version, bit for bit; with ``timed``, kernel,
    plain and one ``torch.repeat_interleave`` times beside the bound; with
    ``profiled``, also the kernel's device time."""
    import torch
    got = native.rle_decode(vals, ends, cap, nrows)
    torch.cuda.synchronize()
    plain = native.rle_decode_plain(vals, ends, cap, nrows)
    if got.dtype != plain.dtype or got.shape != plain.shape:
        raise AssertionError(f"K4 {label}: {got.dtype}{tuple(got.shape)} vs "
                             f"plain {plain.dtype}{tuple(plain.shape)}")
    wrong = int((_as_bits(got) != _as_bits(plain)).sum())
    err = max_abs_err(got, plain)
    if wrong or err != 0:
        raise AssertionError(f"K4 != plain at {label} ({vals.dtype}, "
                             f"run_cap={vals.numel()}, cap={cap}): {wrong} "
                             f"rows differ, max abs err {err}")
    staging = "whole table staged" \
        if vals.numel() <= native.RLE_SMEM_RUNS else "window search"
    r = dict(max_abs_err=err, cap=cap, run_cap=vals.numel(),
             dtype=str(vals.dtype).replace("torch.", ""), staging=staging)
    if not timed:
        return r
    # Bound: the output written once and the run table read once.
    esize = vals.element_size()
    r["bound_ms"] = bytes_ms(cap * esize + vals.numel() * (esize + 4.0))
    r["bound_by"] = "bytes"
    iters = 20 if cap >= 1_000_000 else 50
    r["plain_ms"] = cuda_ms(
        lambda: native.rle_decode_plain(vals, ends, cap, nrows), iters)
    fns = {"ms": lambda: native.rle_decode(vals, ends, cap, nrows)}
    # One PyTorch call for the expansion: repeat each run by its length.
    # The padding runs cover [num_rows, cap) with zeros, so the counts sum
    # to cap unless the table is full.
    prev = torch.cat([ends.new_zeros(1), ends[:-1]])
    counts = (ends - prev).clamp(min=0)
    if int(counts.sum()) == cap:
        lib = torch.repeat_interleave(vals, counts, output_size=cap)
        if not torch.equal(_as_bits(lib), _as_bits(got)):
            raise AssertionError(f"repeat_interleave != K4 at {label}")
        fns["library_ms"] = lambda: torch.repeat_interleave(
            vals, counts, output_size=cap)
    r["library_ms"] = None
    r.update(turns_ms(fns, iters))
    lib_ms = "n/a (full table)" if r["library_ms"] is None \
        else f"{r['library_ms']:.4f} ms"
    dev_note = ""
    if profiled:
        r["device_ms"] = device_ms(
            lambda: native.rle_decode(vals, ends, cap, nrows), 20)
        dev_note = "; device time " + (
            "not measured (no device events)" if r["device_ms"] is None
            else f"{r['device_ms']:.4f} ms (torch.profiler)")
    log(f"K4 rle_decode {label} {r['dtype']} run_cap={r['run_cap']} "
        f"cap={cap} num_rows={nrows} ({staging}): bit-identical to plain; "
        f"kernel {r['ms']:.4f} ms, repeat_interleave {lib_ms} (medians of "
        f"5 turns), plain {r['plain_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms (bytes){dev_note}")
    return r


def rle_phase(native) -> dict:
    out = {}
    checked = 0
    for cap in CAPS:
        for name in RLE_POOLS:
            for runs in RLE_RUNS:
                vals, ends, nrows = rle_inputs(cap, name, runs,
                                               seed=cap + len(name))
                timed = cap != CAPS[0] and name in ("int8", "float64") \
                    and runs in (1, "n/4")
                out[(cap, name, runs)] = rle_check(
                    native, vals, ends, cap, nrows, f"runs={runs}", timed,
                    profiled=timed and cap == CAPS[-1] and runs == "n/4")
                checked += 1
    log(f"K4 rle_decode: {checked} tables bit-identical to the plain version "
        f"(caps {CAPS}, six types, runs {RLE_RUNS})")
    return out


# ---------------------------------------------------------------------------
# Phase 19: the numeric, date-time and row-source surface
# ---------------------------------------------------------------------------

RANGE_N = 1 << 26               # 16 batches of batchSizeRows at 8 partitions
RANGE_PARTITIONS = 8
RANGE_UNION_N = 1 << 25         # each side of range_union
HEAD_ROWS = 1 << 20
ROWSOURCE_WARM_RUNS = 2
TRANSCENDENTAL_ULPS = 4
ALL_DEVICE = {"spark.rapids.sql.variableFloatAgg.enabled": True,
              "spark.rapids.sql.improvedFloatOps.enabled": True}
# The logical nodes the default conf places on the host engine, by run:
# the projection's log / exp / pow and union_dates' float sum. The
# all-device conf places none.
ROWSOURCE_DEFAULT_HOST = {"range": [], "groups": ["LogicalProject"],
                          "head": ["LogicalProject"],
                          "union_dates": ["LogicalAggregate"],
                          "range_union": []}
ROWSOURCE_MUST_LAUNCH = {"range": ("radix_sort", "seg_reduce"),
                         "groups": ("radix_sort", "seg_reduce"),
                         "head": ("radix_sort",),
                         "union_dates": ("radix_sort",),
                         "range_union": ("radix_sort",)}

_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


def rand_oracle(seed: int, pid: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """rand(seed) of rows (partition, row index) in numpy uint64: the
    premixed seed plus pid * MIX1 plus idx * GOLDEN through SplitMix64's
    finalizer, top 53 bits scaled into [0, 1)."""
    m64 = (1 << 64) - 1
    x = (seed * _GOLDEN) & m64
    x = ((x ^ (x >> 30)) * _MIX1) & m64
    x = ((x ^ (x >> 27)) * _MIX2) & m64
    premix = x ^ (x >> 31)
    u = np.uint64
    with np.errstate(over="ignore"):
        c = u(premix) + pid.astype(u) * u(_MIX1) + idx.astype(u) * u(_GOLDEN)
        c = (c ^ (c >> u(30))) * u(_MIX1)
        c = (c ^ (c >> u(27))) * u(_MIX2)
        c = c ^ (c >> u(31))
    return (c >> u(11)).astype(np.float64) * 2.0 ** -53


def _by_mod(values: np.ndarray, n: int, groups: int, fill, how):
    """``how`` (np.sum / np.min / np.max) of ``values`` (one per id
    0..n-1) by ``id % groups``: padded to whole rows of ``groups`` with
    ``fill`` and reduced down the columns."""
    m = -(-n // groups) * groups
    padded = np.full(m, fill, dtype=values.dtype)
    padded[:n] = values
    return how(padded.reshape(-1, groups), axis=0)


def range_oracle(n: int, parts: int) -> list:
    """range_query's rows: ids 0..n-1 in ``parts`` contiguous partitions
    of ceil(n / parts) rows; rand(7), the monotonic id (pid << 33) + row
    index, the hour / minute / second of id * 37 seconds, by id % 4096."""
    from spark_rapids_tpu_torch.benchmarks import rowsource as R
    g = R.RANGE_GROUPS
    ids = np.arange(n, dtype=np.int64)
    per = max(-(-n // parts), 1)
    pid = ids // per
    idx = ids - pid * per
    r = rand_oracle(7, pid, idx)
    m = (pid << 33) + idx
    secs = (ids * 37) % 86400
    h, mi, s = secs // 3600, (secs // 60) % 60, secs % 60
    cnt = _by_mod(np.ones(n, np.int64), n, g, 0, np.sum)
    imax, imin = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    cols = [cnt, _by_mod(ids, n, g, 0, np.sum),
            _by_mod(r, n, g, np.inf, np.min),
            _by_mod(r, n, g, -np.inf, np.max),
            _by_mod(m, n, g, imax, np.min), _by_mod(m, n, g, imin, np.max),
            _by_mod(h, n, g, 0, np.sum), _by_mod(s, n, g, 0, np.sum),
            _by_mod(pid, n, g, -1, np.max)]
    return [(k,) + tuple(c[k].item() for c in cols)
            for k in range(g) if cnt[k] > 0]


def check_range_rows(rows: list, n: int, parts: int,
                     want: list = None) -> None:
    """range_query's rows bit for bit against ``range_oracle``."""
    check_rows("range", rows, want or range_oracle(n, parts), exact=True)


def _civil(days: np.ndarray):
    """(datetime64[D], year, month, day) of days since the epoch."""
    d = days.astype(np.int64).astype("datetime64[D]")
    y = d.astype("datetime64[Y]").astype(np.int64) + 1970
    mo = d.astype("datetime64[M]").astype(np.int64) % 12 + 1
    day = (d - d.astype("datetime64[M]")).astype(np.int64) + 1
    return d, y, mo, day


def projection_oracle(li: dict, n: int = None) -> dict:
    """lineitem_projection's columns of LINEITEM's first ``n`` rows in
    numpy: the calendar through datetime64, the rest by each function's
    definition (HALF_UP: floor(x*100 + 0.5) / 100 above zero)."""
    sl = slice(0, n)
    ship = li["l_shipdate"][sl].astype(np.int64)
    d, _y, mo, day = _civil(ship)
    month0 = d.astype("datetime64[M]")
    ext = li["l_extendedprice"][sl]
    disc, tax = li["l_discount"][sl], li["l_tax"][sl]
    price = ext * (1 - disc)
    scaled = price * 100.0
    nm = month0 + 1
    in_nm = ((nm + 1).astype("datetime64[D]")
             - nm.astype("datetime64[D]")).astype(np.int64)
    with np.errstate(invalid="ignore"):
        off = np.sqrt(disc - 0.05)
    isnan = np.isnan(off)
    i32 = np.int32
    return {
        "l_orderkey": li["l_orderkey"][sl],
        "datediff": (li["l_receiptdate"][sl].astype(np.int64)
                     - ship).astype(i32),
        "dow": ((ship + 4) % 7 + 1).astype(i32),
        "weekday": ((ship + 3) % 7).astype(i32),
        "doy": ((d - d.astype("datetime64[Y]")).astype(np.int64)
                + 1).astype(i32),
        "quarter": ((mo - 1) // 3 + 1).astype(i32),
        "last_day": ((month0 + 1).astype("datetime64[D]").astype(np.int64)
                     - 1).astype(i32),
        "trunc_mm": month0.astype("datetime64[D]").astype(np.int64)
        .astype(i32),
        "add_months": (nm.astype("datetime64[D]").astype(np.int64)
                       + np.minimum(day, in_nm) - 1).astype(i32),
        "commit_30": (li["l_commitdate"][sl].astype(np.int64)
                      + 30).astype(i32),
        "round2": np.where(scaled >= 0, np.floor(scaled + 0.5),
                           np.ceil(scaled - 0.5)) / 100.0,
        "bround2": np.round(scaled) / 100.0,
        "floor7": np.floor(ext / 7).astype(np.int64),
        "ceil7": np.ceil(ext / 7).astype(np.int64),
        "log_price": np.log(ext),
        "sqrt_price": np.sqrt(ext),
        "exp_tax": np.exp(-tax),
        "disc_sq": np.power(disc, 2.0),
        "least": np.minimum(tax, disc),
        "greatest": np.maximum(tax, disc),
        "abs_qty": np.abs(-li["l_quantity"][sl]),
        "signum": np.sign(disc - 0.05),
        "isnan": isnan,
        "nanvl": np.where(isnan, -1.0, off),
        "nn2": ((tax > 0).astype(np.int64) + (~isnan) + 1) >= 2,
    }


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in units in the last place between float64 arrays."""
    def key(x):
        i = np.asarray(x, np.float64).view(np.int64)
        return np.where(i < 0, np.int64(-2 ** 63) - i, i)
    return np.abs(key(a) - key(b))


def check_projection(hbs: list, li: dict, n: int, want: dict = None
                     ) -> dict:
    """The downloaded head of lineitem_projection (host batches) against
    ``projection_oracle`` (``want``, or computed here): every column but
    the transcendentals bit for bit, each transcendental within
    TRANSCENDENTAL_ULPS of numpy's. Returns each transcendental's largest
    ulp distance."""
    from spark_rapids_tpu_torch.benchmarks import rowsource as R
    if want is None:
        want = projection_oracle(li, n)
    else:
        want = {k: v[:n] for k, v in want.items()}
    rows = sum(hb.num_rows for hb in hbs)
    if rows != len(want["l_orderkey"]):
        raise AssertionError(f"projection head: {rows} rows, oracle "
                             f"{len(want['l_orderkey'])}")
    worst = {}
    for ci, (name, transcendental) in enumerate(R.PROJECTION):
        got = np.concatenate([np.asarray(hb.columns[ci].data)
                              for hb in hbs])
        valid = np.concatenate([np.asarray(hb.columns[ci].validity)
                                for hb in hbs])
        if not valid.all():
            raise AssertionError(f"projection head {name}: NULLs")
        exp = want[name]
        if transcendental or name == "sqrt_price":
            worst[name] = int(ulps(got, exp).max())
            if worst[name] > TRANSCENDENTAL_ULPS:
                raise AssertionError(f"projection head {name}: "
                                     f"{worst[name]} ulp from numpy")
        elif got.dtype != exp.dtype or \
                got.tobytes() != np.ascontiguousarray(exp).tobytes():
            bad = int(np.flatnonzero(got != exp)[0]) if got.shape == \
                exp.shape else 0
            raise AssertionError(f"projection head {name} differs "
                                 f"({got.dtype} vs {exp.dtype}) at row "
                                 f"{bad}: {got[bad]} vs {exp[bad]}")
    return worst


def _segments(key: np.ndarray):
    """(order, starts, ends) of the stable sort of ``key``."""
    order = np.argsort(key, kind="stable")
    sk = key[order]
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    return order, starts, np.r_[starts[1:], len(key)]


def groups_oracle(li: dict, p: dict = None) -> list:
    """lineitem_groups' rows from ``projection_oracle`` (``p``, or computed
    here): by (month, day of week), first / last in scan order (a stable
    sort keeps it)."""
    p = p or projection_oracle(li)
    key = p["trunc_mm"].astype(np.int64) * 8 + p["dow"]
    order, starts, ends = _segments(key)

    def red(name, fn):
        return fn.reduceat(np.asarray(p[name])[order], starts)

    def total(name):
        return np.add.reduceat(np.asarray(p[name]).astype(np.int64)[order],
                               starts)
    cols = [ends - starts, total("datediff"), total("floor7"),
            total("ceil7"), total("weekday"), red("doy", np.minimum),
            red("quarter", np.maximum), red("last_day", np.minimum),
            red("add_months", np.maximum), red("commit_30", np.maximum),
            red("round2", np.minimum), red("bround2", np.maximum),
            red("log_price", np.minimum), red("sqrt_price", np.maximum),
            red("exp_tax", np.minimum), red("disc_sq", np.maximum),
            red("least", np.minimum), red("greatest", np.maximum),
            red("abs_qty", np.maximum), red("signum", np.minimum),
            red("nanvl", np.maximum), total("isnan"), total("nn2"),
            p["l_orderkey"][order[starts]], p["l_orderkey"][order[ends - 1]]]
    lead = order[starts]
    return [(p["trunc_mm"][lead[i]].item(), p["dow"][lead[i]].item())
            + tuple(c[i].item() for c in cols) for i in range(len(starts))]


def check_group_rows(rows: list, li: dict, want: list = None) -> None:
    check_rows("lineitem groups", rows, want or groups_oracle(li))


def union_oracle(li: dict) -> list:
    """union_dates' rows: ship and receipt dates with the quantity, by
    year and quarter."""
    days = np.concatenate([li["l_shipdate"], li["l_receiptdate"]])
    qty = np.concatenate([li["l_quantity"], li["l_quantity"]])
    _d, y, mo, _day = _civil(days)
    key = y * 4 + (mo - 1) // 3
    order, starts, ends = _segments(key)
    sums = np.add.reduceat(qty[order], starts)
    return [(int(key[order[s]] // 4), int(key[order[s]] % 4) + 1,
             int(e - s), float(t)) for s, e, t in zip(starts, ends, sums)]


def check_union_rows(rows: list, li: dict, want: list = None) -> None:
    check_rows("union_dates", rows, want or union_oracle(li))


def range_union_oracle(n: int, parts: int) -> list:
    """range_union's rows: range(0, n) then range(n, 2n), each in
    ``parts`` partitions; rows and id sums by the union's partition."""
    per = max(-(-n // parts), 1)
    out = []
    for side in range(2):
        for p in range(parts):
            lo, hi = min(p * per, n), min((p + 1) * per, n)
            if hi > lo:
                a, b = side * n + lo, side * n + hi - 1
                out.append((side * parts + p, hi - lo,
                            (a + b) * (hi - lo) // 2))
    return out


def check_range_union_rows(rows: list, n: int, parts: int,
                           want: list = None) -> None:
    check_rows("range_union", rows, want or range_union_oracle(n, parts),
               exact=True)


def _warm_batches(phys, check, runs: int) -> tuple:
    """``_warm`` for a run checked on its host batches."""
    import torch
    from spark_rapids_tpu_torch.ops.base import ExecContext
    warm = []
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for _ in range(runs):
        t0 = time.perf_counter()
        hbs = phys.collect_batches(ExecContext(phys.conf))
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        check(hbs, None)
    return warm, torch.cuda.max_memory_allocated(), held


def rowsource_phase(native, cols: dict, known_seen: list,
                    known_k1: set) -> dict:
    """(a) ``range`` (67,108,864 ids in 8 partitions) with rand,
    monotonically_increasing_id, spark_partition_id and the time parts of
    from_unixtime, grouped by id % 4096; (b) LINEITEM at SF1 through the
    math and date-time projection, grouped by month and day of week with first /
    last, and the projection's first 1,048,576 rows downloaded; (c) ship
    and receipt dates as one UNION ALL column by year and quarter, and
    range UNION ALL range at 8 + 8 partitions by partition id. Each under
    ``variableFloatAgg`` + ``improvedFloatOps`` (every node on the card)
    and under the default conf, against numpy oracles; for each run host
    nodes and bridges, rows downloaded, the first run with every K1-K4
    launch recorded (new shapes against the plain versions), two warm
    walls and the peak device memory of the warm runs."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import rowsource as R
    from spark_rapids_tpu_torch.plan import logical as L
    t_phase = time.perf_counter()
    li = cols["lineitem"]
    proj = projection_oracle(li)
    want = {"range": range_oracle(RANGE_N, RANGE_PARTITIONS),
            "groups": groups_oracle(li, proj),
            "union_dates": union_oracle(li),
            "range_union": range_union_oracle(RANGE_UNION_N,
                                              RANGE_PARTITIONS)}
    log(f"phase 19: oracles in {time.perf_counter() - t_phase:.2f} s")
    checks = {
        "range": lambda rows, w: check_range_rows(rows, RANGE_N,
                                                  RANGE_PARTITIONS, w),
        "groups": lambda rows, w: check_group_rows(rows, li, w),
        "union_dates": lambda rows, w: check_union_rows(rows, li, w),
        "range_union": lambda rows, w: check_range_union_rows(
            rows, RANGE_UNION_N, RANGE_PARTITIONS, w)}
    known_seen = list(known_seen)
    known_k1 = set(known_k1)
    out = {"kernel_checks": [], "runs": [], "ulps": {}}

    def run(label, phys, q, conf_name, collect=None, warm=None):
        hosted = ROWSOURCE_DEFAULT_HOST[q] if conf_name == "default" else []
        check = checks[q]
        r = run_checked(native, label, phys, check, want.get(q), hosted,
                        ROWSOURCE_MUST_LAUNCH[q], known_seen, known_k1,
                        collect=collect)
        known_seen.append(r["seen"])
        known_k1.update(c["shape"] for c in r["checks"]
                        if c["kernel"] == "radix_sort")
        out["kernel_checks"] += r["checks"]
        walls, peak, held = (warm or _warm)(phys, check, want.get(q),
                                            ROWSOURCE_WARM_RUNS)
        log(f"{label} matches the numpy oracle: first run "
            f"{r['first_s']:.3f} s, warm {[round(w, 4) for w in walls]} s, "
            f"peak device memory in the warm runs {peak / 2**30:.3f} GiB "
            f"({held / 2**30:.3f} GiB held before them); launches "
            f"{r['launches']}")
        out[label] = dict(first_s=r["first_s"], warm_s=walls,
                          launches=r["launches"], moved=r["moved"],
                          hosted=r["hosted"], peak_bytes=peak,
                          held_bytes=held)
        out["runs"].append(r["launches"])
        return r["rows"]

    for conf_name, conf in (("device", ALL_DEVICE), ("default", {})):
        session = TpuSession(conf)
        ldf = R.lineitem(session, cols)
        run(f"range ({conf_name})", R.range_query(
            L, session, RANGE_N, RANGE_PARTITIONS)._physical(), "range",
            conf_name)
        seen_k1 = []
        with recording_k1(native, seen_k1):
            run(f"lineitem groups ({conf_name})",
                R.lineitem_groups(L, ldf)._physical(), "groups", conf_name)
        if conf_name == "device" and seen_k1:
            # The phase's largest new K1 shape: the groups' fingerprint
            # sort of the whole LINEITEM batch, through a permutation.
            keys, perm = max(seen_k1, key=lambda a: a[0].numel())
            out["k1"] = k1_time(native, keys, perm, "phase 19 largest new")
            del seen_k1
        # The head projects the first HEAD_ROWS lines only.
        head = R.projection_head(L, R.lineitem(session, cols,
                                               rows=HEAD_ROWS),
                                 HEAD_ROWS)._physical()
        worst = {}

        def head_check(hbs, _w, worst=worst):
            worst.update(check_projection(hbs, li, HEAD_ROWS, proj))
        checks["head"] = head_check
        run(f"projection head ({conf_name})", head, "head", conf_name,
            collect=lambda phys, ctx: phys.collect_batches(ctx),
            warm=lambda phys, check, _w, runs: _warm_batches(
                phys, check, runs))
        out["ulps"][conf_name] = dict(worst)
        log(f"projection head ({conf_name}): {HEAD_ROWS} rows, dates, "
            f"integers, round / bround / floor / ceil bit for bit; largest "
            f"ulp distance from numpy {worst}")
        run(f"union_dates ({conf_name})", R.union_dates(L, ldf)._physical(),
            "union_dates", conf_name)
        run(f"range_union ({conf_name})", R.range_union(
            L, session, RANGE_UNION_N, RANGE_PARTITIONS)._physical(),
            "range_union", conf_name)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 19 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 10: the wire codec, v2 against plain
# ---------------------------------------------------------------------------

def codec_walls(plans: dict) -> dict:
    """Each plan's first wall under plain (its sources pack their batches
    for plain; the default v2 packed in the path's first run), then its
    warm walls under v2 and plain in turns (v2, plain, plain, v2), in this
    one process."""
    import torch
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.ops import ExecContext
    out = {}
    for name, plan in plans.items():
        walls = {"v2": [], "plain": []}
        for i, mode in enumerate(("plain", "v2", "plain", "plain", "v2")):
            ctx = ExecContext(TpuConf({"spark.rapids.sql.wire.codec": mode}))
            t0 = time.perf_counter()
            plan.collect(ctx)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if i == 0:
                first_plain = wall
            else:
                walls[mode].append(wall)
        out[name] = dict(walls, first_plain=first_plain)
        log(f"{name} walls by codec: plain first {first_plain:.4f} s; warm "
            f"v2 {walls['v2']} s, plain {walls['plain']} s (mean v2 "
            f"{np.mean(walls['v2']):.4f}, plain "
            f"{np.mean(walls['plain']):.4f})")
    return out


def encode_split(plan, parts) -> dict:
    """Host encode time of one q1 partition, by column, and of the whole
    pack (columns on the encode pool), under v2; the pack must equal the
    one the plan's source kept, byte for byte."""
    from spark_rapids_tpu_torch.columnar import wire
    from spark_rapids_tpu_torch.columnar.batch import bucket_capacity
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.ops import InMemorySourceExec
    wire.maybe_configure(TpuConf({"spark.rapids.sql.wire.codec": "v2"}))
    source = plan
    while not isinstance(source, InMemorySourceExec):
        source = source.children[0]
    path_packed = source.packed(0)[0]
    hb = parts[0][0]
    n = hb.num_rows
    cap = bucket_capacity(n)
    per = {}
    for name, hc in zip(hb.names, hb.columns):
        t0 = time.perf_counter()
        _arrs, spec = wire.encode_column(hc, name, n, cap, None)
        per[name] = (time.perf_counter() - t0, spec)
    t0 = time.perf_counter()
    enc = wire.pack_batch(hb)
    pack_s = time.perf_counter() - t0
    if enc.staging.tobytes() != path_packed.staging.tobytes():
        raise AssertionError("q1 partition 0 packs to other bytes than its "
                             "source kept")
    log(f"q1 partition 0 ({n} rows, cap {cap}) host encode by column: "
        + ", ".join(f"{k} {v[0] * 1e3:.2f} ms {v[1]}" for k, v in per.items())
        + f"; whole pack {pack_s * 1e3:.2f} ms ({enc.nbytes} B staging)")
    return dict(per_column_s={k: v[0] for k, v in per.items()},
                pack_s=pack_s, staging_bytes=enc.nbytes)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "spark_rapids_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (the "
              "spark_rapids_tpu_torch package is missing)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, HERE)
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.ops import cuda_build, native

    # Phase 1: device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}); nvidia-smi: {smi}")

    # Phase 2: build
    t0 = time.perf_counter()
    libs = cuda_build.build_all(["radix_rank", "join_probe", "seg_scan",
                                 "rle_decode"])
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for name, path in libs.items():
        ptxas = path.with_suffix(".log")
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    # Phase 3: kernel K1
    k1 = kernel_phase(native)
    sort_profile_phase(native, k1)

    # Phase 4: TPC-H q1
    path = path_phase(entry, native)

    # Phase 5: kernel K3
    probe_phase(native)

    # Phase 6: TPC-H q3 and q4
    t0 = time.perf_counter()
    cols = entry.tpch_columns(1.0, seed=0)
    log(f"TPC-H SF1 columns generated in {time.perf_counter() - t0:.2f} s")
    joins = join_paths_phase(entry, native, cols)

    # Phase 7: kernel K2
    seg_phase(native)

    # Phase 8: TPC-H q2
    q2 = q2_phase(entry, native, cols)

    # Phase 9: kernel K4
    rle_phase(native)

    # Phase 10: the wire codec, v2 against plain
    codec_walls({"q1": path["plan"], "q3": joins["plans"]["q3"],
                 "q4": joins["plans"]["q4"], "q2": q2["plan"]})
    encode_split(path["plan"], path["parts"])

    # Phase 11: TPC-H q1-q6 through the DataFrame front end
    df = dataframe_phase(native, cols, {
        "q1": (path["plan"], path["launches"]),
        "q3": (joins["plans"]["q3"], joins["q3"]["launches"]),
        "q4": (joins["plans"]["q4"], joins["q4"]["launches"]),
        "q2": (q2["plan"], q2["launches"])}, joins["seen"] + [q2["seen"]])

    # Phase 12: TPC-H q1-q6 under the default conf
    mixed = default_conf_phase(native, cols, joins["seen"] + [q2["seen"]]
                               + [df[q]["seen"] for q in DF_QUERIES])

    # Phase 13: TPCxBB q5 and TPC-H q7, q8, q9, q12, q14, q19, both confs
    known_k1 = set(K1_CHECKED) | {r["shape"] for r in mixed["kernel_checks"]
                                  if r["kernel"] == "radix_sort"}
    more = more_queries_phase(native, cols, joins["seen"] + [q2["seen"]] + [
        df[q]["seen"] for q in DF_QUERIES] + [
        mixed[q]["seen"] for q in DF_QUERIES], known_k1)

    # Phase 14: TPC-DS q67, ds_q3, ds_q42, ds_q55, ds_q89, ds_q98, both
    # confs
    ds = ds_queries_phase(native, joins["seen"] + [q2["seen"]] + [
        df[q]["seen"] for q in DF_QUERIES] + [
        mixed[q]["seen"] for q in DF_QUERIES], known_k1)

    # Phase 15: TPCxBB xbb_q12 and TPC-H q10, q13, q16, q17, q18, q21,
    # both confs
    dq = distinct_queries_phase(native, cols, joins["seen"] + [q2["seen"]]
                                + [df[q]["seen"] for q in DF_QUERIES] + [
        mixed[q]["seen"] for q in DF_QUERIES], known_k1)

    # Phase 16: the exchange, the shuffled and nested-loop joins, repart,
    # q11, q15, q20 and q22, and every query at 8 partitions
    ex = exchange_phase(native, cols, joins["seen"] + [q2["seen"]] + [
        df[q]["seen"] for q in DF_QUERIES] + [
        mixed[q]["seen"] for q in DF_QUERIES], known_k1)
    ex_runs = [k for k in ex if k not in ("kernel_checks", "seconds")]

    # Phase 18: the memory tier and out-of-core execution
    ooc = out_of_core_phase(native, cols, joins["seen"] + [q2["seen"]] + [
        df[q]["seen"] for q in DF_QUERIES] + [
        mixed[q]["seen"] for q in DF_QUERIES], known_k1 | {
        c["shape"] for ph in (more, ds, dq, ex) for c in ph["kernel_checks"]
        if c["kernel"] == "radix_sort"})

    # Phase 19: the numeric, date-time and row-source surface
    rs = rowsource_phase(native, cols, joins["seen"] + [q2["seen"]] + [
        df[q]["seen"] for q in DF_QUERIES] + [
        mixed[q]["seen"] for q in DF_QUERIES], known_k1 | {
        c["shape"] for ph in (more, ds, dq, ex) for c in ph["kernel_checks"]
        if c["kernel"] == "radix_sort"})

    # Phase 17: the kernels line
    more_runs = tuple(more[(q, c)]["launches"] for c in ("vfa", "default")
                      for q in MORE_QUERIES) + tuple(
        ds[(q, c)]["launches"] for c in ("vfa", "default")
        for q in DS_QUERIES) + tuple(
        dq[(q, c)]["launches"] for c in ("vfa", "default")
        for q in DISTINCT_QUERIES) + tuple(
        ex[k]["launches"] for k in ex_runs) + tuple(ooc["runs"]) + tuple(
        rs["runs"])
    runs = (path["launches"], joins["q3"]["launches"],
            joins["q4"]["launches"], q2["launches"]) + tuple(
                df[q]["launches"] for q in DF_QUERIES) + tuple(
                mixed[q]["launches"] for q in DF_QUERIES) + more_runs
    launches = {k: sum(r[k] for r in runs) for k in runs[0]}
    replaces = {"radix_sort": "spark_rapids_tpu/ops/native.py:297",
                "join_probe": "spark_rapids_tpu/ops/native.py:315",
                "seg_reduce": "spark_rapids_tpu/ops/native.py:489",
                "rle_decode": "spark_rapids_tpu/ops/native.py:386"}
    sources = {"radix_sort": "radix_rank.cu", "join_probe": "join_probe.cu",
               "seg_reduce": "seg_scan.cu", "rle_decode": "rle_decode.cu"}
    # K1: the whole sort at the main path's size against torch.sort; K2:
    # the per-group function on q2's largest launch against one
    # identity-filled scatter_reduce_.
    timed = dict(radix_sort=k1[(PATH_CAP, "random")],
                 join_probe=joins["q4_probe"], seg_reduce=q2["k2"],
                 rle_decode=joins["q3_rle"])
    kernels = []
    for name in ("radix_sort", "join_probe", "seg_reduce", "rle_decode"):
        r = timed[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"spark_rapids_tpu_torch/csrc/{sources[name]}",
            "replaces": replaces[name], "launches": int(launches[name]),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r.get("bound_by", "bytes"),
            "library_ms": r["library_ms"]})
    log(f"launches per path: q1 {runs[0]}, q3 {runs[1]}, q4 {runs[2]}, "
        f"q2 {runs[3]}; DataFrame path "
        + ", ".join(f"{q} {df[q]['launches']}" for q in DF_QUERIES)
        + "; default conf "
        + ", ".join(f"{q} {mixed[q]['launches']}" for q in DF_QUERIES)
        + "; phase 13 "
        + ", ".join(f"{q} ({c}) {more[(q, c)]['launches']}"
                    for c in ("vfa", "default") for q in MORE_QUERIES)
        + "; phase 14 "
        + ", ".join(f"{q} ({c}) {ds[(q, c)]['launches']}"
                    for c in ("vfa", "default") for q in DS_QUERIES)
        + "; phase 15 "
        + ", ".join(f"{q} ({c}) {dq[(q, c)]['launches']}"
                    for c in ("vfa", "default") for q in DISTINCT_QUERIES)
        + "; phase 16 "
        + ", ".join(f"{k} {ex[k]['launches']}" for k in ex_runs)
        + "; phase 18 " + ", ".join(str(r) for r in ooc["runs"])
        + f"; phase 18 recovery {ooc['recovery']}"
        + "; phase 19 " + ", ".join(str(r) for r in rs["runs"]))
    log(f"nvidia-smi: {smi}")
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
