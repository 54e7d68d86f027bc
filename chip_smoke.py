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
12. A ``{"kernels": [...]}`` line: each ported kernel's launches on the
   paths (q1 + q3 + q4 + q2 hand-built, then q1-q6 through the DataFrame
   front end), its error against the plain version, its
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

    # Phase 12: the kernels line
    runs = (path["launches"], joins["q3"]["launches"],
            joins["q4"]["launches"], q2["launches"]) + tuple(
                df[q]["launches"] for q in DF_QUERIES)
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
        + ", ".join(f"{q} {df[q]['launches']}" for q in DF_QUERIES))
    log(f"nvidia-smi: {smi}")
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
