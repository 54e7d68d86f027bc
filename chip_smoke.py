#!/usr/bin/env python3
"""On-card smoke run of spark_rapids_tpu_torch, the PyTorch + CUDA port.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero):

1. Device: the card's name, and its name and power limit as nvidia-smi
   reports them.
2. Build: the hand-written kernels compile from ``csrc/`` into the
   package's ignored ``build/`` directory (one nvcc per source).
3. Kernel: ``stable_argsort_u32`` (kernel K1) on random and
   duplicate-heavy u32 keys at capacities 512, 786 432 and 4 194 304 must
   equal its plain-PyTorch version and ``torch.sort(stable=True)`` bit for
   bit; kernel, plain and torch.sort times (CUDA events) beside the byte
   bound.
4. Path: TPC-H Q1 at scale factor 1 (8 partitions, seed 0) through
   ``tpch_q1_plan(...).collect()`` on the card, checked against a numpy
   oracle in this file (group keys and counts exact, sums and averages to
   rtol 1e-9); K1's launch counters must rise during the run.
5. A ``{"kernels": [...]}`` line: each ported kernel's launches on the
   path, its error against the plain version, its time, the plain
   version's, its bound.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The script imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

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


def bytes_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# Phase 3: kernel K1 against its plain version and torch.sort
# ---------------------------------------------------------------------------

def make_keys(kind: str, cap: int, seed: int):
    import torch
    rng = np.random.default_rng(seed)
    if kind == "random":
        k = rng.integers(0, 2 ** 32, cap, dtype=np.int64)
    else:       # duplicate-heavy: 5 distinct values, extremes included
        k = rng.choice(np.array([0, 1, 0x00FF00FF, 0x7FFFFFFF, 0xFFFFFFFF],
                                np.int64), cap)
    return torch.from_numpy(k).cuda()


def kernel_phase(native) -> dict:
    import torch
    results = {}
    for cap in CAPS:
        for kind in ("random", "dups"):
            keys = make_keys(kind, cap, seed=cap + len(kind))
            native.reset_counters()
            got = native.stable_argsort_u32(keys)
            torch.cuda.synchronize()
            launches = native.counters()
            plain = native.stable_argsort_u32_plain(keys)
            lib = torch.sort(keys, stable=True).indices.to(torch.int32)
            if not torch.equal(got, plain):
                raise AssertionError(f"K1 != plain at cap={cap} {kind}")
            if not torch.equal(got, lib):
                raise AssertionError(f"K1 != torch.sort at cap={cap} {kind}")
            iters = 20 if cap < 4_000_000 else 10
            k_ms = cuda_ms(lambda: native.stable_argsort_u32(keys), iters)
            p_ms = cuda_ms(lambda: native.stable_argsort_u32_plain(keys), 3,
                           warmup=1)
            l_ms = cuda_ms(lambda: torch.sort(keys, stable=True), iters)
            # Function bound: read the u32 keys once, write the int32
            # permutation once.
            b_ms = bytes_ms(8.0 * cap)
            results[(cap, kind)] = dict(kernel_ms=k_ms, plain_ms=p_ms,
                                        torch_sort_ms=l_ms, bound_ms=b_ms)
            log(f"K1 stable_argsort_u32 cap={cap} keys={kind}: bit-identical"
                f" to plain and torch.sort; kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, torch.sort {l_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms (8 B/row at 3.35 TB/s); launches per sort "
                f"{launches}")
    return results


def per_launch_phase(native, cap: int) -> dict:
    """One digit pass of each CUDA kernel at ``cap`` (random keys): time,
    plain version's time, error against the plain version, bound."""
    import torch
    keys = make_keys("random", cap, seed=1)
    k32 = native.to_u32_bits(keys)
    k64 = keys.clone()
    ntiles = -(-cap // native.TILE_ROWS)
    table = 256 * ntiles
    hist = torch.empty(table, dtype=torch.int32, device="cuda")
    native.digit_hist(k32, 0, hist)
    plain_hist = native.digit_hist_plain(k64 & 0xFF)
    hist_err = (hist.to(torch.int64) - plain_hist).abs().max().item()
    offsets = torch.cumsum(hist, 0, dtype=torch.int32) - hist
    vals = torch.arange(cap, dtype=torch.int32, device="cuda")
    k_out = torch.empty_like(k32)
    v_out = torch.empty_like(vals)
    native.digit_scatter(k32, vals, 0, offsets, k_out, v_out)
    pk, pv = native.digit_scatter_plain(k64, vals.to(torch.int64), 0,
                                        offsets.to(torch.int64))
    scatter_err = max(
        (v_out.to(torch.int64) - pv).abs().max().item(),
        (native.to_u32_bits(pk).to(torch.int64)
         - k_out.to(torch.int64)).abs().max().item())
    out = {
        "digit_hist": dict(
            ms=cuda_ms(lambda: native.digit_hist(k32, 0, hist), 50),
            plain_ms=cuda_ms(lambda: native.digit_hist_plain(k64 & 0xFF),
                             10),
            max_abs_err=float(hist_err),
            # keys read once, the (256 x ntiles) table written once
            bound_ms=bytes_ms(4.0 * cap + 4.0 * table)),
        "digit_scatter": dict(
            ms=cuda_ms(lambda: native.digit_scatter(
                k32, vals, 0, offsets, k_out, v_out), 50),
            plain_ms=cuda_ms(lambda: native.digit_scatter_plain(
                k64, vals.to(torch.int64), 0, offsets.to(torch.int64)), 5),
            max_abs_err=float(scatter_err),
            # keys, row indices and offsets read once; keys and row
            # indices written once
            bound_ms=bytes_ms(16.0 * cap + 4.0 * table)),
    }
    for name, r in out.items():
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
        log(f"{name} one pass at cap={cap}: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")
    return out


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
    plan = entry.tpch_q1_plan(parts, device="cuda")
    native.reset_counters()
    t0 = time.perf_counter()
    rows = plan.collect()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = native.counters()
    check_q1(rows, want)
    if min(launches.values()) <= 0:
        raise AssertionError(f"q1 did not launch every K1 kernel: {launches}")
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
                rows=n_rows)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "spark_rapids_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (the "
              "spark_rapids_tpu_torch package is missing)", file=sys.stderr)
        return 2
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
    libs = cuda_build.build_all(["radix_rank"])
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for name, path in libs.items():
        ptxas = path.with_suffix(".log")
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    # Phase 3: kernels
    kernel_phase(native)
    per_launch = per_launch_phase(native, PATH_CAP)

    # Phase 4: the main path
    path = path_phase(entry, native)

    # Phase 5: the kernels line
    replaces = {"digit_hist": "spark_rapids_tpu/ops/native.py:251",
                "digit_scatter": "spark_rapids_tpu/ops/native.py:259"}
    kernels = []
    for name in ("digit_hist", "digit_scatter"):
        r = per_launch[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/radix_rank.cu",
            "replaces": replaces[name],
            "launches": int(path["launches"][name]),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None})
    log(f"nvidia-smi: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
