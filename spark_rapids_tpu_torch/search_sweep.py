"""The k-ary searches of K3 and K4 against binary searches, on the card.

    python3 -m spark_rapids_tpu_torch.search_sweep [--rounds N] [--host]

Run it from the root of a checkout. Each comparison runs its two arms in
turns (a, b, b, a) for ``--rounds`` rounds in one process:
- K3 (``csrc/join_probe.cu``): at each probe count where
  ``native.probe_lanes`` gives a probe 8 or more lanes, the shipped
  wrapper against the same wrapper held to one lane, the binary walk
  (``probe_binary``) that it takes from 16,897 probes on 132 SMs. Two
  ``torch.searchsorted`` are timed beside them.
- K4 (``csrc/rle_decode.cu``): at 4,194,304 rows with 917,504 runs (int8
  and float64), where each block finds its run window by a search, the
  shipped library (32-lane window searches) against the same source built
  with ``-DSRT_RLE_WINDOW_LANES=1`` (a binary search, one load a step)
  into the ignored ``build/sweep/``, both through ``native.rle_decode``.
Every arm is first checked bit for bit against the plain version. Two
times an arm: CUDA events over 200 back-to-back wrapper calls (host cost
included), and its device time (the best of 5 replays of a CUDA graph of
40 back-to-back calls, over 40). Each is printed as median [min-max] over
the rounds, then all of them as one JSON line.

With ``--host`` it prints instead the host microseconds a call of the K3
and K4 wrappers and of the allocation idioms they could use (no device
work to wait for: 512 probes, a one-run table), against two
``torch.searchsorted`` and one ``torch.empty``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import statistics
import subprocess
import time
from unittest import mock

import numpy as np
import torch

from spark_rapids_tpu_torch.ops import cuda_build, native
from spark_rapids_tpu_torch.wall_compare import _probe_inputs, _rle_inputs

# (build, probe): q4's build at 4,096 (32 lanes) and 8,192 (its first
# probe, 16) probes, and a 3 * 2^20 rung at 12,000 and 16,896 (8 lanes).
K3_SHAPES = ((6_291_456, 4_096), (6_291_456, 8_192), (3_145_728, 12_000),
             (3_145_728, 16_896))
# (rows, logical rows, runs, dtype): K4's window-search tables.
K4_TABLES = ((4_194_304, 3_670_016, 917_504, np.int8),
             (4_194_304, 3_670_016, 917_504, np.float64))
INT64_MIN = -(1 << 63)
CALLS, REPS = 200, 40


def _events_ms(fn) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CALLS


def _graph_ms(fn) -> float:
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(REPS):
                fn()
    best = float("inf")
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / REPS)
    return best


def _in_turns(arms: dict, fn, rounds: int) -> dict:
    """{arm: {"events_ms": [...], "device_ms": [...]}}: the two arms,
    each a context manager factory, timed in turns (a, b, b, a)."""
    a, b = arms
    out = {k: {"events_ms": [], "device_ms": []} for k in arms}
    for _ in range(rounds):
        for k in (a, b, b, a):
            with arms[k]():
                out[k]["events_ms"].append(_events_ms(fn))
                out[k]["device_ms"].append(_graph_ms(fn))
    return out


def _show(label: str, res: dict) -> None:
    for arm, times in res.items():
        parts = [f"{kind} {statistics.median(v):.4f} [{min(v):.4f}-"
                 f"{max(v):.4f}]" for kind, v in times.items()]
        print(f"{label} {arm}: " + ", ".join(parts) + " ms", flush=True)


def _build_window_variant() -> ctypes.CDLL:
    """``rle_decode.cu`` with binary window searches."""
    out = cuda_build.BUILD_DIR / "sweep" / "librle_decode-window1.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
         "-DSRT_RLE_WINDOW_LANES=1", "-o", str(out),
         str(cuda_build.CSRC_DIR / "rle_decode.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the K4 variant:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.srt_rle_decode.argtypes = [vp, vp, ci, ci, ci, ci, vp, vp]
    lib.srt_rle_decode.restype = ci
    return lib


def k3_compare(rounds: int) -> dict:
    device = torch.device("cuda", torch.cuda.current_device())
    sms = native.sm_count(device)
    rng = np.random.default_rng(6)
    results = {}
    for cap_b, cap_p in K3_SHAPES:
        build, probe = (torch.from_numpy(a).cuda()
                        for a in _probe_inputs(rng, cap_b, cap_p))
        plo, phi = native.searchsorted_u64_pair_plain(build, probe)
        lanes = native.probe_lanes(cap_p, sms)
        arms = {f"{lanes}_lanes": contextlib.nullcontext,
                "binary_walk": lambda: mock.patch.object(
                    native, "probe_lanes", lambda n, s: 1)}
        for arm in arms.values():
            with arm():
                lo, hi = native.searchsorted_u64_pair(build, probe)
                if not (torch.equal(lo, plo) and torch.equal(hi, phi)):
                    raise AssertionError(f"K3 != plain at {cap_b} x {cap_p}")
        label = f"K3 {cap_b}x{cap_p}"
        res = _in_turns(arms, lambda: native.searchsorted_u64_pair(
            build, probe), rounds)
        bf, qf = build ^ INT64_MIN, probe ^ INT64_MIN

        def library():
            torch.searchsorted(bf, qf, side="left")
            torch.searchsorted(bf, qf, side="right")
        res["two_torch_searchsorted"] = {
            "events_ms": [_events_ms(library) for _ in range(rounds)],
            "device_ms": [_graph_ms(library) for _ in range(rounds)]}
        _show(label, res)
        results[label] = res
    return results


def k4_compare(rounds: int, variant: ctypes.CDLL) -> dict:
    rng = np.random.default_rng(7)
    results = {}
    for rows, n, runs, np_type in K4_TABLES:
        vals, ends = (torch.from_numpy(a).cuda()
                      for a in _rle_inputs(rng, rows, n, runs, np_type))
        plain = native.rle_decode_plain(vals, ends, rows, n).view(torch.uint8)
        arms = {"32_lane_windows": contextlib.nullcontext,
                "binary_windows": lambda: mock.patch.object(
                    native, "_RLE_LIB", variant)}
        for arm in arms.values():
            with arm():
                got = native.rle_decode(vals, ends, rows, n)
                if not torch.equal(got.view(torch.uint8), plain):
                    raise AssertionError(f"K4 != plain at {rows} rows, "
                                         f"{runs} runs, {np_type.__name__}")
        label = f"K4 {rows}rows_{runs}runs_{np.dtype(np_type).name}"
        res = _in_turns(arms, lambda: native.rle_decode(vals, ends, rows, n),
                        rounds)
        _show(label, res)
        results[label] = res
    return results


def host_costs() -> None:
    device = torch.device("cuda", torch.cuda.current_device())
    build, probe = (torch.from_numpy(a).cuda() for a in _probe_inputs(
        np.random.default_rng(3), 512, 512))
    n, i32 = probe.numel(), torch.int32
    lo, hi = torch.empty(n, dtype=i32, device=device), \
        torch.empty(n, dtype=i32, device=device)
    vals = torch.zeros(8, dtype=torch.int8, device=device)
    ends = torch.tensor([187_500] + [196_608] * 7, dtype=torch.int32,
                        device=device)
    bf, qf = build ^ INT64_MIN, probe ^ INT64_MIN
    cases = {
        "K3 searchsorted_u64_pair": lambda: native.searchsorted_u64_pair(
            build, probe),
        "K3 join_probe (checks and launch)": lambda: native.join_probe(
            build, probe, lo, hi),
        "two torch.searchsorted": lambda: (
            torch.searchsorted(bf, qf, side="left"),
            torch.searchsorted(bf, qf, side="right")),
        "K4 rle_decode (q3's table)": lambda: native.rle_decode(
            vals, ends, 196_608, 187_500),
        "two torch.empty(n)": lambda: (
            torch.empty(n, dtype=i32, device=device),
            torch.empty(n, dtype=i32, device=device)),
        "torch.empty((2, n)).unbind(0)": lambda: torch.empty(
            (2, n), dtype=i32, device=device).unbind(0),
    }
    for name, fn in cases.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(4000):
                fn()
            best = min(best, (time.perf_counter() - t0) / 4000 * 1e6)
            torch.cuda.synchronize()
        print(f"host {name}: {best:.2f} us a call (best of 3 x 4000)",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--host", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("search_sweep needs a CUDA device")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        shipped = pool.submit(cuda_build.build_all,
                              ["radix_rank", "join_probe", "rle_decode"])
        variant = pool.submit(_build_window_variant)
        shipped.result()
        variant = variant.result()
    if args.host:
        host_costs()
    else:
        out = {"k3": k3_compare(args.rounds),
               "k4": k4_compare(args.rounds, variant)}
        print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
