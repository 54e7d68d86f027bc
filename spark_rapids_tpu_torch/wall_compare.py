"""Walls of TPC-H q1, q3, q4 and q2 at SF1 on the card, by wire codec,
for the port in any source tree.

    python3 spark_rapids_tpu_torch/wall_compare.py [--tree DIR]
        [--codecs v2,plain] [--runs 3] [--label NAME]
        [--kernels | --dataframe [--default-conf] [--queries q1,q7,...]]

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

With ``--kernels`` it times the kernels instead, through the functions
the operators call, so any tree is measured alike:
- K1: ``stable_argsort_u32`` of 786,432 random u32 keys (a q1
  partition's capacity);
- K2: ``segment_minmax_sorted`` min of 131,072 int64 values over
  nondecreasing ids into 131,072 slots (q2's largest K2 launch);
- K3: ``searchsorted_u64_pair`` of 8,192 probe fingerprints in 6,291,456
  sorted build fingerprints with runs of 1-7 and a sentinel tail (q4's
  shape);
- K4: ``rle_decode`` of q3's ``o_shippriority`` table (one run of 0 over
  187,500 rows, 8 table entries, 196,608-row capacity, int8) and of
  917,504 runs over 3,670,016 of 4,194,304 rows in int8 and float64.
Each result is first checked against the tree's plain version (K1
against ``torch.sort``, K2 against ``scatter_reduce_``). ``--runs``
rounds of CUDA-event means over 200 back-to-back calls each; one JSON
line.

With ``--dataframe`` it times TPC-H q1-q6 (or the ``--queries`` named:
any query of the tree's ``benchmarks/tpch.py`` ``QUERIES`` at SF1 or of
its ``benchmarks/suites.py`` ``QUERIES`` at scale 1, such as
``xbb_q5,q67,ds_q89`` or ``xbb_q12,q10,q13,q16,q17,q18,q21``) through the
DataFrame front end
(``TpuSession`` with ``variableFloatAgg`` on, ``benchmarks/tpch.py`` over
``tpch_tables``) beside the hand-built trees of q1-q4 (``entry``), under
the default codec, in this one process: for each query the planning time
of a fresh DataFrame (host ms), the first collect of the hand-built tree
and of the DataFrame's plan, then ``--runs`` rounds of one warm collect of
each in turns (hand-built, DataFrame, DataFrame, hand-built, ...). The
rows of both paths must be equal. One JSON line a query. A tree without
the front end cannot run this mode.

With ``--dataframe --default-conf`` the two paths are q1-q6 through a
``TpuSession()`` with no conf (``variableFloatAgg`` false: float Sum/Avg
aggregates run on the host engine between device subtrees) and through
one with ``variableFloatAgg`` on (every node on the card), timed the
same way in turns in this one process; their rows must agree, floats to
rtol 1e-9 (the host engine sums in another order; a query whose root,
below any limit, is not a sort, as sorted rows). A tree without the host engine refuses the
default conf and cannot run this mode.
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
DATAFRAME_QUERIES = ("q1", "q6", "q3", "q5", "q2", "q4")


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


def _probe_inputs(rng, cap_b: int, cap_p: int):
    """q4-like fingerprints: a sorted build with runs of 1-7 and a sentinel
    tail (40%), probes half hits, half random; int64 bit patterns."""
    import numpy as np
    u64_max = np.iinfo(np.uint64).max
    n_live = cap_b * 3 // 5
    distinct = rng.integers(0, u64_max, n_live, dtype=np.uint64,
                            endpoint=True)
    live = np.sort(np.repeat(distinct, rng.integers(1, 8, n_live))[:n_live])
    build = np.concatenate([live, np.full(cap_b - n_live, u64_max,
                                          np.uint64)])
    probe = np.where(rng.random(cap_p) < 0.5, rng.choice(build, cap_p),
                     rng.integers(0, u64_max, cap_p, dtype=np.uint64,
                                  endpoint=True))
    return build.view(np.int64), probe.view(np.int64)


def _rle_inputs(rng, cap: int, n: int, runs: int, np_type):
    """A run table as the wire encoder builds it: ``runs`` runs over ``n``
    rows, padding runs of value 0 ending at ``cap``, in a table of the
    next power of two of ``runs`` (at least 8) entries."""
    import numpy as np
    run_cap = max(8, 1 << (runs - 1).bit_length())
    vals = np.zeros(run_cap, np_type)
    if runs > 1:
        vals[:runs] = rng.integers(-100, 100, runs).astype(np_type)
    ends = np.full(run_cap, cap, np.int32)
    ends[:runs - 1] = np.sort(rng.choice(np.arange(1, n), runs - 1,
                                         replace=False))
    ends[runs - 1] = n
    return vals, ends


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
    build, probe = (torch.from_numpy(a).cuda()
                    for a in _probe_inputs(rng, 6_291_456, 8_192))
    got = native.searchsorted_u64_pair(build, probe)
    plain = native.searchsorted_u64_pair_plain(build, probe)
    if not all(torch.equal(a, b) for a, b in zip(got, plain)):
        raise AssertionError(f"{label}: K3 differs from its plain version")
    tables = {"q3_196608_int8": (196_608, 187_500, 1, np.int8),
              "4194304_runs917504_int8": (4_194_304, 3_670_016, 917_504,
                                          np.int8),
              "4194304_runs917504_f64": (4_194_304, 3_670_016, 917_504,
                                         np.float64)}
    calls = {"radix_sort_786432_ms": lambda: native.stable_argsort_u32(keys),
             "segment_min_131072_ms": lambda: native.segment_minmax_sorted(
                 vals, gid, cap, "min"),
             "join_probe_6291456x8192_ms": lambda:
                 native.searchsorted_u64_pair(build, probe)}
    for name, (rows, n, nruns, np_type) in tables.items():
        rv, re = (torch.from_numpy(a).cuda()
                  for a in _rle_inputs(rng, rows, n, nruns, np_type))
        got = native.rle_decode(rv, re, rows, n)
        if not torch.equal(got.view(torch.uint8),
                           native.rle_decode_plain(rv, re, rows, n)
                           .view(torch.uint8)):
            raise AssertionError(f"{label}: K4 differs from its plain "
                                 f"version at {name}")
        calls[f"rle_decode_{name}_ms"] = (
            lambda rv=rv, re=re, rows=rows, n=n:
                native.rle_decode(rv, re, rows, n))
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
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--kernels", action="store_true")
    mode.add_argument("--dataframe", action="store_true")
    ap.add_argument("--default-conf", action="store_true",
                    help="with --dataframe: the default conf against "
                    "variableFloatAgg on, instead of the hand-built trees")
    ap.add_argument("--queries", default=",".join(DATAFRAME_QUERIES),
                    help="with --dataframe: the queries to time")
    args = ap.parse_args()
    if args.default_conf and not args.dataframe:
        ap.error("--default-conf goes with --dataframe")
    queries = tuple(args.queries.split(","))
    if queries != DATAFRAME_QUERIES and not args.dataframe:
        ap.error("--queries goes with --dataframe")
    tree = os.path.abspath(args.tree)
    _import_tree(tree)

    import torch
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.ops import ExecContext, cuda_build
    unknown = [q for q in queries if q not in _known_queries()]
    if unknown:
        ap.error(f"--queries: {unknown} not in this tree's tpch.QUERIES or "
                 f"suites.QUERIES ({sorted(_known_queries())})")
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
    if args.dataframe:
        print(f"{label}: kernels built in {build_s:.2f} s, SF1 data in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        _dataframe_walls(label, entry, cols, args.runs, args.default_conf,
                         queries)
        _print_device()
        return 0
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


def _rows_close(a: list, b: list) -> bool:
    """Same rows in the same order: floats within rtol 1e-9, the rest
    exact."""
    import math
    return len(a) == len(b) and all(
        len(ra) == len(rb) and all(
            math.isclose(x, y, rel_tol=1e-9)
            if isinstance(x, float) and isinstance(y, float) else x == y
            for x, y in zip(ra, rb))
        for ra, rb in zip(a, b))


def _known_queries() -> set:
    """The query names of the imported tree's TPC-H and suite modules."""
    from spark_rapids_tpu_torch.benchmarks import tpch
    known = set(tpch.QUERIES)
    try:
        from spark_rapids_tpu_torch.benchmarks import suites
    except ImportError:         # a tree older than the suites
        return known
    return known | set(suites.QUERIES)


def _query_tables(session, cols: dict, queries) -> tuple:
    """(query -> function, query -> table -> DataFrame) of ``queries``:
    TPC-H ones over ``cols``, the suites' ones over their scale-1
    data."""
    import inspect
    from spark_rapids_tpu_torch.benchmarks import tpch
    tq = tuple(q for q in queries if q in tpch.QUERIES)
    # A tree older than the ``queries`` argument builds every query.
    tables = tpch.tpch_tables(session, cols) if tq == DATAFRAME_QUERIES \
        else tpch.tpch_tables(session, cols, tq)
    funcs = dict(tpch.QUERIES)
    sq = tuple(q for q in queries if q not in tpch.QUERIES)
    if sq:
        from spark_rapids_tpu_torch.benchmarks import suites
        args = (session, suites.suite_columns(1.0))
        if "queries" in inspect.signature(suites.suite_tables).parameters:
            args += (sq,)
        tables.update(suites.suite_tables(*args))
        funcs.update(suites.QUERIES)
    return funcs, tables


def _ordered(df) -> bool:
    """Whether ``df``'s rows come in a defined order: its root, below any
    limit, is a sort. Other results compare as multisets."""
    from spark_rapids_tpu_torch.plan import logical as L
    plan = df._plan
    while isinstance(plan, L.LogicalLimit):
        plan = plan.child
    return isinstance(plan, L.LogicalSort)


def _dataframe_walls(label: str, entry, cols: dict, runs: int,
                     default_conf: bool = False,
                     queries=DATAFRAME_QUERIES) -> None:
    import torch
    from spark_rapids_tpu_torch.api import TpuSession
    session = TpuSession({"spark.rapids.sql.variableFloatAgg.enabled": True})
    funcs, tables = _query_tables(session, cols, queries)
    if default_conf:
        dsession = TpuSession()
        _f, dtables = _query_tables(dsession, cols, queries)
    hand = {"q1": lambda: entry.tpch_q1_plan(entry.table_partitions(
        cols["lineitem"], entry.Q1_SCHEMA, entry.TABLE_PARTITIONS[
            "lineitem"]), device="cuda")}
    for q in QUERIES[1:]:
        hand[q] = (lambda q=q: getattr(entry, f"tpch_{q}_plan")(
            getattr(entry, f"tpch_{q}_tables")(cols), device="cuda"))

    def run(collect):
        t0 = time.perf_counter()
        rows = collect()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, rows

    for q in queries:
        t0 = time.perf_counter()
        df = funcs[q](session, tables[q])
        df._physical()
        plan_ms = (time.perf_counter() - t0) * 1e3
        paths = {"dataframe": df.collect}
        ordered = _ordered(df)
        if default_conf:
            ddf = funcs[q](dsession, dtables[q])
            ddf._physical()
            paths = {"default_conf": ddf.collect, **paths}
        elif q in hand:
            paths = {"hand": hand[q]().collect, **paths}
        first, warm, want = {}, {p: [] for p in paths}, None
        for p, collect in paths.items():
            first[p], rows = run(collect)
            if not ordered:
                rows = sorted(rows)
            if want is None:
                want = rows
            elif not (_rows_close(rows, want) if default_conf
                      else rows == want):
                raise AssertionError(f"{q}: {p} rows differ")
        order = list(paths)
        for r in range(runs):
            for p in (order if r % 2 == 0 else order[::-1]):
                warm[p].append(run(paths[p])[0])
        print(json.dumps({"tree": label, "query": q, "plan_ms": plan_ms,
                          "first_s": first, "warm_s": warm}), flush=True)


def _print_device() -> None:
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")


if __name__ == "__main__":
    raise SystemExit(main())
