"""The cost model's machine constants, measured on the card, the
host-against-device break-even of a q6-shaped aggregate, and the walls of
q1-q6 with placement on and off.

    python3 -m spark_rapids_tpu_torch.cost_sweep [--scale 1.0]
        [--sweep 0.001,0.003,0.01,0.03,0.1,0.3,1.0] [--rounds 3]
        [--placement 0.01,0.1,1.0] [--out cost_sweep.json]

1. TPC-H at ``--scale`` (``entry.tpch_columns``) is written to parquet
   with pyarrow, one file a partition of ``entry.TABLE_PARTITIONS``
   (only the columns of q1 and q6: LINEITEM).
2. q1 and q6 from the files with the flight recorder on at ``kernel``
   level and the sync attribution installed, scan cache off, placement
   off: the mean of the ``sync`` spans (``plan/cost.py``
   ``span_observations``; it misses the waits inside data-dependent ops,
   which have no funnel to wrap, ``monitoring/syncs.py``) and upload
   bytes over upload span time.
3. The host engine's rate on q6 at ``--scale``: the model charges each
   node 0.5 ms plus its input bytes over the rate, so the rate is the
   plan's summed node bytes (``estimate_plan``) over the measured host
   wall less 0.5 ms a node.
4. The sweep: LINEITEM prefixes of ``sf / scale`` of its rows (each
   point's rows are the first rows of the ``--scale`` table, so every
   column keeps its distribution) written as their own parquet files,
   and q6 over each, host engine (``collect_host``) against device
   (placement off, scan cache off), in turns, ``--rounds`` rounds, in one
   process; the medians. The measured break-even is where the two walls
   cross (log-linear between points); the model's is where its root
   estimates cross at the measured constants with no query floor (the
   JAX package's model), and ``deviceQueryFloorMs`` is fitted so the
   model's estimates cross at the measured break-even. The defaults'
   break-even is where the model at the conf defaults crosses.
5. With ``--placement``: TPC-H at each listed scale, written to parquet,
   and q1-q6 under the default conf with placement on and off, both with
   the scan cache off (every run reads the files) and then both with it
   on and warm: rows equal, then ``--rounds`` rounds in alternating
   order (on, off; off, on; ...), medians. Placement runs at the
   constants step 4 measured and fitted, given as explicit keys, unless
   ``--defaults``.

Prints the card's name and power limit first, then one JSON object
(also to ``--out``). Needs a card; builds the kernels first.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

SWEEP = (0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0)
NO_CACHE = {"spark.rapids.sql.format.scanCache.maxBytes": 0}
VFA = {"spark.rapids.sql.variableFloatAgg.enabled": True}


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def write_tables(cols: dict, data_dir: str, queries, rows=None) -> dict:
    """The columns ``queries`` read of each table, as parquet under
    ``data_dir/<table>/``, one file a partition; ``rows`` (table -> n)
    keeps the first n rows of a table. Returns table -> rows written."""
    import pyarrow.parquet as papq
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.io.arrow_convert import host_batch_to_arrow
    types: dict = {}
    for q in queries:
        for t, schema in tpch.SCANS[q].items():
            types.setdefault(t, {}).update(schema)
    out = {}
    for t, have in types.items():
        schema = tuple((n, have[n]) for n in cols[t] if n in have)
        n = len(cols[t][schema[0][0]])
        keep = n if rows is None or t not in rows else min(rows[t], n)
        tcols = {c: cols[t][c][:keep] for c, _ in schema}
        parts = E.table_partitions(tcols, schema, E.TABLE_PARTITIONS[t])
        os.makedirs(os.path.join(data_dir, t), exist_ok=True)
        for i, part in enumerate(parts):
            for j, hb in enumerate(part):
                papq.write_table(host_batch_to_arrow(hb), os.path.join(
                    data_dir, t, f"part-{i:04d}-{j:02d}.parquet"))
        out[t] = keep
    return out


def node_bytes_and_count(plan, conf, device) -> tuple:
    """(the summed input bytes the model moves over all nodes, the node
    count) of one (pruned) logical plan: read off the host estimate at
    1 GB/s."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.plan import cost as COST
    probe = C.TpuConf(dict(conf.raw, **{
        C.COST_HOST_GBPS.key: 1.0}))
    ests = COST.estimate_plan(plan, probe, device=device)
    root = ests[id(plan)]
    nodes = len(ests)
    return (root.host_ms - 0.5 * nodes) * 1e6, nodes


def _synced_ms(fn, torch) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def measure_constants(data_dir: str, device) -> dict:
    """Step 2 and 3 of the module doc on the files of ``data_dir``."""
    import torch
    from spark_rapids_tpu_torch import monitoring
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.monitoring import syncs
    from spark_rapids_tpu_torch.plan import cost as COST
    syncs.install()
    traced = dict(VFA, **NO_CACHE, **{
        "spark.rapids.sql.cost.enabled": False,
        "spark.rapids.sql.trace.enabled": True,
        "spark.rapids.sql.trace.level": "kernel"})
    evs_all, per_query = [], {}
    try:
        for q in ("q1", "q6"):
            df = tpch.QUERIES[q](TpuSession(traced, device=device),
                                 data_dir)
            wall = _synced_ms(df.collect, torch)
            evs = monitoring.events(
                df._physical().last_ctx.cache["trace_query"])
            evs_all += evs
            sync_ms, gbps = COST.span_observations(evs)
            per_query[q] = dict(wall_ms=wall, sync_mean_ms=sync_ms,
                                upload_gbps=gbps)
    finally:
        monitoring.configure(False)
        monitoring.reset()
    sync_mean, dev_gbps = COST.span_observations(evs_all)
    spans = [e for e in evs_all if e[0] == "X"]
    n_syncs = sum(1 for e in spans if e[2] == "sync")
    up_bytes = sum(float((e[7] or {}).get("bytes") or 0) for e in spans
                   if e[2] == "upload")
    # The host engine's rate on q6.
    s = TpuSession(dict(VFA, **NO_CACHE), device=device)
    df = tpch.QUERIES["q6"](s, data_dir)
    df.collect_host()                       # warm the footers and imports
    walls = [_synced_ms(df.collect_host, torch) for _ in range(3)]
    host_ms = statistics.median(walls)
    moved, nodes = node_bytes_and_count(df._physical().meta.plan, s.conf,
                                        device)
    host_gbps = moved / ((host_ms - 0.5 * nodes) / 1e3) / 1e9
    COST.reset_calibration()
    return dict(sync_mean_ms=sync_mean, syncs=n_syncs,
                device_gbps=dev_gbps, upload_bytes=up_bytes,
                host_gbps=host_gbps, host_q6_ms=host_ms,
                host_q6_walls_ms=walls, model_bytes=moved,
                model_nodes=nodes, per_query=per_query)


def _crossing(xs, host, dev):
    """The x where ``host - dev`` changes sign (log-linear between the
    two points that bracket it), or None."""
    for i in range(1, len(xs)):
        a, b = host[i - 1] - dev[i - 1], host[i] - dev[i]
        if a == 0:
            return xs[i - 1]
        if (a < 0) != (b < 0):
            la, lb = math.log(xs[i - 1]), math.log(xs[i])
            return math.exp(la + (lb - la) * a / (a - b))
    return None


def sweep(cols: dict, root: str, scale: float, scales, rounds: int,
          device, consts: dict, full_dir: str = "") -> dict:
    """Step 4 of the module doc; the point at ``scale`` reads
    ``full_dir`` where given (the whole table is already there)."""
    import torch
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.plan import cost as COST
    n_all = len(cols["lineitem"]["l_orderkey"])
    points = []
    for sf in scales:
        d = os.path.join(root, f"sf{sf}")
        rows = max(int(round(n_all * sf / scale)), 1)
        if full_dir and rows == n_all:
            d = full_dir
        else:
            write_tables(cols, d, ("q6",), rows={"lineitem": rows})
        host_s = TpuSession(dict(VFA, **NO_CACHE), device=device)
        dev_s = TpuSession(dict(VFA, **NO_CACHE, **{
            "spark.rapids.sql.cost.enabled": False}), device=device)
        host_df, dev_df = tpch.q6(host_s, d), tpch.q6(dev_s, d)
        want = host_df.collect_host()
        got = dev_df.collect()
        if len(got) != len(want) or (want and not math.isclose(
                got[0][0] or 0.0, want[0][0] or 0.0, rel_tol=1e-9)):
            raise AssertionError(f"sf {sf}: device {got} != host {want}")
        hw, dw = [], []
        for r in range(rounds):
            order = (("host", "dev") if r % 2 == 0 else ("dev", "host"))
            for which in order:
                if which == "host":
                    hw.append(_synced_ms(host_df.collect_host, torch))
                else:
                    dw.append(_synced_ms(dev_df.collect, torch))
        model_conf = C.TpuConf(dict(host_s.conf.raw, **{
            C.COST_SYNC_FLOOR_MS.key: consts["floor_ms"],
            C.COST_QUERY_FLOOR_MS.key: 0.0,
            C.COST_DEVICE_GBPS.key: consts["device_gbps"],
            C.COST_HOST_GBPS.key: consts["host_gbps"]}))
        plan = host_df._physical().meta.plan    # pruned, as placed
        est = COST.estimate_plan(plan, model_conf, device=device)[id(plan)]
        dflt = C.TpuConf(host_s.conf.raw)
        d_est = COST.estimate_plan(plan, dflt, device=device)[id(plan)]
        points.append(dict(sf=sf, rows=rows, bytes=est.subtree_bytes,
                           syncs=est.syncs, host_ms=statistics.median(hw),
                           device_ms=statistics.median(dw),
                           host_walls_ms=hw, device_walls_ms=dw,
                           model_host_ms=est.host_ms,
                           model_device_ms=est.device_ms,
                           default_host_ms=d_est.host_ms,
                           default_device_ms=d_est.device_ms +
                           COST.effective_query_floor_ms(dflt, device)))
        if d != full_dir:
            shutil.rmtree(d, ignore_errors=True)
    xs = [p["sf"] for p in points]

    def cross(h, dv):
        return _crossing(xs, [p[h] for p in points],
                         [p[dv] for p in points])
    return dict(points=points,
                measured_break_even_sf=cross("host_ms", "device_ms"),
                model_break_even_sf=cross("model_host_ms",
                                          "model_device_ms"),
                default_break_even_sf=cross("default_host_ms",
                                            "default_device_ms"))


def run(cols: dict, scale: float, scales, rounds: int, device,
        work_dir: str, data_dir: str = "") -> dict:
    """Steps 1-4 of the module doc; the kernels must be built.
    ``data_dir`` may hold the tables already (at least q1's and q6's
    columns of LINEITEM at ``scale``)."""
    from spark_rapids_tpu_torch import config as C
    if not data_dir:
        data_dir = os.path.join(work_dir, "tpch")
        write_tables(cols, data_dir, ("q1", "q6"))
    m = measure_constants(data_dir, device)
    floor = m["sync_mean_ms"] if m["sync_mean_ms"] is not None \
        else float(C.COST_SYNC_FLOOR_MS.default)
    consts = dict(floor_ms=floor, device_gbps=m["device_gbps"],
                  host_gbps=m["host_gbps"])
    sw = sweep(cols, work_dir, scale, scales, rounds, device, consts,
               full_dir=data_dir)
    out = dict(constants=m, model_constants=consts, sweep=sw)
    meas = sw["measured_break_even_sf"]
    if meas is not None:
        out["fitted_query_floor_ms"] = fitted_query_floor(sw["points"],
                                                          meas)
    return out


def fitted_query_floor(points: list, at_sf: float) -> float:
    """The query floor under which the model's root estimates cross at
    ``at_sf``: it is charged once at the root, so at each point the
    floor that makes the device estimate equal the host estimate is
    their difference without it, log-interpolated at the break-even."""
    def at(p):
        return p["model_host_ms"] - p["model_device_ms"]
    xs = [p["sf"] for p in points]
    for i in range(1, len(xs)):
        if xs[i - 1] <= at_sf <= xs[i]:
            t = (math.log(at_sf) - math.log(xs[i - 1])) / \
                (math.log(xs[i]) - math.log(xs[i - 1]))
            return at(points[i - 1]) + t * (at(points[i]) -
                                             at(points[i - 1]))
    raise ValueError(f"break-even sf {at_sf} outside the sweep")


def _rows_match(a: list, b: list) -> bool:
    """Rows equal, floats within 1e-9 relative (the two engines sum in
    different orders)."""
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                if not math.isclose(x, y, rel_tol=1e-9, abs_tol=1e-9):
                    return False
            elif x != y:
                return False
    return True


def placement_ab(scales, queries, rounds: int, device, work_dir: str,
                 consts: dict) -> list:
    """Step 5 of the module doc; ``consts`` are explicit ``cost.*`` keys
    (empty: the conf defaults)."""
    import torch
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.ops import native
    out = []
    for sf in scales:
        d = os.path.join(work_dir, f"ab{sf}")
        write_tables(E.tpch_columns(sf), d, queries)
        for cache, extra in (("off", NO_CACHE), ("on", {})):
            for q in queries:
                base = dict(consts, **extra)
                dfs = {"on": tpch.QUERIES[q](TpuSession(base, device=device),
                                             d),
                       "off": tpch.QUERIES[q](TpuSession(dict(base, **{
                           "spark.rapids.sql.cost.enabled": False}),
                           device=device), d)}
                rows, launches = {}, {}
                for label, df in dfs.items():       # warm-up, launches
                    native.reset_counters()
                    rows[label] = df.collect()
                    torch.cuda.synchronize()
                    launches[label] = native.counters()
                if not _rows_match(rows["on"], rows["off"]):
                    raise AssertionError(f"{q} at sf {sf}: placement on "
                                         f"{rows['on'][:3]} != off "
                                         f"{rows['off'][:3]}")
                walls = {"on": [], "off": []}
                for r in range(rounds):
                    for label in (("on", "off") if r % 2 == 0
                                  else ("off", "on")):
                        walls[label].append(
                            _synced_ms(dfs[label].collect, torch))
                rep = dfs["on"]._physical().cost_report
                pt = dict(sf=sf, query=q, scan_cache=cache,
                          placements=rep.placements,
                          nodes_host_placed=rep.nodes_host_placed,
                          est_device_ms=rep.est_device_ms,
                          est_host_ms=rep.est_host_ms,
                          root_on_device=dfs["on"]._physical()
                          .root_on_device,
                          on_ms=statistics.median(walls["on"]),
                          off_ms=statistics.median(walls["off"]),
                          on_walls_ms=walls["on"], off_walls_ms=walls["off"],
                          launches=launches, rows=len(rows["on"]))
                print(f"placement sf {sf} {q} scan cache {cache}: "
                      f"{rep.placements} placement(s), "
                      f"{rep.nodes_host_placed} node(s), root on the "
                      f"{'device' if pt['root_on_device'] else 'host'}; "
                      f"on {pt['on_ms']:.3f} ms, off {pt['off_ms']:.3f} ms "
                      f"(on/off {pt['on_ms'] / pt['off_ms']:.3f}); "
                      f"launches {launches}", flush=True)
                out.append(pt)
        shutil.rmtree(d, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--sweep", default=",".join(str(s) for s in SWEEP))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--placement", default="",
                    help="scales for step 5 (empty: skip it)")
    ap.add_argument("--queries", default="q1,q2,q3,q4,q5,q6")
    ap.add_argument("--defaults", action="store_true",
                    help="step 5 at the conf defaults")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("cost_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.ops import cuda_build
    smi = _smi()
    print(f"card: {smi}", flush=True)
    cuda_build.build_all(["radix_rank", "join_probe", "seg_scan",
                          "rle_decode"])
    cols = entry.tpch_columns(args.scale)
    work = tempfile.mkdtemp(prefix="srt_cost_sweep_")
    try:
        out = run(cols, args.scale,
                  [float(s) for s in args.sweep.split(",")], args.rounds,
                  None, work)
        print(f"constants {out['model_constants']}, fitted query floor "
              f"{out.get('fitted_query_floor_ms')} ms; break-even sf "
              f"measured {out['sweep']['measured_break_even_sf']}, "
              f"defaults {out['sweep']['default_break_even_sf']}",
              flush=True)
        if args.placement:
            from spark_rapids_tpu_torch import config as C
            mc = out["model_constants"]
            consts = {} if args.defaults else {
                C.COST_SYNC_FLOOR_MS.key: mc["floor_ms"],
                C.COST_DEVICE_GBPS.key: mc["device_gbps"],
                C.COST_HOST_GBPS.key: mc["host_gbps"],
                C.COST_QUERY_FLOOR_MS.key: out.get(
                    "fitted_query_floor_ms",
                    C.COST_QUERY_FLOOR_MS.default)}
            out["placement_consts"] = consts
            out["placement"] = placement_ab(
                [float(s) for s in args.placement.split(",")],
                args.queries.split(","), args.rounds, None, work, consts)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["card"] = smi
    text = json.dumps(out, default=float)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
