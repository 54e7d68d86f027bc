"""Port parity: the query flight recorder (``monitoring/recorder.py``,
``chrome.py``, ``analyze.py``, ``syncs.py``), as ``tests/test_trace.py``
pins the JAX package's.

- ``to_chrome`` of one event list equals the reference's, key for key,
  with and without a process tag.
- Recorder units, run through both packages' recorders side by side:
  levels, the ring bound and its drop count, the disabled path recording
  nothing (and returning one shared no-op), the process tag,
  ``record_span``, the snapshot's counts.
- TPC-H q1, q3 and q6 (the reference's ``tpch.generate`` at scale
  0.003, 3 files a table, seed 7) traced through the port: spans well
  formed (every begin has its end, same-thread spans nest), one
  ``collect`` span bracketing every partition span, every event under
  the query's minted id.
- At ``query`` level, the (name, category) multiset of each query's
  events equals the reference's, less the two queueing spans of layers
  the port has not ported (the scheduler's ``admission-queue`` and the
  device semaphore's ``tpu-semaphore-acquire``); under each fault
  schedule of ``tests/test_torch_faults.py`` the instants (name, category,
  args, in order) equal the reference's. The reference runs with its
  cost placement, pipeline and extra partitions off, as the port has
  them.
- Trace-off rows equal trace-on rows, bit for bit, and record nothing;
  the metric shape (operator entries and counter names) is unchanged.
- ``explain_analyze`` prints the reference's node lines, in its tree
  order, with the audit footer and the ``Trace@query`` breakdown.
- ``syncs.install()`` on a stubbed CUDA check records a ``sync`` span per
  funnel with the port's call site, ``Tensor.to`` only toward the CPU;
  every wrapped funnel is restored afterwards.

Tolerance: everything exact except span durations, which are compared by
presence (non-negative, nested).
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import json

import pytest
import torch

from spark_rapids_tpu import faults as jfaults
from spark_rapids_tpu import monitoring as jmon
from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.monitoring import chrome as jchrome
from spark_rapids_tpu.plan import plan_cache as jpc

from spark_rapids_tpu_torch import faults, monitoring
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.memory import oom
from spark_rapids_tpu_torch.monitoring import chrome, syncs, telemetry
from spark_rapids_tpu_torch.plan import plan_cache as pc

VFA = {"spark.rapids.sql.variableFloatAgg.enabled": True}
# The reference's layers the port has not ported, off for the comparison.
REF = dict(VFA, **{"spark.rapids.sql.cost.enabled": False,
                   "spark.rapids.sql.shuffle.partitions": 1})
QUERIES = ("q1", "q3", "q6")
SCHEDULES = {
    "oom": "oom@upload:1,oom@kernel:1,oom@concat:1",
    "corrupt": "corrupt@wire:2,oom@upload:1",
}
def _restore_syncs():
    for owner, name, original, own in reversed(syncs._PATCHED):
        if own:
            setattr(owner, name, original)
        else:
            delattr(owner, name)
    syncs._PATCHED.clear()
    syncs._INSTALLED = False


@pytest.fixture(autouse=True)
def _isolated():
    """Both packages' recorders and registries reset and disarmed around
    every test; any wrapped torch funnel put back."""
    state, jstate = faults.snapshot(), jfaults.snapshot()
    faults.configure("")
    faults.reset_counters()
    monitoring.reset()
    jmon.reset()
    yield
    faults.restore(state)
    jfaults.restore(jstate)
    oom.reset_degradation()
    monitoring.configure(False)
    monitoring.reset()
    monitoring.set_process_tag("")
    jmon.configure(False)
    jmon.reset()
    telemetry.configure(False)
    telemetry.reset()
    _restore_syncs()
    pc.cache().clear()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_trace"))
    jtpch.generate(d, scale=0.003, files_per_table=3, seed=7)
    return d


def _chaos_conf(chaos: str, spill_dir: str) -> dict:
    return {"spark.rapids.sql.test.faults": chaos,
            "spark.rapids.sql.test.faults.seed": 7,
            "spark.rapids.memory.tpu.budgetBytes": 1 << 19,
            "spark.rapids.memory.host.spillStorageSize": 1 << 18,
            "spark.rapids.sql.format.scanCache.maxBytes": 0,
            "spark.rapids.memory.spill.dir": spill_dir}


def _session(trace=True, level="operator", chaos="", spill_dir="", **over):
    conf = dict(VFA)
    conf["spark.rapids.sql.trace.enabled"] = trace
    conf["spark.rapids.sql.trace.level"] = level
    conf["spark.rapids.sql.test.faults"] = chaos
    if chaos:
        conf.update(_chaos_conf(chaos, spill_dir))
    conf.update(over)
    return TpuSession(conf, device="cpu")


def _jsession(level="query", chaos="", spill_dir=""):
    s = JSession(dict(REF))
    s.set("spark.rapids.sql.trace.enabled", True)
    s.set("spark.rapids.sql.trace.level", level)
    s.set("spark.rapids.sql.test.faults", chaos)
    if chaos:
        for k, v in _chaos_conf(chaos, spill_dir).items():
            s.set(k, v)
    return s


def _query_events(df, mon=monitoring):
    qid = df._physical().last_ctx.cache["trace_query"]
    return qid, mon.events(qid)


def _spans(evs):
    return [e for e in evs if e[0] == "X"]


def _instants(evs):
    return [e for e in evs if e[0] == "i"]


def _assert_well_formed(evs):
    assert monitoring.open_span_count() == 0, "unclosed span(s)"
    spans = _spans(evs)
    assert spans, "no spans recorded"
    for e in spans:
        assert e[3] >= 0 and e[4] >= 0, f"bad interval in {e!r}"
    by_tid = {}
    for e in spans:
        by_tid.setdefault(e[5], []).append(e)
    for tid, ss in by_tid.items():
        stack = []
        for e in sorted(ss, key=lambda e: (e[3], -e[4])):
            t0, t1 = e[3], e[3] + e[4]
            while stack and stack[-1] <= t0:
                stack.pop()
            if stack:
                assert t1 <= stack[-1], \
                    f"span {e[1]!r} partially overlaps its parent"
            stack.append(t1)


# ---------------------------------------------------------------------------
# Chrome rendering and recorder units, against the reference
# ---------------------------------------------------------------------------

EVENTS = [
    ("X", "collect", "query", 1_000, 90_000, 11, 3, {"op": "SortExec"}),
    ("X", "upload", "upload", 2_500, 1_500, 11, 3,
     {"bytes": 4096, "rows": 100}),
    ("X", "prefetch", "host-prefetch", 1_200, 7_000, 12, 3,
     {"partition": 0}),
    ("i", "fault-injected", "recovery", 3_000, None, 11, 3,
     {"kind": "oom", "site": "upload"}),
    ("X", "HashAggregateExec", "device-compute", 5_000, 0, 11, 4, None),
    ("i", "oom-rung", "recovery", 6_000, None, 13, 4, {"rung": "shrink"}),
]


@pytest.mark.parametrize("tag", ["", "worker w7"])
def test_to_chrome_matches_reference(tag):
    names = {11: "MainThread", 12: "srt-prefetch_0"}
    assert chrome.to_chrome(EVENTS, names, tag) == \
        jchrome.to_chrome(EVENTS, names, tag)


def _drive(mon, level):
    """One recording sequence, run through a recorder module."""
    mon.configure(True, level, max_events=256)
    with mon.span("a", "device-compute", qid=1):
        with mon.span("b", "upload", level=mon.LEVEL_KERNEL, qid=1):
            pass
    mon.instant("i1", "recovery", args={"x": 1}, qid=1)
    mon.instant("i2", "recovery", qid=1, level=mon.LEVEL_OPERATOR)
    with mon.span("q", "query", level=mon.LEVEL_QUERY, qid=2):
        pass
    mon.record_span("r", "planning", mon.now_ns(), 1_000, qid=2,
                    level=mon.LEVEL_QUERY)
    for _ in range(300):
        mon.instant("flood", "recovery", qid=5)
    snap = mon.snapshot()
    shape = {
        "level": snap["level"], "maxEvents": snap["maxEvents"],
        "categories": {c: v["spans"] for c, v in snap["categories"].items()},
        "instants": snap["instants"],
        "queries": {q: v["events"] for q, v in snap["queries"].items()},
        "droppedEvents": snap["droppedEvents"],
        "openSpans": snap["openSpans"],
        "ids": sorted(mon.query_ids()),
        "names": [(e[0], e[1], e[2], e[6], e[7]) for e in mon.events(1)],
    }
    mon.reset()
    mon.configure(False)
    return shape


@pytest.mark.parametrize("level", ["query", "operator", "kernel"])
def test_recorder_units_match_reference(level):
    from spark_rapids_tpu.monitoring import recorder as jrec
    from spark_rapids_tpu_torch.monitoring import recorder as rec
    lv = rec._LEVEL_NAMES[level]
    got, want = _drive(monitoring, lv), _drive(jmon, lv)
    assert got == want
    assert got["droppedEvents"] == 300 - 256
    assert rec._LEVEL_NAMES == jrec._LEVEL_NAMES


def test_disabled_recorder_records_nothing(data_dir):
    df = tpch.QUERIES["q1"](_session(trace=False), data_dir)
    df.collect()
    assert monitoring.events() == []
    assert not monitoring.enabled()
    assert monitoring.span("a", "b") is monitoring.span("c", "d")
    monitoring.instant("x", "y")
    monitoring.record_span("x", "y", 0, 5)
    assert monitoring.events() == []


def test_process_tag_prefixes_exported_tracks():
    evs = [("X", "stage", "cluster", 1_000, 2_000, 1, 3, None)]
    monitoring.set_process_tag("worker w7")
    doc = chrome.to_chrome(evs, {1: "t"}, monitoring.process_tag())
    names = [e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"]
    assert names == ["worker w7 query 3"]
    monitoring.set_process_tag("")
    doc = chrome.to_chrome(evs, {1: "t"}, monitoring.process_tag())
    assert [e["args"]["name"] for e in doc["traceEvents"]
            if e.get("name") == "process_name"] == ["query 3"]


# ---------------------------------------------------------------------------
# Traced queries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", QUERIES)
def test_spans_well_formed(q, data_dir):
    df = tpch.QUERIES[q](_session(), data_dir)
    df.collect()
    qid, evs = _query_events(df)
    assert qid > 0
    _assert_well_formed(evs)
    collects = [e for e in _spans(evs)
                if e[1] == "collect" and e[2] == "query"]
    assert len(collects) == 1
    c0, c1 = collects[0][3], collects[0][3] + collects[0][4]
    parts = [e for e in _spans(evs) if e[1] == "partition"]
    assert parts
    for e in _spans(evs):
        if e[1] == "admission-queue":
            # The admission wait precedes the collect it admits.
            assert e[3] + e[4] <= c0, e
        else:
            assert c0 <= e[3] and e[3] + e[4] <= c1, e
    assert {e[6] for e in evs} == {qid}
    # Nothing of the query leaked into ring 0 (prefetch threads carry
    # the token).
    assert monitoring.events(0) == []
    cats = {e[2] for e in _spans(evs)}
    assert {"query", "device-compute", "shuffle", "host-prefetch"} <= cats


@pytest.fixture(scope="module")
def reference_events(data_dir, tmp_path_factory):
    """The reference's (name, category) multiset at query level per query,
    and its instants per (query, schedule)."""
    jstate = jfaults.snapshot()
    out = {}
    try:
        for q in QUERIES:
            jfaults.configure("")
            jmon.reset()
            # Recording from the planning on (the plan cache's bind span
            # and instant), on a fresh plan cache.
            jmon.configure(True, jmon.LEVEL_QUERY)
            jpc.cache().clear()
            jtpch.QUERIES[q](_jsession(), data_dir).collect()
            out[q] = sorted((e[1], e[2]) for e in jmon.events())
            for name, sched in SCHEDULES.items():
                jfaults.configure("")
                jmon.reset()
                spill = str(tmp_path_factory.mktemp(f"jspill_{q}_{name}"))
                df = jtpch.QUERIES[q](_jsession(chaos=sched,
                                                spill_dir=spill), data_dir)
                df.collect()
                _, evs = _query_events(df, jmon)
                out[(q, name)] = [(e[1], e[2], e[7])
                                  for e in _instants(evs)]
    finally:
        jfaults.restore(jstate)
        jmon.configure(False)
        jmon.reset()
    return out


@pytest.mark.parametrize("q", QUERIES)
def test_query_level_multiset_matches_reference(q, data_dir,
                                                reference_events):
    monitoring.configure(True, monitoring.LEVEL_QUERY)
    df = tpch.QUERIES[q](_session(level="query"), data_dir)
    df.collect()
    got = sorted((e[1], e[2]) for e in monitoring.events())
    want = reference_events[q]
    assert got == want
    # The scheduler's admission queue and the device semaphore's acquire.
    assert {("admission-queue", "queued"),
            ("tpu-semaphore-acquire", "queued")} <= set(got)
    assert {("collect", "query"), ("plan-bind", "planning"),
            ("plan-cache-miss", "planning")} <= set(got)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("q", QUERIES)
def test_schedule_instants_match_reference(q, schedule, data_dir,
                                           reference_events, tmp_path):
    df = tpch.QUERIES[q](_session(chaos=SCHEDULES[schedule],
                                  spill_dir=str(tmp_path)), data_dir)
    df.collect()
    qid, evs = _query_events(df)
    got = [(e[1], e[2], e[7]) for e in _instants(evs)]
    assert got == reference_events[(q, schedule)]
    assert ("fault-injected", "recovery",
            {"kind": "oom", "site": "upload"}) in got
    assert any(name == "oom-rung" for name, _, _ in got)


# The plan-cache outcome of an execution depends on what ran before it,
# not on tracing (the reference's ``_CACHE_COUNTERS`` leave it out too).
_CACHE_COUNTERS = {"planCacheMiss", "planCacheBindOnly"}


def _metric_shape(metrics: dict):
    return sorted((k.split("@")[0],
                   tuple(sorted(n for n in v if n not in _CACHE_COUNTERS)))
                  for k, v in metrics.items())


@pytest.mark.parametrize("q", QUERIES)
def test_trace_off_identity(q, data_dir):
    nocache = {"spark.rapids.sql.format.scanCache.maxBytes": 0}
    off = tpch.QUERIES[q](_session(trace=False, **nocache), data_dir)
    rows_off = off.collect()
    assert monitoring.events() == []
    on = tpch.QUERIES[q](_session(level="kernel", **nocache), data_dir)
    assert on.collect() == rows_off
    assert monitoring.events() != []
    off2 = tpch.QUERIES[q](_session(trace=False, **nocache), data_dir)
    assert off2.collect() == rows_off
    assert _metric_shape(off.metrics()) == _metric_shape(on.metrics())


def test_trace_export_chrome_q3(data_dir, tmp_path):
    df = tpch.QUERIES["q3"](_session(
        **{"spark.rapids.sql.format.scanCache.maxBytes": 0}), data_dir)
    df.collect()
    path = str(tmp_path / "q3_trace.json")
    doc = df.trace_export(path)
    with open(path) as f:
        assert json.load(f) == doc
    evs = doc["traceEvents"]
    cats = {e.get("cat") for e in evs if e.get("ph") == "X"}
    assert {"query", "host-prefetch", "device-compute", "upload",
            "shuffle"} <= cats, cats
    pnames = [e for e in evs
              if e.get("ph") == "M" and e["name"] == "process_name"]
    assert pnames and all(
        a["args"]["name"].startswith("query ") for a in pnames)
    assert len({e["tid"] for e in evs if e.get("ph") == "X"}) >= 2
    for e in evs:
        if e.get("ph") == "X":
            assert e["dur"] >= 0 and e["ts"] >= 0


def test_snapshot_category_breakdown(data_dir):
    tpch.QUERIES["q6"](_session(), data_dir).collect()
    snap = monitoring.snapshot()
    assert snap["enabled"] and snap["openSpans"] == 0
    cats = snap["categories"]
    assert cats["device-compute"]["ms"] > 0
    assert monitoring.category_breakdown().keys() == cats.keys()


def _node_lines(report: str):
    """The node lines of an explain_analyze report (name and depth)."""
    out = []
    for ln in report.splitlines():
        if "  rows=" not in ln:
            continue
        name = ln.split("  rows=")[0]
        out.append(name)
    return out


@pytest.mark.parametrize("q", QUERIES)
def test_explain_analyze_tree_order_matches_reference(q, data_dir, capsys):
    df = tpch.QUERIES[q](_session(), data_dir)
    df.collect()
    out = df.explain_analyze()
    jdf = jtpch.QUERIES[q](_jsession(level="operator"), data_dir)
    jdf.collect()
    want = jdf.explain_analyze()
    assert _node_lines(out) == _node_lines(want)
    assert "wall=" in out and "bytes=" in out
    assert any("rows=" in ln and "rows=?" not in ln
               for ln in out.splitlines())
    assert "Pipeline@query" in out or "Recovery@query" in out
    qid = df._physical().last_ctx.cache["trace_query"]
    assert f"Trace@query {qid}: " in out and "device-compute=" in out


# ---------------------------------------------------------------------------
# Sync attribution
# ---------------------------------------------------------------------------

def test_syncs_install_on_stubbed_cuda_check(monkeypatch):
    originals = {m: getattr(torch.Tensor, m)
                 for m in syncs._TENSOR_FUNNELS + ("to",)}
    sync_fn = torch.cuda.synchronize
    syncs.install()
    syncs.install()                         # idempotent
    for m, fn in originals.items():
        assert getattr(torch.Tensor, m).__wrapped__ is fn
    assert torch.cuda.synchronize.__wrapped__ is sync_fn
    monitoring.configure(True, monitoring.LEVEL_KERNEL)
    t = torch.tensor([3], dtype=torch.int64)
    t.item()                                # a CPU tensor never syncs
    assert monitoring.events() == []
    monkeypatch.setattr(syncs, "_is_device", lambda x: True)
    assert t.item() == 3
    assert t.tolist() == [3]
    assert int(t) == 3 and float(t) == 3.0 and bool(t)
    assert [1, 2, 3, 4][t] == 4             # __index__
    t.cpu()
    t.numpy()
    t.to("cpu")
    t.to(torch.int32)                       # a dtype: no device move
    t.to(device="cpu", dtype=torch.int32)
    t.to("cpu", non_blocking=True)          # returns at once: no sync
    t.to("cpu", torch.int64, True)
    stats = syncs.sync_stats()
    labels = sorted(k.split(" @ ")[0] for k in stats
                    for _ in range(stats[k][0]))
    assert labels == sorted(["item", "tolist", "__int__", "__float__",
                             "__bool__", "__index__", "cpu", "numpy", "to",
                             "to"])
    assert all(secs >= 0 for _, secs in stats.values())
    # Below kernel level the wrappers record nothing.
    monitoring.reset()
    monitoring.configure(True, monitoring.LEVEL_OPERATOR)
    t.item()
    assert monitoring.events() == []
    _restore_syncs()
    for m, fn in originals.items():
        assert getattr(torch.Tensor, m) is fn
    assert "item" not in torch.Tensor.__dict__
    assert torch.cuda.synchronize is sync_fn


def test_sync_site_names_port_frames(monkeypatch):
    """A sync inside the port is attributed to its two innermost port
    frames."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.batch import shrink_all
    from spark_rapids_tpu_torch.columnar.host import HostBatch, \
        host_to_device
    syncs.install()
    monkeypatch.setattr(syncs, "_is_device", lambda x: True)
    b = host_to_device(HostBatch.from_pydict(
        [("x", dt.INT64)], {"x": list(range(10))}), device="cpu")
    b.rows_hint = None
    monitoring.configure(True, monitoring.LEVEL_KERNEL)
    shrink_all([b])
    stats = syncs.sync_stats()
    assert stats
    site = next(iter(stats))
    assert "columnar/batch.py" in site and "shrink_all" in site
