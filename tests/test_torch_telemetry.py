"""Port parity: the live telemetry plane, the event log, the exporter and
``DataFrame.metrics()`` (``monitoring/telemetry.py``, ``history.py``,
``exporter.py``), as ``tests/test_telemetry.py`` and
``tests/test_observability.py:42-104`` pin the JAX package's.

- The same sequence of ``inc`` / ``observe`` / ``set_gauge`` /
  ``max_gauge`` (escaped labels, histograms across rotated windows)
  renders the same ``render_text`` lines and the same ``snapshot``
  series as the reference, compared over the sequence's own metrics
  (each package also publishes its own counter funnels).
- The registry's rules: kinds are sticky, metrics off records nothing.
- A collect counts ``srt_collects`` / ``srt_collect_ms`` and
  ``srt_queries`` / ``srt_query_latency_ms``; the funnels (pipeline,
  wire, native launches and library calls, plan cache, recovery)
  reconcile with their sources, idempotently.
- The event log: one record per query with the reference's keys (record,
  node and ``render_report`` header), for the same query (TPC-H q1 from
  the reference's ``tpch.generate`` at scale 0.003, seed 7) in both
  packages; nothing is written with the log off.
- The exporter serves ``/metrics`` and ``/healthz`` on an ephemeral
  127.0.0.1 port and stops.
- ``metrics()`` at ESSENTIAL, MODERATE and DEBUG, the audit groups
  (Recovery@query, Pipeline@query, and one registered here) never
  filtered; two DataFrames of one plan-cache template share its
  ``last_ctx``, as the reference's ``BoundPlan`` falls through to its
  template: each shows whichever collected last.

Tolerance: everything exact.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import json
import urllib.request

import pytest

from spark_rapids_tpu import faults as jfaults
from spark_rapids_tpu import monitoring as jmon
from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.monitoring import history as jhistory
from spark_rapids_tpu.monitoring import telemetry as jtel

from spark_rapids_tpu_torch import faults, monitoring
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.monitoring import exporter, history, telemetry
from spark_rapids_tpu_torch.ops import native
from spark_rapids_tpu_torch.ops.base import (
    audit_metric_groups, query_metrics_entry, register_audit_metric_group)
from spark_rapids_tpu_torch.parallel import pipeline
from spark_rapids_tpu_torch.plan import plan_cache as pc

VFA = {"spark.rapids.sql.variableFloatAgg.enabled": True}
REF = dict(VFA, **{"spark.rapids.sql.cost.enabled": False,
                   "spark.rapids.sql.shuffle.partitions": 1})


@pytest.fixture(autouse=True)
def _isolated():
    """Both packages' registries off and empty, event logs unrouted, the
    port's exporter stopped and faults disarmed, around every test."""
    state, jstate = faults.snapshot(), jfaults.snapshot()
    faults.configure("")
    faults.reset_counters()
    for tel in (telemetry, jtel):
        tel.configure(False)
        tel.reset()
    yield
    faults.restore(state)
    jfaults.restore(jstate)
    for tel in (telemetry, jtel):
        tel.configure(False)
        tel.reset()
    history.set_dir("")
    jhistory.set_dir("")
    monitoring.configure(False)
    monitoring.reset()
    jmon.configure(False)
    jmon.reset()
    exporter.stop()
    pc.cache().clear()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_telemetry"))
    jtpch.generate(d, scale=0.003, files_per_table=3, seed=7)
    return d


def _session(**over):
    conf = dict(VFA)
    conf["spark.rapids.sql.metrics.enabled"] = True
    conf.update(over)
    return TpuSession(conf, device="cpu")


# ---------------------------------------------------------------------------
# The registry against the reference's
# ---------------------------------------------------------------------------

def _sequence(tel):
    tel.configure(True)
    tel.inc("srt_t_requests", tenant='a"b\\c\nd')
    tel.inc("srt_t_requests", amount=2.0, tenant="plain")
    tel.inc("srt_t_requests", amount=0.5)
    tel.set_gauge("srt_t_depth", 7)
    tel.set_gauge("srt_t_ratio", 0.42, kind="x")
    tel.max_gauge("srt_t_peak", 5.0)
    tel.max_gauge("srt_t_peak", 3.0)
    tel.max_gauge("srt_t_peak", 9.0)
    tel.describe("srt_t_ms", tel.HISTOGRAM, "a latency")
    for v in range(1, 1001):
        tel.observe("srt_t_ms", float(v))
    tel.observe("srt_t_ms", 0.0, engine="device")
    for _ in range(100):
        tel.observe("srt_t_rot_ms", 1000.0)
    for _ in range(8):
        tel.rotate_windows()
    for _ in range(3):
        tel.observe("srt_t_rot_ms", 10.0)


def _own_lines(text: str):
    """The exposition lines of the sequence's metrics (srt_t_*)."""
    return [ln for ln in text.splitlines()
            if ln.startswith(("srt_t_", "# TYPE srt_t_", "# HELP srt_t_"))]


def test_render_text_matches_reference():
    _sequence(telemetry)
    _sequence(jtel)
    got, want = telemetry.render_text(), jtel.render_text()
    assert _own_lines(got) == _own_lines(want)
    assert len(_own_lines(got)) > 10
    assert got.endswith("# EOF\n")
    assert 'srt_t_requests_total{tenant="a\\"b\\\\c\\nd"} 1' in got


def test_snapshot_matches_reference():
    _sequence(telemetry)
    _sequence(jtel)
    got = {k: v for k, v in telemetry.snapshot()["metrics"].items()
           if k.startswith("srt_t_")}
    want = {k: v for k, v in jtel.snapshot()["metrics"].items()
            if k.startswith("srt_t_")}
    assert json.dumps(got, sort_keys=True) == \
        json.dumps(want, sort_keys=True)
    rot = got["srt_t_rot_ms"]["series"][0]
    assert rot["count"] == 103 and rot["p50"] == pytest.approx(10.0,
                                                               rel=0.25)


def test_metric_kind_is_sticky():
    telemetry.configure(True)
    telemetry.inc("srt_t_kind")
    with pytest.raises(ValueError):
        telemetry.set_gauge("srt_t_kind", 1.0)


def test_metrics_off_records_nothing():
    assert not telemetry.enabled()
    telemetry.inc("srt_t_off")
    telemetry.observe("srt_t_off_ms", 5.0)
    telemetry.set_gauge("srt_t_off_g", 1.0)
    telemetry.max_gauge("srt_t_off_m", 1.0)
    assert telemetry.snapshot()["metrics"] == {}


# ---------------------------------------------------------------------------
# Query instrumentation and funnels
# ---------------------------------------------------------------------------

def _series(name):
    m = telemetry.snapshot()["metrics"].get(name, {"series": []})
    return {tuple(sorted(s["labels"].items())): s for s in m["series"]}


def test_collect_counters(data_dir):
    s = _session()
    tpch.QUERIES["q6"](s, data_dir).collect()
    tpch.QUERIES["q1"](s, data_dir).collect()
    assert _series("srt_collects")[()]["value"] == 2
    assert _series("srt_collect_ms")[()]["count"] == 2
    def q_total():
        return _series("srt_queries")[
            (("class", "-"), ("status", "ok"), ("tenant", "-"))]["value"]
    assert q_total() == 2
    lat = _series("srt_query_latency_ms")[(("class", "-"), ("tenant", "-"))]
    assert lat["count"] == 2 and lat["sum"] > 0
    assert "srt_device_budget_bytes" in telemetry.snapshot()["metrics"]
    # A host-engine collect is a query, not a device collect.
    tpch.QUERIES["q6"](s, data_dir).collect_host()
    assert _series("srt_collects")[()]["value"] == 2
    assert q_total() == 3


def test_funnels_reconcile_with_sources(data_dir):
    tpch.QUERIES["q6"](_session(), data_dir).collect()
    assert _series("srt_pipeline_prefetched_partitions")[()]["value"] == \
        pipeline.counters()["prefetchedPartitions"]
    assert _series("srt_plan_cache_plan_cache_misses")[()]["value"] == \
        pc.counters()["planCacheMisses"]
    assert _series("srt_plan_cache_entries")[()]["value"] == \
        pc.cache().stats()["entries"]
    lib = native.library_counters()
    for k, v in native.counters().items():
        assert _series(f"srt_native_{k}")[()]["value"] == v
    for k, v in lib.items():
        assert _series(f"srt_native_library_{k}")[()]["value"] == v
    # Idempotent: a second sync publishes the same absolutes.
    before = telemetry.snapshot()["metrics"]
    assert telemetry.snapshot()["metrics"] == before


def test_recovery_funnel(data_dir, tmp_path):
    faults.reset_counters()
    s = _session(**{"spark.rapids.sql.test.faults": "oom@upload:1",
                    "spark.rapids.memory.spill.dir": str(tmp_path),
                    "spark.rapids.sql.format.scanCache.maxBytes": 0})
    tpch.QUERIES["q6"](s, data_dir).collect()
    assert _series("srt_recovery_faults_injected")[()]["value"] == 1
    assert _series("srt_recovery_faults_injected")[
        (("sub", "oom@upload"),)]["value"] == 1


# ---------------------------------------------------------------------------
# The event log
# ---------------------------------------------------------------------------

def test_event_log_record_matches_reference(data_dir, tmp_path):
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    over = {"spark.rapids.sql.eventLog.dir": port_dir,
            "spark.rapids.sql.trace.enabled": True}
    tpch.QUERIES["q1"](_session(**over), data_dir).collect()
    tpch.QUERIES["q6"](_session(**over), data_dir).collect()
    recs = history.read_events(port_dir)
    assert len(recs) == 2
    js = JSession(dict(REF, **{
        "spark.rapids.sql.metrics.enabled": True,
        "spark.rapids.sql.eventLog.dir": ref_dir,
        "spark.rapids.sql.trace.enabled": True}))
    jtpch.QUERIES["q1"](js, data_dir).collect()
    (want,) = jhistory.read_events(ref_dir)
    got = recs[0]
    assert sorted(got) == sorted(want)
    assert got["v"] == want["v"] == history.SCHEMA_VERSION
    assert got["status"] == "ok" and got["error"] is None
    assert sorted(got["nodes"][0]) == sorted(want["nodes"][0])
    assert [n["name"] for n in got["nodes"]] == \
        [n["name"] for n in want["nodes"]]
    assert got["categories"] and got["categories"].get("device-compute")
    assert recs[1]["query_id"] == got["query_id"] + 1
    rep, jrep = history.render_report(got), jhistory.render_report(want)
    head = rep.splitlines()[0]
    assert head.startswith(f"query {got['query_id']} [ok] class=- "
                           f"tenant=- wall=")
    assert [ln.split("  rows=")[0] for ln in rep.splitlines()
            if "  rows=" in ln] == \
        [ln.split("  rows=")[0] for ln in jrep.splitlines()
         if "  rows=" in ln]
    assert any(ln.startswith("trace: ") for ln in rep.splitlines())


def test_event_log_off_writes_nothing(data_dir, tmp_path):
    tpch.QUERIES["q6"](_session(), data_dir).collect()
    assert history.log_dir() == ""
    assert list(tmp_path.iterdir()) == []


def test_event_log_chaos_instants_verbatim(data_dir, tmp_path):
    log_dir = str(tmp_path / "events")
    df = tpch.QUERIES["q6"](_session(**{
        "spark.rapids.sql.eventLog.dir": log_dir,
        "spark.rapids.sql.trace.enabled": True,
        "spark.rapids.sql.test.faults": "oom@upload:1",
        "spark.rapids.memory.spill.dir": str(tmp_path),
        "spark.rapids.sql.format.scanCache.maxBytes": 0}), data_dir)
    df.collect()
    qid = df._physical().last_ctx.cache["trace_query"]
    (rec,) = history.read_events(log_dir)
    want = json.loads(json.dumps(
        [[e[1], e[2], e[3], history._json_safe(e[7])]
         for e in monitoring.events(qid) if e[0] == "i"]))
    assert rec["instants"] == want
    assert {i[0] for i in rec["instants"]} == {"fault-injected", "oom-rung"}
    assert rec["metrics"]["Recovery@query"]["faultsInjected"] == 1.0


# ---------------------------------------------------------------------------
# The exporter
# ---------------------------------------------------------------------------

def test_exporter_serves_metrics_over_http():
    telemetry.configure(True)
    telemetry.inc("srt_t_http_hits", amount=3.0)
    port = exporter.ensure_started(0)
    assert port > 0 and exporter.running()
    assert exporter.ensure_started(0) == port          # idempotent
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        body = r.read().decode()
        ctype = r.headers.get("Content-Type", "")
    assert "text/plain" in ctype
    assert "srt_t_http_hits_total 3" in body
    assert body.endswith("# EOF\n")
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
        assert r.status == 200 and r.read() == b"ok"
    exporter.stop()
    assert not exporter.running() and exporter.port() == 0


def test_metrics_port_zero_opens_no_socket(data_dir):
    tpch.QUERIES["q6"](_session(**{"spark.rapids.sql.metrics.port": 0}),
                       data_dir).collect()
    assert not exporter.running()


# ---------------------------------------------------------------------------
# DataFrame.metrics()
# ---------------------------------------------------------------------------

def _source(s):
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    return s.create_dataframe(
        {"k": [1, 2, 2, 3, 3, 3], "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]},
        [("k", dt.INT64), ("v", dt.FLOAT64)])


def _small(s, source=None):
    from spark_rapids_tpu_torch.plan.logical import agg_sum, col
    df = source if source is not None else _source(s)
    return df.group_by("k").agg(agg_sum(col("v")).alias("sv"))


@pytest.mark.parametrize("level,keep", [
    ("ESSENTIAL", {"numOutputRows", "totalTime"}),
    ("MODERATE", {"numOutputRows", "totalTime", "numOutputBatches",
                  "shuffleTime", "bufferTime"}),
    ("DEBUG", None)])
def test_metrics_levels_with_audit_groups_exempt(level, keep):
    assert {"Recovery", "Pipeline"} <= audit_metric_groups()
    s = TpuSession(dict(VFA, **{"spark.rapids.sql.metrics.level": level}),
                   device="cpu")
    df = _small(s)
    assert df.metrics() == {}
    df.collect()
    ctx = df._physical().last_ctx
    query_metrics_entry(ctx, "Recovery").add("stageRecomputes", 1)
    query_metrics_entry(ctx, "MyPlugin").add("customCounter", 3)
    register_audit_metric_group("MyPlugin")             # idempotent
    assert "MyPlugin" in audit_metric_groups()
    m = df.metrics()
    agg = next(v for k, v in m.items() if "HashAggregate" in k)
    assert agg
    if keep is not None:
        assert set(agg) <= keep
    else:
        assert "totalTime" in agg
    assert m["Recovery@query"]["stageRecomputes"] == 1
    assert m["MyPlugin@query"]["customCounter"] == 3


def test_last_ctx_shared_by_one_template():
    """Two DataFrames of one shape bind one plan-cache template; its
    last_ctx is the last collect's, so both show the same metrics (the
    reference's BoundPlan falls through to its template the same way)."""
    s = TpuSession(dict(VFA), device="cpu")
    src = _source(s)
    a, b = _small(s, src), _small(s, src)
    assert a._physical().template is b._physical().template
    a.collect()
    ctx_a = a._physical().last_ctx
    b.collect()
    assert a._physical().last_ctx is b._physical().last_ctx
    assert a._physical().last_ctx is not ctx_a
    assert a.metrics() == b.metrics()
