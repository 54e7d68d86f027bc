"""Port parity: the fault-injection registry and the query token
(``spark_rapids_tpu_torch/faults.py``), as ``tests/test_chaos.py``'s
``TestFaultRegistry`` and its ``oom`` / ``corrupt`` schedules pin the JAX
package's.

- The same specs parse to the same fields in both packages (and the same
  bad specs raise); the same schedule and seed fire on the same hits and
  flip the same byte; the injected OOM routes into the port's ladder.
- TPC-H q1, q3 and q6 (the reference's ``tpch.generate`` at scale 0.003,
  3 files a table, seed 7) under the reference's three schedules
  (``oom``, ``transient``, ``corrupt``) give their fault-free rows bit
  for bit, with ``faultsInjected`` in ``Recovery@query`` (a query the
  transient schedule retried on a fresh context holds that attempt's
  counts, and ``retriesAttempted``). With a device budget that puts spill
  frames on disk, one flipped frame is detected and re-read
  (``corruptionsDetected`` 1, rows bit for bit); two flips of the same
  frame (its read and its re-read) recompute the exchange's stage with
  the defaults, and fail loudly with stage recompute and the transient
  retry off.
- ``/query=N`` arming fires only in the query with that minted id (or
  that ``queryTag``); ids increase by one per owned top-level collect.
- The plan cache is bypassed while a schedule is armed.
- A ``scan`` fault raised on a pipeline prefetch thread or a MULTITHREADED
  reader thread re-raises out of ``collect`` with the transient retry off,
  filed under the query's ring (the token crossed the thread); with the
  defaults the retry recovers the query.

Tolerance: everything exact (rows compared with ``==``, floats by value).
Each test disarms the port's registry and restores its counters.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import pytest

from spark_rapids_tpu import faults as jfaults
from spark_rapids_tpu.benchmarks import tpch as jtpch

from spark_rapids_tpu_torch import faults, monitoring
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.columnar.wire import WireCorruptionError
from spark_rapids_tpu_torch.memory import oom
from spark_rapids_tpu_torch.monitoring import telemetry
from spark_rapids_tpu_torch.plan import plan_cache as pc
from spark_rapids_tpu_torch.plan.plan_cache import BoundPlan

VFA = {"spark.rapids.sql.variableFloatAgg.enabled": True}
QUERIES = ("q1", "q3", "q6")
SCHEDULES = {
    "oom": "oom@upload:1,oom@kernel:1,oom@concat:1",
    "transient": ("transient@exchange.flush:1,transient@download:1,"
                  "oom@kernel:1"),
    "corrupt": "corrupt@wire:2,oom@upload:1,transient@exchange.serve:1",
}
# Stage recompute and the transient retry off: the error reaches the
# caller.
NO_RECOVERY = {"spark.rapids.sql.recovery.stageRecompute.enabled": False,
               "spark.rapids.sql.retry.transientMaxRetries": 0}


@pytest.fixture(autouse=True)
def _isolated():
    """Disarm the port's process-global registry (and restore its
    counters), reset the recorder and telemetry, and the degraded batch
    target, around every test."""
    state = faults.snapshot()
    faults.configure("")
    faults.reset_counters()
    oom.reset_degradation()
    oom.set_active_catalog(None)
    yield
    faults.restore(state)
    oom.reset_degradation()
    monitoring.configure(False)
    monitoring.reset()
    telemetry.configure(False)
    telemetry.reset()
    pc.cache().clear()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_faults"))
    jtpch.generate(d, scale=0.003, files_per_table=3, seed=7)
    return d


def _session(chaos: str = "", spill_dir: str = "",
             device_budget: int = 1 << 19, host_budget: int = 1 << 18,
             **over):
    conf = dict(VFA)
    conf["spark.rapids.sql.test.faults"] = chaos
    conf["spark.rapids.sql.test.faults.seed"] = 7
    conf["spark.rapids.sql.retry.backoffMs"] = 1
    if chaos:
        # The reference chaos session's pressure: small spill tiers, no
        # device scan cache (the upload funnel runs every query).
        conf["spark.rapids.memory.tpu.budgetBytes"] = device_budget
        conf["spark.rapids.memory.host.spillStorageSize"] = host_budget
        conf["spark.rapids.sql.format.scanCache.maxBytes"] = 0
        if spill_dir:
            conf["spark.rapids.memory.spill.dir"] = spill_dir
    conf.update(over)
    return TpuSession(conf, device="cpu")


@pytest.fixture(scope="module")
def baselines(data_dir):
    """Fault-free device rows per query (the bit-identity oracle)."""
    state = faults.snapshot()
    faults.configure("")
    try:
        return {q: tpch.QUERIES[q](_session(), data_dir).collect()
                for q in QUERIES}
    finally:
        faults.restore(state)


# ---------------------------------------------------------------------------
# The registry against the reference's
# ---------------------------------------------------------------------------

SPECS = [
    "oom@upload:0.05, transient@exchange.flush:2 ,corrupt@wire",
    "oom@upload/query=3:2,stall@kernel:0.5,lostoutput@exchange.serve",
    "lostshard@transport:1,workerdeath@cluster.stage,slowput@transport.write"
    ":0.25,unavailable@objectstore:3",
    "OOM@scan:1.0",
    "",
]
BAD_SPECS = ["oops@upload", "oom@", "oom@x:0", "oom@x:1.5", "justtext",
             "oom@x/q=1:1", "oom@x/query=a:1", "oom@:1"]


def _fields(entries):
    return [(e.kind, e.site, e.count, e.probability, e.query)
            for e in entries]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_parses_as_reference(spec):
    assert _fields(faults.parse_spec(spec)) == \
        _fields(jfaults.parse_spec(spec))


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_spec_raises_as_reference(spec):
    with pytest.raises(jfaults.FaultParseError):
        jfaults.parse_spec(spec)
    with pytest.raises(faults.FaultParseError):
        faults.parse_spec(spec)


@pytest.mark.parametrize("spec,seed", [
    ("oom@k:2", 1), ("oom@k:0.3", 7), ("oom@k:0.3", 8),
    ("oom@k:0.5,transient@k:1,oom@j:0.1", 3),
    ("oom@k/query=2:0.6,oom@k:1", 11)])
def test_firing_sequence_matches_reference(spec, seed):
    """Hit by hit, across sites, kinds and query tags: the same entries
    fire in both registries."""
    ours = faults.FaultInjector(spec, seed)
    ref = jfaults.FaultInjector(spec, seed)
    got, want = [], []
    for i in range(300):
        site = "kj"[i % 3 == 0]
        kinds = ("oom",) if i % 5 else ("oom", "transient")
        query = (None, 1, 2)[i % 3]
        a = ours.should_fire(site, kinds, query)
        b = ref.should_fire(site, kinds, query)
        got.append(None if a is None else (a.kind, a.site))
        want.append(None if b is None else (b.kind, b.site))
    assert got == want
    assert any(got)


def test_count_faults_fire_first_n_hits():
    inj = faults.FaultInjector("oom@k:2", seed=1)
    fired = [inj.should_fire("k", ("oom",)) is not None for _ in range(5)]
    assert fired == [True, True, False, False, False]


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_corrupt_blob_flips_reference_byte(seed):
    blob = bytes(range(256)) * 7
    jstate = jfaults.snapshot()
    try:
        faults.configure("corrupt@wire:3", seed)
        jfaults.configure("corrupt@wire:3", seed)
        for _ in range(4):
            assert faults.corrupt_blob("wire", blob) == \
                jfaults.corrupt_blob("wire", blob)
        assert faults.counters()["faultsInjected.corrupt@wire"] == 3
    finally:
        jfaults.restore(jstate)


def test_disarmed_fault_point_is_noop():
    faults.configure("")
    faults.fault_point("upload")
    assert faults.corrupt_blob("wire", b"abc") == b"abc"
    assert faults.check_fault("upload", ("oom",)) is None


def test_fault_point_raises_typed_errors():
    faults.configure("oom@a:1,transient@b:1,lostoutput@c:1", seed=0)
    with pytest.raises(faults.InjectedOomError) as e:
        faults.fault_point("a")
    # The reference's RESOURCE_EXHAUSTED text, and the port's marker.
    assert "RESOURCE_EXHAUSTED" in str(e.value)
    assert oom.is_oom_error(e.value)
    with pytest.raises(faults.InjectedTransientError) as t:
        faults.fault_point("b")
    assert not oom.is_oom_error(t.value)
    with pytest.raises(faults.InjectedLostOutputError) as lo:
        faults.fault_point("c", owner=42)
    assert lo.value.fault_owner == 42


def test_stall_unwinds_on_cancel_event():
    import threading
    faults.configure("stall@k:1", seed=0)
    ev = threading.Event()
    ev.set()
    faults.set_cancel_event(ev)
    try:
        with pytest.raises(faults.InjectedStallError):
            faults.fault_point("k")
    finally:
        faults.set_cancel_event(None)


def test_cancelled_token_unwinds_at_fault_point():
    tok = faults.new_query_token()
    faults.set_query_token(tok)
    try:
        faults.fault_point("upload")
        tok.request_cancel("test")
        with pytest.raises(faults.QueryCancelledError):
            faults.fault_point("upload")
    finally:
        faults.set_query_token(None)


def test_injected_oom_walks_the_ladder():
    """An injected OOM inside retry_on_oom walks the ladder (nothing to
    spill here: the shrink rung acts) and the retry succeeds."""
    faults.configure("oom@kernel:1", seed=0)
    from spark_rapids_tpu_torch.ops import kernel_cache as kc
    assert kc.call(lambda x: x + 1, 41) == 42
    c = faults.counters()
    assert c["faultsInjected"] == 1 and c["retriesAttempted"] == 1
    assert oom.last_ladder == ["shrink"]


# ---------------------------------------------------------------------------
# TPC-H under the schedules: bit-identical to the fault-free run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("q", QUERIES)
def test_tpch_bit_identical_under_faults(q, schedule, baselines, data_dir,
                                         tmp_path):
    faults.reset_counters()
    df = tpch.QUERIES[q](_session(SCHEDULES[schedule], str(tmp_path)),
                         data_dir)
    assert not isinstance(df._physical(), BoundPlan)   # cache bypassed
    got = df.collect()
    c = faults.counters()
    assert c.get("faultsInjected", 0) > 0, c
    assert got == baselines[q]
    rec = df.metrics()["Recovery@query"]
    assert c.get("spillEscalations", 0) >= 1, c
    if c.get("retriesAttempted", 0) > rec.get("retriesAttempted", 0):
        # A retry on a fresh context: its Recovery@query holds the last
        # attempt's counts.
        assert rec["retriesAttempted"] >= 1
        assert rec.get("faultsInjected", 0) <= c["faultsInjected"]
    else:
        assert rec["faultsInjected"] == c["faultsInjected"]
        assert rec["spillEscalations"] >= 1


def test_disk_frame_corruption_recovered(baselines, data_dir, tmp_path):
    """A device budget of 2 KiB and no host tier put q1's exchange pieces
    on disk: one flipped frame is detected by its CRC and re-read."""
    df = tpch.QUERIES["q1"](_session(
        "corrupt@wire:1,oom@upload:1", str(tmp_path), device_budget=2048,
        host_budget=0), data_dir)
    assert df.collect() == baselines["q1"]
    ctx = df._physical().last_ctx
    assert ctx.last_spill_metrics["restore_from_disk"] > 0
    assert ctx.last_spill_metrics["corruption_detected"] == 1
    rec = df.metrics()["Recovery@query"]
    assert rec["corruptionsDetected"] == 1
    assert rec["faultsInjected.corrupt@wire"] == 1
    assert ctx.last_leak_report == []


def test_disk_frame_corrupted_twice_fails_loudly(data_dir, tmp_path):
    """``corrupt@wire:2`` flips the first frame's read AND its re-read:
    with stage recompute and the transient retry off the query raises
    rather than decode wrong bytes."""
    df = tpch.QUERIES["q1"](_session(
        "corrupt@wire:2", str(tmp_path), device_budget=2048,
        host_budget=0, **NO_RECOVERY), data_dir)
    with pytest.raises(WireCorruptionError):
        df.collect()


def test_disk_frame_corrupted_twice_recomputes_stage(baselines, data_dir,
                                                     tmp_path):
    """With the defaults the twice-flipped frame's exchange, which tagged
    the failed read with its id, recomputes its stage once: rows bit for
    bit, no leak."""
    df = tpch.QUERIES["q1"](_session(
        "corrupt@wire:2", str(tmp_path), device_budget=2048,
        host_budget=0), data_dir)
    assert df.collect() == baselines["q1"]
    rec = df.metrics()["Recovery@query"]
    assert rec["corruptionsDetected"] == 2
    assert rec["stageRecomputes"] == 1
    assert faults.counters()["stageRecomputes"] == 1
    assert df._physical().last_ctx.last_leak_report == []


# ---------------------------------------------------------------------------
# Query tokens and query-scoped arming
# ---------------------------------------------------------------------------

def _qid(df):
    return df._physical().last_ctx.cache["trace_query"]


def test_query_ids_increase_per_collect(data_dir):
    df = tpch.QUERIES["q6"](_session(), data_dir)
    df.collect()
    first = _qid(df)
    df.collect()
    assert first >= 1 and _qid(df) == first + 1
    assert faults.get_query_token() is None       # cleared at the end


def test_query_scoped_arming_by_minted_id(baselines, data_dir, tmp_path):
    probe = tpch.QUERIES["q6"](_session(), data_dir)
    probe.collect()
    target = _qid(probe) + 2          # the second query below
    spec = f"oom@upload/query={target}:1"
    faults.reset_counters()
    first = tpch.QUERIES["q6"](_session(spec, str(tmp_path)), data_dir)
    assert first.collect() == baselines["q6"]
    assert _qid(first) == target - 1
    assert "faultsInjected" not in first.metrics()["Recovery@query"]
    second = tpch.QUERIES["q6"](_session(spec, str(tmp_path)), data_dir)
    assert second.collect() == baselines["q6"]
    assert _qid(second) == target
    assert second.metrics()["Recovery@query"]["faultsInjected"] == 1
    assert faults.counters()["faultsInjected"] == 1


def test_query_scoped_arming_by_query_tag(baselines, data_dir, tmp_path):
    spec = "oom@upload/query=9001:1"
    other = tpch.QUERIES["q6"](_session(spec, str(tmp_path)), data_dir)
    assert other.collect() == baselines["q6"]
    assert "faultsInjected" not in other.metrics()["Recovery@query"]
    tagged = tpch.QUERIES["q6"](_session(
        spec, str(tmp_path),
        **{"spark.rapids.sql.test.faults.queryTag": 9001}), data_dir)
    assert tagged.collect() == baselines["q6"]
    assert tagged.metrics()["Recovery@query"]["faultsInjected"] == 1


def test_plan_cache_bypassed_while_armed(data_dir):
    before = pc.counters().get("planCacheBypasses", 0)
    df = tpch.QUERIES["q6"](_session(), data_dir)
    assert isinstance(df._physical(), BoundPlan)
    faults.configure("oom@nowhere:1")
    df2 = tpch.QUERIES["q6"](_session(), data_dir)
    assert not isinstance(df2._physical(), BoundPlan)
    assert pc.counters()["planCacheBypasses"] == before + 1


@pytest.mark.parametrize("reader", ["PERFILE", "MULTITHREADED"])
def test_scan_fault_on_helper_thread_reraises_in_query(reader, data_dir,
                                                       tmp_path):
    """``transient@scan`` fires where a unit decodes: on a pipeline
    prefetch thread (PERFILE, three files) or a reader-pool thread
    (MULTITHREADED, pipeline off). With the transient retry off it
    propagates out of ``collect``, and its instant lands in the query's
    own ring: the token crossed the thread."""
    over = {"spark.rapids.sql.trace.enabled": True,
            "spark.rapids.sql.format.parquet.reader.type": reader,
            "spark.rapids.sql.retry.transientMaxRetries": 0}
    if reader == "MULTITHREADED":
        over["spark.rapids.sql.pipeline.enabled"] = False
    df = tpch.QUERIES["q6"](_session("transient@scan:1", str(tmp_path),
                                     **over), data_dir)
    with pytest.raises(faults.InjectedTransientError):
        df.collect()
    qid = _qid(df)
    inst = [e for e in monitoring.events(qid) if e[0] == "i"
            and e[1] == "fault-injected"]
    assert [e[7] for e in inst] == [{"kind": "transient", "site": "scan"}]
    assert monitoring.events(0) == []
    names = monitoring.thread_names()
    assert names[inst[0][5]].startswith(
        "srt-prefetch" if reader == "PERFILE" else "srt-scan-read")


@pytest.mark.parametrize("reader", ["PERFILE", "MULTITHREADED"])
def test_scan_fault_on_helper_thread_retried(reader, baselines, data_dir,
                                             tmp_path):
    """With the defaults the same fault is retried (the reference's
    ``test_prefetch_fault_reraised_at_consumption``): the query gives its
    fault-free rows and counts one retry."""
    over = {"spark.rapids.sql.format.parquet.reader.type": reader}
    if reader == "MULTITHREADED":
        over["spark.rapids.sql.pipeline.enabled"] = False
    df = tpch.QUERIES["q6"](_session("transient@scan:1", str(tmp_path),
                                     **over), data_dir)
    assert df.collect() == baselines["q6"]
    c = faults.counters()
    assert c["faultsInjected"] == 1 and c["retriesAttempted"] == 1
    assert df.metrics()["Recovery@query"]["retriesAttempted"] == 1
