"""Port parity: multi-query admission, isolation and cancellation
(``parallel/scheduler.py``, the device semaphore of
``memory/stores.py``, the planner's admission and the OOM ladder's
evict-neighbors rung), as ``tests/test_scheduler.py`` pins the JAX
package's.

- Both packages' ``QueryManager`` given the same scripted sequence: a
  full queue sheds at once, a queued query past the admission timeout
  sheds, each with the same kind, queue depth and ``retry_after_ms``
  hint (the observed service rate scaled by the queue); a resize at idle
  redirects stale references and a busy manager never resizes; the
  evict-neighbors rung spills only the other queries' catalogs; the
  brownout state machine flips at the same observations;
  ``collect_with_retry`` sleeps the same backoffs; ``backoff_ms`` and
  ``query_memory_fraction`` give the same numbers.
- End to end on the port (the reference's data at scale 0.003, 3 files a
  table, seed 11): every collect's rows equal the reference's rows of
  the same query on the same data, and its port solo run exactly. q1,
  q3 and q6 are collected from three threads at once; the device
  semaphore is never held by more than ``concurrentTpuTasks`` queries
  and its acquire is a ``queued`` span; a full queue sheds a collect and
  ``collect_with_retry`` then finishes it; ``submit`` + ``cancel`` and
  ``collect(timeout_ms=...)`` on a stalled query unwind with
  ``QueryCancelledError`` and an empty leak report; the reference sheds
  the same full-queue collect with the same kind and hint; chaos scoped
  to one of four concurrent queries stays in it; a neighbor's catalog is
  evicted by another query's OOM ladder; the catalog budget takes the
  fair share and the owner tag.
- ``ExecContext.catalog`` asked for by 8 threads at once is built once.

Every wait is bounded (``Event.wait``, ``Barrier(timeout=...)``,
``join(timeout)`` then a liveness check).
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import threading
import time

import pytest

from spark_rapids_tpu import faults as jfaults
from spark_rapids_tpu.api.dataframe import TpuSession as JSession
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.memory.stores import BufferCatalog as JCatalog
from spark_rapids_tpu.parallel import qos as JQ
from spark_rapids_tpu.parallel import scheduler as JSC

from spark_rapids_tpu_torch import faults, monitoring
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.host import HostBatch, host_to_device
from spark_rapids_tpu_torch.memory import oom, stores
from spark_rapids_tpu_torch.memory.stores import BufferCatalog
from spark_rapids_tpu_torch.ops.base import ExecContext
from spark_rapids_tpu_torch.parallel import qos as Q
from spark_rapids_tpu_torch.parallel import scheduler as SC
from spark_rapids_tpu_torch.plan import plan_cache as pc

from harness import assert_rows_equal

PKGS = {"port": (Q, SC), "ref": (JQ, JSC)}
VFA = {"spark.rapids.sql.variableFloatAgg.enabled": True}


@pytest.fixture(autouse=True)
def clean_state():
    state = faults.snapshot()
    faults.configure("")
    faults.reset_counters()
    for q, sc in PKGS.values():
        q.reset_counters()
        sc.reset_counters()
    oom.reset_degradation()
    yield
    faults.restore(state)
    for q, sc in PKGS.values():
        q.reset_counters()
        sc.reset_counters()
        with sc._MANAGER_LOCK:
            sc._MANAGER = None
    with stores._GLOBAL_SEM_LOCK:
        stores._GLOBAL_SEM = None
    oom.reset_degradation()
    pc.cache().clear()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_torch_sched"))
    jtpch.generate(d, scale=0.003, files_per_table=3, seed=11)
    return d


def _session(tag=None, chaos="", max_concurrent=4, **extra):
    s = TpuSession(dict(VFA), device="cpu")
    s.set("spark.rapids.sql.scheduler.maxConcurrentQueries", max_concurrent)
    s.set("spark.rapids.sql.retry.backoffMs", 1)
    if chaos:
        s.set("spark.rapids.sql.test.faults", chaos)
        s.set("spark.rapids.sql.test.faults.seed", 11)
        s.set("spark.rapids.sql.format.scanCache.maxBytes", 0)
    if tag is not None:
        s.set("spark.rapids.sql.test.faults.queryTag", tag)
    for k, v in extra.items():
        s.set(k, v)
    return s


QUERIES = ("q1", "q3", "q6")


def reference_rows(data_dir, queries):
    """The reference's rows of ``queries`` on ``data_dir``, its fault
    schedule cleared while they run. Its host engine computes them
    (``collect_host``): the same rows as its device engine within the
    float tolerance the checks use, without the XLA compiles of its
    device plans (q1 and q3 took 36 s of a test worker's time on a
    CPU)."""
    state = jfaults.snapshot()
    jfaults.configure("")
    try:
        return {qn: jtpch.QUERIES[qn](JSession(dict(VFA)),
                                      data_dir).collect_host()
                for qn in queries}
    finally:
        jfaults.restore(state)
        with JSC._MANAGER_LOCK:
            JSC._MANAGER = None


def row_check(solo, data_dir):
    """``check(rows, qn)``: ``rows`` equal the reference's rows of ``qn``
    on ``data_dir`` and, exactly, the port's solo run ``solo[qn]``. The
    reference runs a query at its first check, so a test worker pays for
    it only for the queries its tests compare."""
    ref = {}

    def check(rows, qn, label=None):
        label = label or qn
        if qn not in ref:
            ref.update(reference_rows(data_dir, (qn,)))
        assert_rows_equal(rows, ref[qn], approx_float=True, msg=label)
        assert rows == solo[qn], label
    return check


@pytest.fixture(scope="module")
def expect(data_dir):
    state = faults.snapshot()
    faults.configure("")
    try:
        solo = {qn: tpch.QUERIES[qn](_session(), data_dir).collect()
                for qn in QUERIES}
    finally:
        faults.restore(state)
        pc.cache().clear()
        with SC._MANAGER_LOCK:
            SC._MANAGER = None
    return row_check(solo, data_dir)


def _both(fn):
    return fn(*PKGS["port"]), fn(*PKGS["ref"])


def _threads(targets, timeout=60):
    threads = [threading.Thread(target=f, daemon=True) for f in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), f"{t.name} still running after {timeout} s"


def _reject(mgr, *args, **kw):
    try:
        t = mgr.admit(*args, **kw)
    except Exception as e:
        return (type(e).__name__, getattr(e, "kind", None),
                getattr(e, "queue_depth", None),
                getattr(e, "retry_after_ms", None))
    mgr.finish(t)
    return "admitted"


# ---------------------------------------------------------------------------
# Admission units, both packages
# ---------------------------------------------------------------------------

def test_queue_full_rejects_immediately():
    def run(_q, sc):
        mgr = sc.QueryManager(max_concurrent=1, queue_depth=1,
                              admission_timeout_ms=60000)
        first = mgr.admit()
        box, started = {}, threading.Event()

        def queued_waiter():
            started.set()
            box["t"] = mgr.admit()

        t = threading.Thread(target=queued_waiter, daemon=True)
        t.start()
        assert started.wait(5), "the waiter thread never started"
        deadline = time.monotonic() + 5
        while mgr.queued_count < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        shed = _reject(mgr)
        mgr.finish(first)
        t.join(10)
        assert not t.is_alive(), "the queued admit still waits after 10 s"
        mgr.finish(box["t"])
        c = sc.counters()
        return shed, mgr.active_count, c["rejected"], c["admitted"]

    port, ref = _both(run)
    assert port == ref == (("QueryRejectedError", "queue-full", 1, 500.0),
                           0, 1, 2)


def test_admission_timeout_rejects():
    def run(_q, sc):
        mgr = sc.QueryManager(max_concurrent=1, queue_depth=4,
                              admission_timeout_ms=80)
        first = mgr.admit()
        t0 = time.monotonic()
        shed = _reject(mgr)
        waited = time.monotonic() - t0 >= 0.06
        mgr.finish(first)
        again = _reject(mgr)
        return shed[:3], shed[3] is not None, waited, again

    port, ref = _both(run)
    assert port == ref == (("QueryRejectedError", "admission-timeout", 0),
                           True, True, "admitted")


def test_hint_tracks_the_observed_service_rate(monkeypatch):
    """The hint is the EWMA of observed service times scaled by the
    queue: the same clock readings give the same hints in both."""
    def run(_q, sc):
        now = [0.0]
        monkeypatch.setattr(sc.time, "perf_counter", lambda: now[0])
        mgr = sc.QueryManager(max_concurrent=2, queue_depth=0)
        for start, end in ((0.0, 0.4), (1.0, 1.1)):
            now[0] = start
            t = mgr.admit()
            now[0] = end
            mgr.finish(t)               # 400 ms, then 100 ms
        with mgr._lock:
            return mgr._service_ewma_ms, mgr._retry_hint_locked()

    port, ref = _both(run)
    monkeypatch.undo()
    assert port == ref
    assert port[0] == pytest.approx(340.0) and port[1] == 170.0


def test_hint_on_tenant_quota_and_deadline_kinds():
    def run(q_mod, sc):
        mgr = sc.QueryManager(4, 4, 80, qos=q_mod.QosPolicy("8,3,1", 8))
        raw = {"spark.rapids.sql.scheduler.qos.enabled": True,
               "spark.rapids.sql.scheduler.qos.tenantMaxInFlight": 1,
               "spark.rapids.sql.scheduler.qos.deadlineSlack": 2.0}
        conf = (TpuSession(raw, device="cpu") if sc is SC
                else JSession(raw)).conf
        first = mgr.admit(conf, tenant="acme")
        out = [_reject(mgr, conf, tenant="acme"),
               # cost 80 <= deadline 100 < 80 * 2.0: a hint.
               _reject(mgr, conf, tenant="b", cost_ms=80.0,
                       deadline_ms=100.0),
               # cost 300 > deadline 100: hopeless, no hint.
               _reject(mgr, conf, tenant="b", cost_ms=300.0,
                       deadline_ms=100.0)]
        mgr.finish(first)
        return out

    port, ref = _both(run)
    assert port == ref
    assert [r[1] for r in port] == ["tenant-quota", "deadline-unmeetable",
                                    "deadline-unmeetable"]
    assert port[0][3] == port[1][3] == 62.5 and port[2][3] is None


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_backoff_ms_matches_reference(seed):
    for attempt in range(6):
        for hint in (None, 0.0, 40.0, 250.0, 9000.0):
            assert SC.backoff_ms(hint, attempt, seed, 10000) == \
                JSC.backoff_ms(hint, attempt, seed, 10000)


def test_collect_with_retry_backs_off_on_hints():
    def run(_q, sc):
        calls, sleeps = [], []

        def attempt():
            calls.append(1)
            if len(calls) < 3:
                raise sc.QueryRejectedError("busy", kind="queue-full",
                                            retry_after_ms=40.0)
            return "ok"

        got = sc.collect_with_retry(attempt, max_attempts=5, seed=2,
                                    sleep=sleeps.append)

        def hopeless():
            raise sc.QueryRejectedError("never", kind="deadline-unmeetable")

        none_slept = []
        with pytest.raises(sc.QueryRejectedError):
            sc.collect_with_retry(hopeless, max_attempts=5,
                                  sleep=none_slept.append)

        def always():
            raise sc.QueryRejectedError("busy", kind="queue-full",
                                        retry_after_ms=20.0)

        capped = []
        with pytest.raises(sc.QueryRejectedError):
            sc.collect_with_retry(always, max_attempts=3,
                                  max_backoff_ms=21.0, sleep=capped.append)
        c = sc.counters()
        return (got, len(calls), sleeps, none_slept, capped,
                c["clientRetries"], c["clientRetries.queue-full"])

    port, ref = _both(run)
    assert port == ref
    assert port[0] == "ok" and port[1] == 3 and len(port[2]) == 2
    assert port[3] == [] and port[5] == port[6] == 4


def test_query_memory_fraction_matches_reference():
    for frac, n in ((0.0, 4), (0.5, 2), (1.0, 2), (0.001, 2), (3.0, 2)):
        raw = {"spark.rapids.sql.scheduler.queryMemoryFraction": frac}
        got = SC.query_memory_fraction(TpuSession(raw, device="cpu").conf,
                                       SC.QueryManager(n))
        want = JSC.query_memory_fraction(JSession(raw).conf,
                                         JSC.QueryManager(n))
        assert got == want


def _conf_for(sc, n, **raw):
    raw = dict(raw, **{"spark.rapids.sql.scheduler.maxConcurrentQueries": n})
    return (TpuSession(raw, device="cpu") if sc is SC
            else JSession(raw)).conf


def test_resize_at_idle_redirects_stale_references():
    def run(_q, sc):
        with sc._MANAGER_LOCK:
            sc._MANAGER = None
        old = sc.get_query_manager(_conf_for(sc, 2))
        new = sc.get_query_manager(_conf_for(sc, 3))
        out = [new is not old, old._successor is new]
        t = old.admit()
        out += [new.active_count, len(old._active)]
        old.finish(t)
        out.append(new.active_count)
        newer = sc.get_query_manager(_conf_for(sc, 4))
        t2 = old.admit()
        out.append(newer.active_count)
        old.finish(t2)
        out.append(newer.active_count)
        return out

    port, ref = _both(run)
    assert port == ref == [True, True, 1, 0, 0, 1, 0]


def test_resize_skipped_while_active():
    def run(_q, sc):
        with sc._MANAGER_LOCK:
            sc._MANAGER = None
        mgr = sc.get_query_manager(_conf_for(sc, 2))
        t = mgr.admit()
        same = sc.get_query_manager(_conf_for(sc, 5))
        out = (same is mgr, mgr._successor is None, mgr.max_concurrent)
        mgr.finish(t)
        return out

    port, ref = _both(run)
    assert port == ref == (True, True, 2)


def test_env_override_sizes_the_manager(monkeypatch):
    monkeypatch.setenv("SRT_SCHEDULER_MAX_CONCURRENT", "1")

    def run(_q, sc):
        with sc._MANAGER_LOCK:
            sc._MANAGER = None
        return sc.get_query_manager(_conf_for(sc, 4)).max_concurrent

    assert _both(run) == (1, 1)


def test_brownout_hysteresis_matches_reference(monkeypatch):
    """The same pressure observations and clock flip brownout on (after
    the sustain window), shed a background admission with a hint, defer
    once for an accepting scale probe, and flip off below the exit
    score."""
    def run(q_mod, sc):
        raw = {"spark.rapids.sql.scheduler.qos.enabled": True,
               "spark.rapids.sql.scheduler.pressure.enabled": True,
               "spark.rapids.sql.scheduler.pressure.brownout.sustainMs": 100}
        conf = (TpuSession(raw, device="cpu") if sc is SC
                else JSession(raw)).conf
        now = [0.0]
        monkeypatch.setattr(sc.time, "perf_counter", lambda: now[0])
        mgr = sc.QueryManager(2, 4, 1000, qos=q_mod.QosPolicy("8,3,1", 8))
        asks = []
        sc.register_scale_probe(lambda s: (asks.append(s), len(asks) == 1)[1])
        states = []
        for t, score in ((0.0, 0.95), (0.05, 0.95), (0.2, 0.95),
                         (0.4, 0.95), (0.5, 0.8), (0.6, 0.5)):
            now[0] = t
            mgr.note_pressure(score, conf)
            states.append(mgr.brownout_active)
            if mgr.brownout_active:
                states.append(_reject(mgr, conf, priority="background"))
                states.append(_reject(mgr, conf, priority="interactive"))
        sc.register_scale_probe(None)
        c = sc.counters()
        return states, asks, (c.get("brownouts"), c.get("brownoutExits"),
                              c.get("brownoutDeferrals"))

    port, ref = _both(run)
    monkeypatch.undo()
    assert port == ref
    states, asks, counts = port
    assert counts == (1, 1, 1) and asks == [0.95, 0.95]
    assert ("QueryRejectedError", "brownout", 0, 125.0) in states


def test_cross_query_eviction_rung(tmp_path):
    """The evict-neighbors rung spills only OTHER queries' catalogs, in
    both packages."""
    from test_torch_memory import _pair

    def run(_q, sc):
        port = sc is SC
        cat = (BufferCatalog if port else JCatalog)(
            device_budget_bytes=1 << 24,
            spill_dir=str(tmp_path / ("p" if port else "r")))
        mgr = sc.QueryManager(max_concurrent=4)
        ta, tb = mgr.admit(), mgr.admit()

        class FakeCtx:
            _catalog = cat
        mgr.register_context(tb, FakeCtx())
        cat.add_batch(_pair(3)[0 if port else 1])
        before = cat.device_bytes
        freed = mgr.evict_neighbors(ta.query_id)
        out = (before > 0, freed == before, cat.device_bytes,
               mgr.evict_neighbors(tb.query_id),
               sc.counters().get("crossQueryEvictions"))
        mgr.finish(ta)
        mgr.finish(tb)
        cat.close()
        return out

    port, ref = _both(run)
    assert port == ref == (True, True, 0, 0, 1)


# ---------------------------------------------------------------------------
# Concurrency end to end on the port
# ---------------------------------------------------------------------------

def test_concurrent_queries_match_solo_runs(data_dir, expect):
    """Three threads of q1, q3, q6 at once: each equals the reference's
    rows and its solo run exactly; the device semaphore held by at
    most its permits."""
    results, errors = {}, {}

    def run(qn):
        def go():
            try:
                results[qn] = tpch.QUERIES[qn](_session(), data_dir).collect()
            except BaseException as e:   # pragma: no cover - diagnostics
                errors[qn] = e
        return go

    _threads([run(qn) for qn in QUERIES])
    assert not errors, errors
    for qn in QUERIES:
        expect(results[qn], qn)
    sem = stores.get_tpu_semaphore(2)
    assert sem.permits == 2 and 1 <= sem.max_in_use <= 2
    assert sem.in_use == 0 and SC.get_query_manager().active_count == 0


def test_permit_holders_bounded_by_concurrent_tasks(data_dir, expect):
    """concurrentTpuTasks 1 (the first value the process sees sizes the
    semaphore): three admitted queries never hold the card at once, each
    acquire is a tpu-semaphore-acquire span in category queued, and the
    rows are the reference's and the solo run's."""
    extra = {"spark.rapids.sql.concurrentTpuTasks": 1,
             "spark.rapids.sql.trace.enabled": True}
    sem = stores.get_tpu_semaphore(1)
    monitoring.reset()
    results = {}

    def run(qn):
        def go():
            results[qn] = tpch.QUERIES[qn](_session(**extra),
                                           data_dir).collect()
        return go

    try:
        _threads([run("q6")] * 3)
        spans = [e for q in monitoring.query_ids()
                 for e in monitoring.events(q)
                 if e[1] == "tpu-semaphore-acquire"]
    finally:
        monitoring.configure(False)
        monitoring.reset()
    assert sem.permits == 1 and sem.max_in_use == 1
    assert len(spans) == 3 and {e[2] for e in spans} == {"queued"}
    expect(results["q6"], "q6")


def test_serial_mode_matches_baseline(data_dir, expect):
    got = tpch.QUERIES["q6"](_session(max_concurrent=1), data_dir).collect()
    expect(got, "q6")
    assert SC.get_query_manager().max_concurrent == 1


def test_queue_full_rejection_e2e_then_collect_with_retry(data_dir, expect):
    """With the only run slot held, a zero-depth queue sheds a collect
    with a hint; collect_with_retry backs off and finishes once the slot
    frees; the reference sheds the same way."""
    raw = {"spark.rapids.sql.scheduler.maxConcurrentQueries": 1,
           "spark.rapids.sql.scheduler.queueDepth": 0,
           "spark.rapids.sql.scheduler.admissionTimeoutMs": 200}
    df = tpch.QUERIES["q6"](_session(max_concurrent=1, **raw), data_dir)
    mgr = SC.get_query_manager(df._session.conf)
    hog = mgr.admit()
    with pytest.raises(SC.QueryRejectedError) as ei:
        df.collect()
    assert ei.value.kind == "queue-full" and ei.value.retry_after_ms == 250.0
    timer = threading.Timer(0.1, mgr.finish, args=(hog,))
    timer.start()
    expect(df.collect_with_retry(max_backoff_ms=50), "q6")
    timer.join(5)
    assert not timer.is_alive(), "the finishing timer still runs after 5 s"
    assert SC.counters().get("clientRetries", 0) >= 1
    jdf = jtpch.QUERIES["q6"](JSession(dict(VFA, **raw)), data_dir)
    jmgr = JSC.get_query_manager(jdf._session.conf)
    jhog = jmgr.admit()
    try:
        with pytest.raises(JSC.QueryRejectedError) as jei:
            jdf.collect()
    finally:
        jmgr.finish(jhog)
        with JSC._MANAGER_LOCK:
            JSC._MANAGER = None
    assert (jei.value.kind, jei.value.retry_after_ms) == \
        (ei.value.kind, ei.value.retry_after_ms)


def test_cancel_mid_flight_frees_everything(data_dir, expect):
    s = _session(tag=1, chaos="stall@upload/query=1:1")
    df = tpch.QUERIES["q3"](s, data_dir)
    handle = df.submit()
    deadline = time.monotonic() + 30
    while SC.get_query_manager().active_count < 1 \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    handle.cancel()
    with pytest.raises(faults.QueryCancelledError):
        handle.result(30)
    assert handle.done()
    ctx = df._physical().last_ctx
    assert ctx is not None and ctx.last_leak_report == []
    assert ctx.metrics["Scheduler@query"].values["cancelled"] == 1
    assert SC.get_query_manager().active_count == 0
    assert stores.get_tpu_semaphore(2).in_use == 0
    assert SC.counters().get("cancelled", 0) == 1
    assert SC.counters().get("deadlineKills", 0) == 0
    expect(tpch.QUERIES["q6"](_session(), data_dir).collect(), "q6")


def test_collect_timeout_deadline_kills(data_dir, expect):
    s = _session(tag=3, chaos="stall@upload/query=3:1")
    df = tpch.QUERIES["q6"](s, data_dir)
    t0 = time.monotonic()
    with pytest.raises(faults.QueryCancelledError, match="deadline"):
        df.collect(timeout_ms=300)
    assert time.monotonic() - t0 < faults.STALL_TIMEOUT_S
    ctx = df._physical().last_ctx
    assert ctx is not None and ctx.last_leak_report == []
    assert SC.counters().get("deadlineKills", 0) == 1
    assert df.metrics()["Scheduler@query"]["deadlineKills"] == 1
    expect(tpch.QUERIES["q6"](_session(), data_dir).collect(), "q6")


def test_cancel_while_queued(data_dir):
    mgr = SC.get_query_manager(_session(max_concurrent=1).conf)
    hog = mgr.admit()
    try:
        df = tpch.QUERIES["q6"](_session(max_concurrent=1), data_dir)
        handle = df.submit()
        deadline = time.monotonic() + 10
        while mgr.queued_count < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert mgr.queued_count == 1
        handle.cancel()
        with pytest.raises(faults.QueryCancelledError, match="queued"):
            handle.result(10)
    finally:
        mgr.finish(hog)
    assert (mgr.queued_count, mgr.active_count) == (0, 0)
    with pytest.raises(TimeoutError):
        SC.QueryHandle(lambda c, t: c.wait(5)).result(0.01)


def _recovery(df):
    m = df.metrics().get("Recovery@query", {})
    return {k: v for k, v in m.items() if v}


def test_cross_query_fault_containment(data_dir, expect):
    """Four queries at once under chaos scoped to query A (an OOM and a
    lost stage output): every result equals the reference's rows and its
    solo run, and only A's recovery counters move."""
    chaos = "oom@upload/query=1:1,lostoutput@exchange.serve/query=1:1"
    plan = [("A", 1, "q1"), ("B", 2, "q6"), ("C", 3, "q3"), ("D", 4, "q6")]
    results, errors, dfs = {}, {}, {}
    barrier = threading.Barrier(len(plan), timeout=30)

    def run(name, tag, qn):
        def go():
            try:
                s = _session(tag=tag, chaos=chaos)
                df = dfs[name] = tpch.QUERIES[qn](s, data_dir)
                barrier.wait(timeout=30)
                results[name] = df.collect()
            except BaseException as e:   # pragma: no cover - diagnostics
                errors[name] = e
        return go

    _threads([run(*p) for p in plan], timeout=90)
    assert not errors, errors
    for name, _, qn in plan:
        expect(results[name], qn, name)
    assert _recovery(dfs["A"]).get("faultsInjected", 0) > 0
    for name in ("B", "C", "D"):
        assert _recovery(dfs[name]) == {}, name


def test_query_scoped_faults_do_not_fire_for_other_tags(data_dir, expect):
    chaos = "oom@upload/query=7:1"
    df = tpch.QUERIES["q6"](_session(tag=8, chaos=chaos), data_dir)
    expect(df.collect(), "q6")
    assert _recovery(df) == {}
    faults.configure("")
    df2 = tpch.QUERIES["q6"](_session(tag=7, chaos=chaos), data_dir)
    expect(df2.collect(), "q6")
    assert _recovery(df2).get("faultsInjected", 0) > 0


def test_owner_tag_and_fair_share_of_the_catalog(tmp_path):
    raw = {"spark.rapids.sql.scheduler.queryMemoryFraction": 0.5,
           "spark.rapids.memory.tpu.budgetBytes": 1 << 24,
           "spark.rapids.memory.spill.dir": str(tmp_path)}
    conf = TpuSession(raw, device="cpu").conf
    mgr = SC.get_query_manager(conf)
    t = mgr.admit(conf)
    ctx = ExecContext(conf, query=t)
    assert ctx.catalog.device_budget == 1 << 23
    assert ctx.catalog.owner == t.query_id
    plain = ExecContext(conf)
    assert plain.catalog.device_budget == 1 << 24
    assert plain.catalog.owner is None
    # The share never lifts an explicit budget below 1 MiB.
    tiny = TpuSession(dict(raw, **{
        "spark.rapids.memory.tpu.budgetBytes": 2048,
        "spark.rapids.sql.scheduler.queryMemoryFraction": 1.0}),
        device="cpu").conf
    assert ExecContext(tiny, query=t).catalog.device_budget == 2048
    for c in (ctx, plain):
        c.close()
        assert c.last_leak_report == []
    mgr.finish(t)


def test_oom_ladder_evicts_a_running_neighbor(data_dir, expect, tmp_path):
    """A neighbor query holds device buffers in its catalog; q6's upload
    raises an injected OOM that its own (empty) catalog cannot meet: the
    ladder's evict-neighbors rung spills the neighbor and the retry gives
    the reference's rows, equal to the solo run's."""
    s = _session(tag=5, chaos="oom@upload/query=5:1")
    df = tpch.QUERIES["q6"](s, data_dir)
    mgr = SC.get_query_manager(s.conf)
    neighbor = mgr.admit(s.conf)
    nctx = ExecContext(TpuSession({"spark.rapids.memory.spill.dir":
                                   str(tmp_path)}, device="cpu").conf,
                       query=neighbor)
    mgr.register_context(neighbor, nctx)
    nctx.catalog.add_batch(host_to_device(HostBatch.from_pydict(
        [("a", dt.INT64)], {"a": list(range(1000))}), device="cpu"))
    held = nctx.catalog.device_bytes
    try:
        expect(df.collect(), "q6")
        assert oom.last_ladder == ["evict-neighbors"]
        assert nctx.catalog.device_bytes == 0
        assert nctx.catalog.host_bytes == held
        c = SC.counters()
        assert c["crossQueryEvictions"] == 1
        assert c["crossQueryEvictedBytes"] == held
        assert _recovery(df)["crossQueryEvictions"] == 1
    finally:
        mgr.finish(neighbor)
        nctx.close()


def test_scheduler_entry_and_plan_cache_outcome(data_dir):
    s = _session()
    df = tpch.QUERIES["q6"](s, data_dir)
    df.collect()
    df2 = tpch.QUERIES["q6"](s, data_dir)
    df2.collect(tenant="acme")
    first = df.metrics()["Scheduler@query"]
    assert set(first) >= {"admitted", "queuedMs"}
    second = df2.metrics()["Scheduler@query"]
    assert second["planCacheBindOnly"] == 1 and second["tenant.acme"] == 1
    assert SC.counters()["planCacheBindOnly"] == 1


def test_event_log_and_telemetry_carry_the_admission(data_dir, tmp_path):
    from spark_rapids_tpu_torch.monitoring import history, telemetry
    s = _session(**{"spark.rapids.sql.eventLog.dir": str(tmp_path),
                    "spark.rapids.sql.metrics.enabled": True,
                    "spark.rapids.sql.scheduler.qos.enabled": True})
    try:
        tpch.QUERIES["q6"](s, data_dir).collect(priority="interactive",
                                                tenant="acme")
        (rec,) = history.read_events(str(tmp_path))
        snap = telemetry.snapshot()["metrics"]
    finally:
        telemetry.configure(False)
        telemetry.reset()
        history.set_dir("")
    assert (rec["class"], rec["tenant"], rec["status"]) == \
        ("interactive", "acme", "ok")
    admitted = {tuple(sorted(x["labels"].items())): x["value"]
                for x in snap["srt_scheduler_admitted"]["series"]}
    assert admitted[()] == 1
    assert snap["srt_qos_admitted"]["series"][0]["labels"] == \
        {"class": "interactive"}


def test_catalog_built_once_under_concurrent_first_use(monkeypatch,
                                                       tmp_path):
    """Eight threads ask a fresh context for its catalog at once: one
    catalog is built and every thread gets it."""
    built = []
    orig = BufferCatalog.__init__

    def slow_init(self, *a, **kw):
        built.append(1)
        time.sleep(0.02)                # widen the race window
        orig(self, *a, **kw)

    monkeypatch.setattr(BufferCatalog, "__init__", slow_init)
    ctx = ExecContext(TpuSession({"spark.rapids.memory.spill.dir":
                                  str(tmp_path)}, device="cpu").conf)
    barrier = threading.Barrier(8, timeout=10)
    got, errors = [], []

    def ask():
        try:
            barrier.wait(timeout=10)
        except threading.BrokenBarrierError as e:
            errors.append(f"the 8 askers never met within 10 s: {e!r}")
            return
        got.append(ctx.catalog)

    _threads([ask] * 8, timeout=10)
    assert not errors, errors
    assert len(got) == 8 and len({id(c) for c in got}) == 1
    assert len(built) == 1
    ctx.close()
