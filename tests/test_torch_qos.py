"""Port parity: serving QoS for the multi-query scheduler
(``parallel/qos/``), as ``tests/test_qos.py`` pins the JAX package's.

- The WFQ run queue drains a seeded arrival schedule in the reference's
  order; service tracks the weight vector; SJF orders within a class
  (un-priced entries after every priced one, FIFO among themselves); the
  hard starvation bound engages after the same bypasses; a class idle
  for a while re-enters at the global virtual time; a discarded waiter
  never runs; the weight and class parsers raise the same errors.
- Both packages' ``QueryManager``, FIFO and QoS, given the same scripted
  sequence, shed with the same kinds, queue depths and ``retry_after_ms``
  hints, grant the same order (QoS: class and SJF; FIFO: arrival), count
  the same per-class admissions and reject at the same tenant caps and
  deadline tests.
- A query over files is priced by the cost model (``plan/cost.py``) as
  the reference's is, and an absurd deadline sheds it at admission; a
  plan without a file scan stays un-priced, so deadline admission passes
  it and the in-flight timer kills it. Divergence pinned (ROADMAP queue
  C): ``tenantMaxKernelCacheEntries`` counts zero entries (the port keeps
  no kernel cache).
- End to end on the port (the reference's data at scale 0.003, 3 files a
  table, seed 11): per-tenant plan-cache counters; three tenants of three
  classes in flight with chaos scoped to one, every tenant's rows equal
  to the reference's and to its solo run, the others with zero recovery
  counters.
- The 25 scheduler, QoS, preemption, pressure and client-retry keys have
  the reference's names and defaults.

Every wait is bounded (``Event.wait``, ``Barrier(timeout=...)``,
``join(timeout)`` then a liveness check).
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import random
import threading
import time

import pytest

from spark_rapids_tpu import config as JC
from spark_rapids_tpu.api.dataframe import TpuSession as JSession
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.parallel import qos as JQ
from spark_rapids_tpu.parallel import scheduler as JSC

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.memory import oom
from spark_rapids_tpu_torch.parallel import qos as Q
from spark_rapids_tpu_torch.parallel import scheduler as SC
from spark_rapids_tpu_torch.plan import plan_cache as pc

from test_torch_scheduler import row_check

PKGS = {"port": (Q, SC), "ref": (JQ, JSC)}


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
        # A test may have rebuilt the process-wide manager in QoS mode.
        with sc._MANAGER_LOCK:
            sc._MANAGER = None
    oom.reset_degradation()
    pc.cache().clear()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_torch_qos"))
    jtpch.generate(d, scale=0.003, files_per_table=3, seed=11)
    return d


def _conf(pkg, **over):
    raw = {"spark.rapids.sql.scheduler.qos.enabled": True}
    raw.update(over)
    return (TpuSession(raw, device="cpu") if pkg == "port"
            else JSession(raw)).conf


def _session(tag=None, chaos="", **extra):
    s = TpuSession({"spark.rapids.sql.variableFloatAgg.enabled": True,
                    "spark.rapids.sql.scheduler.maxConcurrentQueries": 4,
                    "spark.rapids.sql.scheduler.qos.enabled": True,
                    "spark.rapids.sql.retry.backoffMs": 1}, device="cpu")
    if chaos:
        s.set("spark.rapids.sql.test.faults", chaos)
        s.set("spark.rapids.sql.test.faults.seed", 11)
        s.set("spark.rapids.sql.format.scanCache.maxBytes", 0)
    if tag is not None:
        s.set("spark.rapids.sql.test.faults.queryTag", tag)
    for k, v in extra.items():
        s.set(k, v)
    return s


def _drain(q):
    out = []
    while len(q):
        e, engaged = q.pop_next()
        out.append((e.qos_class, e.cost_ms, e.seq, engaged))
    return out


def _both(fn):
    """``fn(qos_module, scheduler_module)`` for the port, then the
    reference; returns the pair of results."""
    return fn(*PKGS["port"]), fn(*PKGS["ref"])


# ---------------------------------------------------------------------------
# WFQ policy units
# ---------------------------------------------------------------------------

def test_wfq_drain_order_matches_reference_under_seeded_schedule():
    def drain(q_mod, _sc):
        rng = random.Random(7)
        q = q_mod.WfqQueue(q_mod.parse_weights("8,3,1"), 8)
        for i in range(60):
            cls = q_mod.CLASSES[rng.randrange(3)]
            cost = rng.choice([None, float(rng.randrange(1, 500))])
            q.push(cls, cost, threading.Event(), f"t{i % 4}")
        return _drain(q)

    port, ref = _both(drain)
    assert port == ref and len(port) == 60
    assert port == drain(*PKGS["port"])            # deterministic


def test_wfq_service_tracks_weight_vector():
    def served(q_mod, _sc):
        q = q_mod.WfqQueue(q_mod.parse_weights("8,3,1"), 1000)
        for i in range(120):
            for cls in q_mod.CLASSES:
                q.push(cls, float(i), threading.Event())
        got = {cls: 0 for cls in q_mod.CLASSES}
        for _ in range(60):
            e, _engaged = q.pop_next()
            got[e.qos_class] += 1
        return got

    port, ref = _both(served)
    assert port == ref == {"interactive": 40, "batch": 15, "background": 5}


def test_wfq_sjf_within_class_unpriced_last_fifo():
    def order(q_mod, _sc):
        q = q_mod.WfqQueue(q_mod.parse_weights("8,3,1"), 8)
        for cost in (None, 90.0, None, 10.0):
            q.push("batch", cost, threading.Event())
        return [(c, s) for c, _cost, s, _e in _drain(q)]

    port, ref = _both(order)
    assert port == ref == [("batch", 4), ("batch", 2), ("batch", 1),
                           ("batch", 3)]


def test_wfq_starvation_bound_engages():
    def drained(q_mod, _sc):
        q = q_mod.WfqQueue(q_mod.parse_weights("100,1,1"), 3)
        q.push("background", 1.0, threading.Event())
        q.push("background", 2.0, threading.Event())
        for i in range(20):
            q.push("interactive", float(i), threading.Event())
        out = []
        for _ in range(6):
            e, engaged = q.pop_next()
            out.append((e.qos_class, engaged))
        return out

    port, ref = _both(drained)
    assert port == ref
    assert port[1] == ("background", False)
    assert port[5] == ("background", True)


def test_wfq_reactivation_joins_at_global_vtime():
    def grants(q_mod, _sc):
        q = q_mod.WfqQueue(q_mod.parse_weights("1,1,1"), 1000)
        for i in range(10):
            q.push("interactive", float(i), threading.Event())
        for _ in range(10):
            q.pop_next()
        q.push("background", 1.0, threading.Event())
        q.push("interactive", 99.0, threading.Event())
        vtime = q._classes["background"].vtime
        return vtime, [q.pop_next()[0].qos_class for _ in range(2)]

    port, ref = _both(grants)
    assert port == ref
    assert port[0] >= 9.0 and port[1] == ["background", "interactive"]


def test_wfq_discard_is_race_free():
    def popped(q_mod, _sc):
        q = q_mod.WfqQueue(q_mod.parse_weights("8,3,1"), 8)
        keep = q.push("batch", 5.0, threading.Event())
        drop = q.push("batch", 1.0, threading.Event())
        q.discard(drop)
        q.discard(drop)                         # idempotent
        n = len(q)
        e, _ = q.pop_next()
        return n, e is keep, q.pop_next()

    port, ref = _both(popped)
    assert port == ref == (1, True, (None, False))


@pytest.mark.parametrize("spec,err", [
    ("8,3", "3 comma-separated"), ("8,0,1", "must be > 0"),
    ("a,b,c", "could not convert")])
def test_parse_weights_rejects_like_the_reference(spec, err):
    for q_mod in (Q, JQ):
        with pytest.raises(ValueError, match=err):
            q_mod.parse_weights(spec)


def test_parse_weights_and_resolve_class():
    for q_mod in (Q, JQ):
        assert q_mod.parse_weights(" 8, 3 ,1 ") == {
            "interactive": 8.0, "batch": 3.0, "background": 1.0}
        assert q_mod.resolve_class(None) == "batch"
        assert q_mod.resolve_class(" Interactive ") == "interactive"
        with pytest.raises(ValueError, match="unknown priority class"):
            q_mod.resolve_class("realtime")
        assert q_mod.resolve_tenant(None) == "default"
        assert q_mod.resolve_tenant("  acme ") == "acme"
    assert (Q.CLASSES, Q.CLASS_RANK, Q.DEFAULT_CLASS, Q.DEFAULT_TENANT) \
        == (JQ.CLASSES, JQ.CLASS_RANK, JQ.DEFAULT_CLASS, JQ.DEFAULT_TENANT)


# ---------------------------------------------------------------------------
# Structured rejection, both scheduler modes
# ---------------------------------------------------------------------------

def _reject(mgr, *args, **kw):
    try:
        t = mgr.admit(*args, **kw)
    except Exception as e:                  # the structured error
        return (type(e).__name__, getattr(e, "kind", None),
                getattr(e, "queue_depth", None),
                getattr(e, "retry_after_ms", None))
    mgr.finish(t)
    return "admitted"


@pytest.mark.parametrize("mode", ["fifo", "qos"])
def test_rejection_fields_queue_full(mode):
    def run(q_mod, sc):
        qos = q_mod.QosPolicy("8,3,1", 8) if mode == "qos" else None
        mgr = sc.QueryManager(1, 0, 50, qos=qos)
        hog = mgr.admit()
        try:
            with pytest.raises(sc.QueryRejectedError, match="queue full"):
                mgr.admit()
            return _reject(mgr)
        finally:
            mgr.finish(hog)

    port, ref = _both(run)
    assert port == ref == ("QueryRejectedError", "queue-full", 0, 250.0)


@pytest.mark.parametrize("mode", ["fifo", "qos"])
def test_rejection_fields_admission_timeout(mode):
    def run(q_mod, sc):
        qos = q_mod.QosPolicy("8,3,1", 8) if mode == "qos" else None
        mgr = sc.QueryManager(1, 4, 30, qos=qos)
        hog = mgr.admit()
        t0 = time.monotonic()
        try:
            got = _reject(mgr)
        finally:
            mgr.finish(hog)
        return got, time.monotonic() - t0 >= 0.02, mgr.queued_count

    port, ref = _both(run)
    assert port == ref
    assert port[0][:3] == ("QueryRejectedError", "admission-timeout", 0)
    assert port[0][3] is not None and port[1] and port[2] == 0


# ---------------------------------------------------------------------------
# Manager-level grant order: WFQ against FIFO
# ---------------------------------------------------------------------------

def _grant_order(mgr, submissions):
    """Admit ``submissions`` [(priority, cost_ms)] while a hog holds the
    only slot; return the grant order."""
    hog = mgr.admit()
    order, lock = [], threading.Lock()
    started = threading.Semaphore(0)

    def waiter(prio, cost):
        started.release()
        t = mgr.admit(None, priority=prio, cost_ms=cost)
        with lock:
            order.append((prio, cost))
        mgr.finish(t)

    threads = []
    for prio, cost in submissions:
        th = threading.Thread(target=waiter, args=(prio, cost), daemon=True)
        th.start()
        threads.append(th)
        assert started.acquire(timeout=10)
        deadline = time.monotonic() + 10
        while mgr.queued_count < len(threads) \
                and time.monotonic() < deadline:
            time.sleep(0.002)
    assert mgr.queued_count == len(submissions)
    mgr.finish(hog)
    for th in threads:
        th.join(10)
        assert not th.is_alive(), f"{th.name} still waits after 10 s"
    return order


def test_wfq_grant_order_beats_arrival_order():
    subs = [("background", 1.0), ("batch", 50.0), ("batch", 5.0),
            ("interactive", 99.0)]

    def run(q_mod, sc):
        mgr = sc.QueryManager(1, 8, 30000, qos=q_mod.QosPolicy("8,3,1", 8))
        order = _grant_order(mgr, subs)
        c = q_mod.counters()
        return order, {k: v for k, v in c.items()
                       if k.startswith("admitted.")}

    port, ref = _both(run)
    assert port == ref
    assert port[0] == [("interactive", 99.0), ("batch", 5.0),
                       ("background", 1.0), ("batch", 50.0)]
    assert port[1] == {"admitted.batch": 3, "admitted.interactive": 1,
                       "admitted.background": 1}


def test_fifo_mode_ignores_priority_and_cost():
    subs = [("background", 1.0), ("batch", 50.0), ("interactive", 99.0)]

    def run(q_mod, sc):
        mgr = sc.QueryManager(1, 8, 30000)
        order = _grant_order(mgr, subs)
        t = mgr.admit(None, priority="interactive", tenant="acme")
        mgr.finish(t)
        return order, (t.qos_class, t.tenant), q_mod.counters()

    port, ref = _both(run)
    assert port == ref
    assert port == (subs, (None, "acme"), {})


def test_qos_disabled_by_default_and_gate_resizes_manager(monkeypatch):
    monkeypatch.delenv("SRT_QOS", raising=False)
    plain = TpuSession(device="cpu").conf
    assert Q.qos_enabled(plain) is False
    assert SC.get_query_manager(plain).qos is None
    assert SC.get_query_manager(_conf("port")).qos.sig == ("8,3,1", 8)
    wide = _conf("port", **{"spark.rapids.sql.scheduler.qos.weights":
                            "4,2,1"})
    assert SC.get_query_manager(wide).qos.sig == ("4,2,1", 8)
    assert SC.get_query_manager(plain).qos is None
    monkeypatch.setenv("SRT_QOS", "1")
    assert Q.qos_enabled(plain) is JQ.qos_enabled(JSession().conf) is True
    assert Q.qos_enabled(_conf("port", **{
        "spark.rapids.sql.scheduler.qos.enabled": False})) is False


# ---------------------------------------------------------------------------
# Deadline-aware admission
# ---------------------------------------------------------------------------

def test_deadline_reject_at_admit_vs_unpriced_pass():
    def run(q_mod, sc):
        conf = _conf("port" if q_mod is Q else "ref")
        mgr = sc.QueryManager(2, 4, 1000, qos=q_mod.QosPolicy("8,3,1", 8))
        out = [_reject(mgr, conf, cost_ms=500.0, deadline_ms=50.0),
               mgr.active_count,
               _reject(mgr, conf, cost_ms=None, deadline_ms=50.0),
               _reject(mgr, conf, cost_ms=10.0, deadline_ms=50.0)]
        return out, q_mod.counters().get("rejected.deadline-unmeetable")

    port, ref = _both(run)
    assert port == ref
    assert port[0][0] == ("QueryRejectedError", "deadline-unmeetable", 0,
                          None)
    assert port[0][1:] == [0, "admitted", "admitted"] and port[1] == 1


def test_deadline_slack_and_gate_conf():
    def run(q_mod, sc):
        pkg = "port" if q_mod is Q else "ref"
        mgr = sc.QueryManager(2, 4, 1000, qos=q_mod.QosPolicy("8,3,1", 8))
        slack = _conf(pkg, **{
            "spark.rapids.sql.scheduler.qos.deadlineSlack": 3.0})
        off = _conf(pkg, **{
            "spark.rapids.sql.scheduler.qos.deadlineAdmission.enabled":
                False})
        return (_reject(mgr, slack, cost_ms=30.0, deadline_ms=80.0),
                _reject(mgr, off, cost_ms=500.0, deadline_ms=50.0))

    port, ref = _both(run)
    assert port == ref
    assert port[0][1] == "deadline-unmeetable" and port[1] == "admitted"


def test_port_queries_are_unpriced_and_pass_deadline_admission():
    """A plan without a file scan stays un-priced (plan/cost.py skips
    it: no footer stats), as the reference's does, so its collect passes
    deadline admission and even an absurd deadline is enforced only by
    the in-flight timer: QueryCancelledError, never a rejection."""
    s = _session()
    df = tpch.q6(s, tpch.tpch_tables(s, E.tpch_columns(0.001, seed=1))["q6"])
    assert df._physical().cost_ms() is None
    assert df._physical().cost_report.skipped == \
        "no footer-stats-backed scan in the plan"
    with pytest.raises(faults.QueryCancelledError, match="deadline"):
        df.collect(timeout_ms=0.0001)
    c = Q.counters()
    assert "rejected.deadline-unmeetable" not in c
    assert c.get("admitted.batch") == 1
    assert SC.get_query_manager().active_count == 0
    assert df._physical().last_ctx.last_leak_report in (None, [])


def test_port_file_queries_are_priced_as_the_reference(data_dir):
    """A query over files is priced by the cost model: at the same
    explicit constants its admission estimate (device + host ms) is the
    reference's, and an absurd deadline sheds it at admission with the
    reference's kind, before anything runs."""
    consts = {"spark.rapids.sql.cost.deviceSyncFloorMs": 5.0,
              "spark.rapids.sql.cost.deviceThroughputGBps": 3.0,
              "spark.rapids.sql.cost.hostThroughputGBps": 1.5}
    df = tpch.QUERIES["q6"](_session(**consts), data_dir)
    jdf = jtpch.QUERIES["q6"](JSession({
        "spark.rapids.sql.variableFloatAgg.enabled": True,
        "spark.rapids.sql.scheduler.qos.enabled": True, **consts}),
        data_dir)
    jrep = jdf._physical().cost_report
    assert jrep.skipped is None
    assert df._physical().cost_ms() == pytest.approx(
        jrep.est_device_ms + jrep.est_host_ms, rel=1e-12)
    kinds = []
    for d in (df, jdf):
        with pytest.raises(Exception) as ei:
            d.collect(timeout_ms=0.0001)
        kinds.append((type(ei.value).__name__, ei.value.kind))
    assert kinds[0] == kinds[1] == ("QueryRejectedError",
                                    "deadline-unmeetable")
    assert Q.counters().get("rejected.deadline-unmeetable") == 1


def test_deadline_kill_in_flight_matches_reference(data_dir):
    def run(pkg):
        if pkg == "port":
            s, mod = _session(tag=3, chaos="stall@upload/query=3:1"), tpch
        else:
            s = JSession({
                "spark.rapids.sql.variableFloatAgg.enabled": True,
                "spark.rapids.sql.scheduler.qos.enabled": True,
                "spark.rapids.sql.test.faults": "stall@upload/query=3:1",
                "spark.rapids.sql.test.faults.queryTag": 3,
                "spark.rapids.sql.format.scanCache.maxBytes": 0})
            mod = jtpch
        df = mod.QUERIES["q6"](s, data_dir)
        t0 = time.monotonic()
        with pytest.raises(Exception, match="deadline") as ei:
            df.collect(timeout_ms=300)
        ctx = df._physical().last_ctx
        return (type(ei.value).__name__, time.monotonic() - t0 < 10,
                ctx.last_leak_report)

    port = run("port")
    assert SC.counters().get("deadlineKills", 0) == 1
    ref = run("ref")
    assert port == ref == ("QueryCancelledError", True, [])


# ---------------------------------------------------------------------------
# Per-tenant quotas
# ---------------------------------------------------------------------------

def test_tenant_in_flight_quota():
    def run(q_mod, sc):
        conf = _conf("port" if q_mod is Q else "ref", **{
            "spark.rapids.sql.scheduler.qos.tenantMaxInFlight": 1})
        mgr = sc.QueryManager(4, 8, 1000, qos=q_mod.QosPolicy("8,3,1", 8))
        t1 = mgr.admit(conf, tenant="a")
        over = _reject(mgr, conf, tenant="a")
        t2 = mgr.admit(conf, tenant="b")
        mgr.finish(t1)
        again = _reject(mgr, conf, tenant="a")
        mgr.finish(t2)
        return over, again, q_mod.counters().get("rejected.tenant-quota")

    port, ref = _both(run)
    assert port == ref
    assert port[0][:3] == ("QueryRejectedError", "tenant-quota", 0)
    assert port[0][3] is not None and port[1:] == ("admitted", 1)


def test_tenant_catalog_bytes_quota():
    class _Catalog:
        def __init__(self, owned):
            self._owned = owned

        def owned_bytes(self):
            return dict(self._owned)

    class _Ctx:
        def __init__(self, owned):
            self._catalog = _Catalog(owned)

    def run(q_mod, sc):
        conf = _conf("port" if q_mod is Q else "ref", **{
            "spark.rapids.sql.scheduler.qos.tenantMaxCatalogBytes": 1024})
        mgr = sc.QueryManager(4, 8, 1000, qos=q_mod.QosPolicy("8,3,1", 8))
        t1 = mgr.admit(conf, tenant="a")
        mgr.register_context(t1, _Ctx({t1.query_id: 4096}))
        over = _reject(mgr, conf, tenant="a")
        other = _reject(mgr, conf, tenant="b")
        mgr.finish(t1)
        return over, other, _reject(mgr, conf, tenant="a")

    port, ref = _both(run)
    assert port == ref
    assert port[0][1] == "tenant-quota" and port[1:] == ("admitted",
                                                         "admitted")


def test_tenant_catalog_bytes_read_the_real_owner_tag(tmp_path):
    """The byte cap reads ``BufferCatalog.owned_bytes`` of the port's own
    catalog, whose entries carry the admitted query's id."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.host import (HostBatch,
                                                      host_to_device)
    from spark_rapids_tpu_torch.memory.stores import BufferCatalog
    conf = _conf("port", **{
        "spark.rapids.sql.scheduler.qos.tenantMaxCatalogBytes": 64})
    mgr = SC.QueryManager(4, 8, 1000, qos=Q.QosPolicy("8,3,1", 8))
    t1 = mgr.admit(conf, tenant="a")

    class _Ctx:
        _catalog = BufferCatalog(spill_dir=str(tmp_path), owner=t1.query_id)

    batch = host_to_device(HostBatch.from_pydict(
        [("a", dt.INT64)], {"a": list(range(64))}), device="cpu")
    _Ctx._catalog.add_batch(batch)
    owned = _Ctx._catalog.owned_bytes()
    assert list(owned) == [t1.query_id] and owned[t1.query_id] >= 64 * 8
    mgr.register_context(t1, _Ctx())
    assert _reject(mgr, conf, tenant="a")[1] == "tenant-quota"
    mgr.finish(t1)
    _Ctx._catalog.close()


def test_tenant_kernel_cache_quota_counts_zero_entries():
    """Pinned divergence (queue C): the port keeps no kernel cache, so a
    tenant owns zero entries, the compile budget evicts nothing and
    admission never counts ``quotaEvictions``; the key is registered with
    the reference's default."""
    conf = _conf("port", **{
        "spark.rapids.sql.scheduler.qos.tenantMaxKernelCacheEntries": 1})
    mgr = SC.QueryManager(4, 8, 1000, qos=Q.QosPolicy("8,3,1", 8))
    tickets = [mgr.admit(conf, tenant="kq") for _ in range(3)]
    assert mgr.qos.enforce_kernel_quota(conf, "kq") == 0
    assert mgr.qos.quotas.kernel_entries("kq", {}) == 0
    assert "quotaEvictions" not in Q.counters()
    for t in tickets:
        mgr.finish(t)
    assert (C.QOS_TENANT_MAX_KERNEL_ENTRIES.key,
            C.QOS_TENANT_MAX_KERNEL_ENTRIES.default) == \
        (JC.QOS_TENANT_MAX_KERNEL_ENTRIES.key,
         JC.QOS_TENANT_MAX_KERNEL_ENTRIES.default)


def test_tenant_quotas_bookkeeping_units():
    def run(q_mod, _sc):
        tq = q_mod.TenantQuotas()
        for t in ("a", "a", "b"):
            tq.reserve(t)
        out = [(tq.inflight("a"), tq.inflight("b"))]
        for t in ("a", "b", "b"):
            tq.release(t)
        out.append((tq.inflight("a"), tq.inflight("b")))
        tq.record_query(7, "a")
        tq.record_query(8, "b")
        out.append((tq.tenant_of(7), tq.tenant_of(None), tq.query_ids("a"),
                    tq.kernel_entries("a", {"k1": 7, "k2": 8, "k3": None})))
        tq.prune(live_query_ids={8})
        out.append((tq.tenant_of(7), tq.tenant_of(8)))
        return out

    port, ref = _both(run)
    assert port == ref
    assert port == [(2, 1), (1, 0), ("a", None, {7}, 1), (None, "b")]


# ---------------------------------------------------------------------------
# End to end on the port
# ---------------------------------------------------------------------------

def test_per_tenant_plan_cache_counters(data_dir):
    """Tenant-tagged collects count planCacheHit/Miss.<tenant> in the
    FIFO mode too (attribution, not scheduling)."""
    vfa = {"spark.rapids.sql.variableFloatAgg.enabled": True}
    tpch.QUERIES["q6"](TpuSession(dict(vfa), device="cpu"),
                       data_dir).collect(tenant="acme")
    tpch.QUERIES["q6"](TpuSession(dict(vfa), device="cpu"),
                       data_dir).collect(tenant="acme")
    got = Q.counters()
    assert got.get("planCacheMiss.acme") == 1
    assert got.get("planCacheHit.acme") == 1
    assert SC.counters().get("planCacheBindOnly") == 1


def test_per_tenant_chaos_invisible_to_other_tenants(data_dir):
    """Three tenants of three classes in flight, chaos scoped to tenant
    A's query tag: A recovers from a real injection; all three return the
    reference's rows and their solo rows; B and C count no recovery."""
    expect = row_check(
        {"q6": tpch.QUERIES["q6"](_session(), data_dir).collect()}, data_dir)
    chaos = "oom@upload/query=1:1"
    plan = [("A", 1, "interactive"), ("B", 2, "batch"),
            ("C", 3, "background")]
    results, errors, dfs = {}, {}, {}
    barrier = threading.Barrier(len(plan), timeout=30)

    def run(name, tag, prio):
        try:
            df = tpch.QUERIES["q6"](_session(tag=tag, chaos=chaos), data_dir)
            dfs[name] = df
            barrier.wait(timeout=30)
            results[name] = df.collect(priority=prio,
                                       tenant=f"tenant-{name}")
        except BaseException as e:       # pragma: no cover - diagnostics
            errors[name] = e

    threads = [threading.Thread(target=run, args=a, daemon=True)
               for a in plan]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive(), f"{t.name} still running after 60 s"
    assert not errors, errors
    for name, _tag, _p in plan:
        expect(results[name], "q6", name)

    def rec(df):
        m = df.metrics().get("Recovery@query", {})
        return {k: v for k, v in m.items() if v}

    assert rec(dfs["A"]).get("faultsInjected", 0) > 0
    for name in ("B", "C"):
        assert rec(dfs[name]) == {}, name
        assert dfs[name]._physical().last_ctx.last_leak_report in (None, [])
    admitted = Q.counters()
    for cls in Q.CLASSES:
        assert admitted.get(f"admitted.{cls}", 0) >= 1


# ---------------------------------------------------------------------------
# The conf keys
# ---------------------------------------------------------------------------

def _ref_entry(key):
    for v in vars(JC).values():
        if getattr(v, "key", None) == key:
            return v
    raise KeyError(key)


@pytest.mark.parametrize("key", [
    "spark.rapids.sql.concurrentTpuTasks",
    "spark.rapids.sql.scheduler.maxConcurrentQueries",
    "spark.rapids.sql.scheduler.queueDepth",
    "spark.rapids.sql.scheduler.admissionTimeoutMs",
    "spark.rapids.sql.scheduler.queryMemoryFraction",
    "spark.rapids.sql.scheduler.qos.enabled",
    "spark.rapids.sql.scheduler.qos.priorityClass",
    "spark.rapids.sql.scheduler.qos.weights",
    "spark.rapids.sql.scheduler.qos.starvationBound",
    "spark.rapids.sql.scheduler.qos.tenant",
    "spark.rapids.sql.scheduler.qos.tenantMaxInFlight",
    "spark.rapids.sql.scheduler.qos.tenantMaxCatalogBytes",
    "spark.rapids.sql.scheduler.qos.tenantMaxKernelCacheEntries",
    "spark.rapids.sql.scheduler.qos.deadlineAdmission.enabled",
    "spark.rapids.sql.scheduler.qos.deadlineSlack",
    "spark.rapids.sql.scheduler.preemption.enabled",
    "spark.rapids.sql.scheduler.preemption.maxPerQuery",
    "spark.rapids.sql.scheduler.preemption.spill.enabled",
    "spark.rapids.sql.scheduler.pressure.enabled",
    "spark.rapids.sql.scheduler.pressure.shedScore",
    "spark.rapids.sql.scheduler.pressure.brownout.enterScore",
    "spark.rapids.sql.scheduler.pressure.brownout.exitScore",
    "spark.rapids.sql.scheduler.pressure.brownout.sustainMs",
    "spark.rapids.sql.client.retry.maxAttempts",
    "spark.rapids.sql.client.retry.maxBackoffMs",
])
def test_conf_key_matches_reference(key):
    ours, ref = C._REGISTRY[key], _ref_entry(key)
    assert ours.default == ref.default
    assert type(ours.default) is type(ref.default)
    assert ours.get(TpuSession(device="cpu").conf) == \
        ref.get(JSession().conf)
