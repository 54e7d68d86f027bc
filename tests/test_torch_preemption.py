"""Port parity: class-aware device preemption (``memory/stores.py``'s
classed gate, ``plan/planner.py``'s rung 0, ``faults.py``'s preempt
flag), as ``tests/test_preemption.py`` pins the JAX package's.

- Both packages' ``TpuSemaphore`` with fabricated tokens: an interactive
  head waiter asks the running background holder to yield, naming its
  class, and takes the permit only after the release; equal classes
  queue without preempting; a holder whose preemption budget is spent is
  never a victim; ``wait_resume`` is a no-op with preemption off;
  ``check_preempted`` raises only while the flag is set and the budget
  lasts.
- End to end on the port (the reference's data at scale 0.003, 3 files a
  table, seed 11; ``concurrentTpuTasks`` 1): a background q1 yields at a
  partition boundary to an interactive q6, spills, resumes on the same
  context and returns the reference's rows, and its solo rows bit for
  bit, with ``preemptions``, ``preemptedMs`` and ``resumedStages``
  counted and an empty leak report; q6's rows are checked the same way,
  in every scenario below. Faults at the
  ``preempt.spill`` / ``preempt.resume`` sites and an OOM in the victim
  re-enter the ladder with the same rows; ``maxPerQuery`` 0 never yields;
  with preemption off the gate is the flat semaphore.

Every wait is bounded.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import threading
import time

import pytest

from spark_rapids_tpu import faults as jfaults
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.memory import stores as jstores

from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.memory import oom, stores
from spark_rapids_tpu_torch.parallel import scheduler as SC
from spark_rapids_tpu_torch.plan import plan_cache as pc

from test_torch_scheduler import row_check

PKGS = {"port": (stores, faults), "ref": (jstores, jfaults)}


def _reset_sem():
    for st, _f in PKGS.values():
        with st._GLOBAL_SEM_LOCK:
            st._GLOBAL_SEM = None


@pytest.fixture(autouse=True)
def clean_state():
    state = faults.snapshot()
    faults.configure("")
    faults.reset_counters()
    SC.reset_counters()
    oom.reset_degradation()
    # The device semaphore is sized by the first collect of the process:
    # drop it so this module's concurrentTpuTasks 1 takes effect.
    _reset_sem()
    yield
    faults.restore(state)
    SC.reset_counters()
    oom.reset_degradation()
    for st, _f in PKGS.values():
        st._PREEMPT_ENABLED = False
    _reset_sem()
    with SC._MANAGER_LOCK:
        SC._MANAGER = None
    pc.cache().clear()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_torch_preempt"))
    jtpch.generate(d, scale=0.003, files_per_table=3, seed=11)
    return d


def _session(preempt=True, tag=None, chaos=""):
    s = TpuSession({"spark.rapids.sql.variableFloatAgg.enabled": True,
                    "spark.rapids.sql.scheduler.maxConcurrentQueries": 4,
                    "spark.rapids.sql.scheduler.qos.enabled": True,
                    "spark.rapids.sql.scheduler.preemption.enabled": preempt,
                    "spark.rapids.sql.concurrentTpuTasks": 1,
                    "spark.rapids.sql.retry.backoffMs": 1}, device="cpu")
    if chaos:
        s.set("spark.rapids.sql.test.faults", chaos)
        s.set("spark.rapids.sql.test.faults.seed", 11)
        s.set("spark.rapids.sql.format.scanCache.maxBytes", 0)
    if tag is not None:
        s.set("spark.rapids.sql.test.faults.queryTag", tag)
    return s


@pytest.fixture(scope="module")
def expect(data_dir):
    """``expect(rows, qn)`` for q1 (the victim) and q6 (the preemptor):
    the reference's rows, and exactly the port's solo run."""
    solo = {q: tpch.QUERIES[q](_session(False), data_dir).collect()
            for q in ("q1", "q6")}
    pc.cache().clear()
    return row_check(solo, data_dir)


# ---------------------------------------------------------------------------
# The gate, both packages, fabricated tokens
# ---------------------------------------------------------------------------

def _gate(pkg, monkeypatch):
    st, fl = PKGS[pkg]
    monkeypatch.setattr(st, "_PREEMPT_ENABLED", True)
    return st.TpuSemaphore(1), lambda qid, cls: fl.QueryToken(
        qid, qos_class=cls)


def _contend(sem, holder, waiter, settle=0.0):
    """``holder`` holds the gate; ``waiter`` asks on a thread. Returns
    what was observed before the holder released, and whether the waiter
    then got the permit."""
    sem._acquire_classed(holder)
    holders = sem.holders
    got = threading.Event()

    def want():
        sem._acquire_classed(waiter)
        got.set()

    t = threading.Thread(target=want, daemon=True)
    t.start()
    deadline = time.monotonic() + 5
    while settle == 0.0 and not holder.preempt.is_set() \
            and time.monotonic() < deadline:
        time.sleep(0.002)
    if settle:
        time.sleep(settle)
    seen = (holders, holder.preempt_requested(), holder.preemptor_class,
            sem.preempt_requests, got.is_set())
    sem.release_classed(holder)
    granted = got.wait(5)
    sem.release_classed(waiter)
    t.join(5)
    assert not t.is_alive(), "the waiter still waits after 5 s"
    return seen, granted, sem.holders


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_gate_preempts_lower_class(pkg, monkeypatch):
    sem, tok = _gate(pkg, monkeypatch)
    got = _contend(sem, tok(1, "background"), tok(2, "interactive"))
    assert got == (([(1, 2)], True, "interactive", 1, False), True, [])


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_gate_same_class_queues_without_preempting(pkg, monkeypatch):
    sem, tok = _gate(pkg, monkeypatch)
    got = _contend(sem, tok(1, "batch"), tok(2, "batch"), settle=0.1)
    assert got == (([(1, 1)], False, None, 0, False), True, [])


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_gate_skips_budget_spent_victims(pkg, monkeypatch):
    sem, tok = _gate(pkg, monkeypatch)
    bg = tok(1, "background")
    bg.preempt_enabled = False
    got = _contend(sem, bg, tok(2, "interactive"), settle=0.1)
    assert got == (([(1, 2)], False, None, 0, False), True, [])
    assert not bg.preempt.is_set()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_gate_picks_the_worst_ranked_holder(pkg, monkeypatch):
    st, fl = PKGS[pkg]
    monkeypatch.setattr(st, "_PREEMPT_ENABLED", True)
    sem = st.TpuSemaphore(2)
    batch, bg = (fl.QueryToken(1, qos_class="batch"),
                 fl.QueryToken(2, qos_class="background"))
    sem._acquire_classed(batch)
    sem._acquire_classed(bg)
    it = fl.QueryToken(3, qos_class="interactive")
    got = threading.Event()
    t = threading.Thread(target=lambda: (sem._acquire_classed(it),
                                         got.set()), daemon=True)
    t.start()
    deadline = time.monotonic() + 5
    while not bg.preempt.is_set() and time.monotonic() < deadline:
        time.sleep(0.002)
    assert (bg.preempt_requested(), batch.preempt_requested()) == \
        (True, False)
    sem.release_classed(bg)
    assert got.wait(5), "the interactive waiter got no permit in 5 s"
    for tk in (batch, it):
        sem.release_classed(tk)
    t.join(5)
    assert not t.is_alive(), "the interactive waiter still waits after 5 s"
    assert sem.holders == []


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_wait_resume_noop_when_disabled(pkg):
    st, fl = PKGS[pkg]
    sem = st.TpuSemaphore(1)
    t0 = time.monotonic()
    sem.wait_resume(fl.QueryToken(1, qos_class="background"))
    assert time.monotonic() - t0 < 0.5


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_check_preempted_honors_flag_and_budget(pkg):
    _st, fl = PKGS[pkg]
    tok = fl.QueryToken(7, qos_class="background")
    fl.set_query_token(tok)
    try:
        fl.check_preempted()
        tok.request_preempt("interactive")
        with pytest.raises(fl.QueryPreemptedError) as ei:
            fl.check_preempted()
        assert (ei.value.preemptor, ei.value.query_id) == ("interactive", 7)
        assert "PREEMPTED" in str(ei.value)
        tok.clear_preempt()
        fl.check_preempted()
        tok.request_preempt("interactive")
        tok.preempt_enabled = False
        fl.check_preempted()
    finally:
        fl.set_query_token(None)


def test_preempted_error_message_matches_reference():
    assert str(faults.QueryPreemptedError(3, "interactive")) == \
        str(jfaults.QueryPreemptedError(3, "interactive"))
    assert str(faults.QueryPreemptedError(3)) == \
        str(jfaults.QueryPreemptedError(3))
    assert not oom.is_transient_error(faults.QueryPreemptedError(3))


# ---------------------------------------------------------------------------
# End to end on the port
# ---------------------------------------------------------------------------

def test_flat_semaphore_unchanged_when_disabled(data_dir, expect):
    bg = tpch.QUERIES["q6"](_session(False), data_dir) \
        .submit(priority="background")
    fg = tpch.QUERIES["q6"](_session(False), data_dir) \
        .collect(priority="interactive")
    expect(fg, "q6")
    expect(bg.result(timeout=60), "q6")
    assert SC.counters().get("preemptions", 0) == 0
    sem = stores.get_tpu_semaphore(1)
    assert sem.holders == [] and sem.preempt_requests == 0
    assert sem.max_in_use == 1


def _scenario(data_dir, bg_chaos="", bg_tag=None, attempts=3):
    """A background q1 holds the gate, then an interactive q6 collects;
    the whole scenario again where timing gave no preemption window. A
    fault at a ``preempt.*`` site fires inside the preemption rung only,
    so it too shows that the victim yielded."""
    sem = stores.get_tpu_semaphore(1)
    for _ in range(attempts):
        SC.reset_counters()
        df_bg = tpch.QUERIES["q1"](_session(tag=bg_tag, chaos=bg_chaos),
                                   data_dir)
        handle = df_bg.submit(priority="background")
        deadline = time.monotonic() + 30
        while not sem.holders and not handle.done() \
                and time.monotonic() < deadline:
            time.sleep(0.001)
        fg = tpch.QUERIES["q6"](_session(), data_dir) \
            .collect(priority="interactive")
        bg = handle.result(timeout=60)
        fired = any(k.startswith("faultsInjected.") and "@preempt." in k
                    for k in faults.counters())
        if SC.counters().get("preemptions", 0) >= 1 or fired:
            return bg, fg, df_bg
    pytest.fail(f"no preemption in {attempts} scenario attempts")


def test_preemption_end_to_end_bit_identical(data_dir, expect):
    bg, fg, df_bg = _scenario(data_dir)
    expect(fg, "q6")
    expect(bg, "q1")
    ctrs = SC.counters()
    assert ctrs["preemptedMs"] > 0 and ctrs["resumedStages"] >= 1
    sched = df_bg.metrics()["Scheduler@query"]
    assert sched["preemptions"] >= 1 and sched["resumedStages"] >= 1
    assert sched["class.background"] == 1
    assert stores.get_tpu_semaphore(1).preempt_requests >= 1
    assert stores.get_tpu_semaphore(1).max_in_use == 1
    ctx = df_bg._physical().last_ctx
    assert ctx.last_leak_report == []


@pytest.mark.parametrize("kind,site", [
    ("transient", "preempt.spill"), ("transient", "preempt.resume"),
    ("lostoutput", "preempt.resume")])
def test_preemption_chaos_mid_rung(data_dir, expect, kind, site):
    """A fault mid-spill or mid-resume re-enters the ladder (a same-
    context transient retry): the same rows, the retry and the injection
    counted, nothing leaked."""
    bg, fg, df_bg = _scenario(data_dir, bg_chaos=f"{kind}@{site}/query=1:1",
                              bg_tag=1)
    expect(fg, "q6")
    expect(bg, "q1")
    c = faults.counters()
    assert c.get("retriesAttempted", 0) >= 1
    assert c.get(f"faultsInjected.{kind}@{site}", 0) == 1
    assert df_bg._physical().last_ctx.last_leak_report == []


def test_preemption_chaos_oom_in_victim(data_dir, expect):
    bg, fg, df_bg = _scenario(data_dir, bg_chaos="oom@upload/query=1:1",
                              bg_tag=1)
    expect(fg, "q6")
    expect(bg, "q1")
    assert faults.counters().get("retriesAttempted", 0) >= 1
    assert df_bg._physical().last_ctx.last_leak_report == []


def test_preemption_budget_caps_yields(data_dir, expect):
    """maxPerQuery 0: a request is declined at once; the victim finishes
    without a suspension, its rows unchanged."""
    sem = stores.get_tpu_semaphore(1)
    s = _session()
    s.set("spark.rapids.sql.scheduler.preemption.maxPerQuery", 0)
    df_bg = tpch.QUERIES["q1"](s, data_dir)
    handle = df_bg.submit(priority="background")
    deadline = time.monotonic() + 30
    while not sem.holders and not handle.done() \
            and time.monotonic() < deadline:
        time.sleep(0.001)
    fg = tpch.QUERIES["q6"](_session(), data_dir) \
        .collect(priority="interactive")
    expect(fg, "q6")
    expect(handle.result(timeout=60), "q1")
    assert SC.counters().get("preemptions", 0) == 0
