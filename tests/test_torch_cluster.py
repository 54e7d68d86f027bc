"""Port parity: the cluster runtime's core (``parallel/cluster/``:
coordinator, worker, journal; ``parallel/broadcast_cache.py``), as
``tests/test_cluster.py`` pins the JAX package's, on the CPU.

- ``stage_plan``: the dispatchable stages and their dispatchable
  dependencies of q3 (broadcasts off) and of a plan with a broadcast
  stage between two shuffles equal the reference's.
- The coordinators: the same verb lines (``CREG``, ``CBEAT``, ``CPOLL``,
  ``CDONE``, ``CFAIL``, ``CDEMO``, ``CDRAIN``, ``CSTATS``) sent over the
  socket to the port's and the reference's server, each holding q3's
  tasks, get the same replies (the plan file's path aside); the retry
  budget, the min-workers gate and the stale-query report as in the
  reference; ``_hrw_owner`` and ``replay_state`` agree on the same
  inputs; a coordinator made over a journaled directory replays it.
- The exclusive manifest and the fetch-only session on the hostfile
  spool: a recompute's commit replaces the manifest whole, and a
  consumer's teardown never deletes the producer's output.
- A driver and two port worker processes on the CPU (``--device cpu``,
  placement off, ``minWorkers`` 2): q1 and q3 equal the port's
  single-process rows exactly and the reference's within
  ``approx_float``; stages dispatched, each worker completed at least
  one. One worker SIGKILLed at its first stage
  (``workerdeath@cluster.stage:1``) costs exactly one stage recompute
  and no query retry, with the same rows.
- The broadcast cache: a single published once is adopted by another
  process's exchange; a bumped upstream generation is a miss; the key
  off or no cluster marker bypasses it; hits, misses and publishes
  counted.
- The stand-downs: off by default (no coordinator made), the mesh
  transport, a host-placed plan, a plan with no dispatchable stage;
  ``cluster.coordinator.remote=true`` raises ``NotPortedError``.
- Every ``cluster.*`` and ``broadcast.cache.*`` key of this half has the
  reference's name and default.

Every subprocess has its own timeout and is killed in ``finally``.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import base64
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from harness import assert_rows_equal

from spark_rapids_tpu import config as JC
from spark_rapids_tpu import faults as jfaults
from spark_rapids_tpu.api.dataframe import TpuSession as JSession
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.parallel import cluster as JCL
from spark_rapids_tpu.parallel.cluster import coordinator as JCO
from spark_rapids_tpu.parallel.cluster import journal as JJ

import spark_rapids_tpu_torch
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.host import (
    HostBatch, HostColumn, device_to_host, host_to_device)
from spark_rapids_tpu_torch.parallel import cluster as CL
from spark_rapids_tpu_torch.parallel import transport as T
from spark_rapids_tpu_torch.parallel.cluster import coordinator as CO
from spark_rapids_tpu_torch.parallel.cluster import journal as J
from spark_rapids_tpu_torch.parallel.transport import rendezvous as RV
from spark_rapids_tpu_torch.parallel.transport.hostfile import \
    HostFileTransport
from spark_rapids_tpu_torch.plan import plan_cache as pc
from spark_rapids_tpu_torch.plan.logical import NotPortedError

REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.abspath(spark_rapids_tpu_torch.__file__)))
WORKER_TIMEOUT_S = 120
VFA = {"spark.rapids.sql.variableFloatAgg.enabled": True,
       "spark.rapids.sql.cost.enabled": False}


@pytest.fixture(autouse=True)
def _clean():
    state = faults.snapshot()
    faults.configure("")
    faults.reset_counters()
    jfaults.configure("")
    yield
    CL.shutdown_coordinator()
    JCL.shutdown_coordinator()
    faults.restore(state)
    jfaults.configure("")
    pc.cache().clear()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_cluster"))
    jtpch.generate(d, scale=0.003, files_per_table=3, seed=7)
    return d


def _port(tmp_path, cluster=False, **over):
    conf = dict(VFA, **{C.CLUSTER_DIR.key: str(tmp_path / "cluster")})
    if cluster:
        conf[C.CLUSTER_ENABLED.key] = True
    conf.update(over)
    return TpuSession(conf, device="cpu")


def _ref(tmp_path, cluster=False, **over):
    s = JSession()
    for k, v in VFA.items():
        s.set(k, v)
    s.set("spark.rapids.sql.cluster.dir", str(tmp_path / "ref_cluster"))
    if cluster:
        s.set("spark.rapids.sql.cluster.enabled", True)
    for k, v in over.items():
        s.set(k, v)
    return s


NO_BCAST = {"spark.rapids.sql.autoBroadcastJoinThreshold": -1}


# ---------------------------------------------------------------------------
# The stage DAG
# ---------------------------------------------------------------------------

def test_q3_stage_plan_matches_reference(data_dir, tmp_path):
    g, disp, deps = CO.stage_plan(tpch.QUERIES["q3"](
        _port(tmp_path, **NO_BCAST), data_dir)._physical().root)
    jg, jdisp, jdeps = JCO.stage_plan(jtpch.QUERIES["q3"](
        _ref(tmp_path, **NO_BCAST), data_dir)._physical().root)
    assert disp and disp == jdisp
    assert deps == jdeps
    assert any(deps[s] for s in disp)
    assert sorted(g.stages) == sorted(jg.stages)
    for sid in g.stages:
        b, jb = g.stages[sid].boundary, jg.stages[sid].boundary
        assert type(b).__name__ == type(jb).__name__


def test_broadcast_stage_plan_matches_reference():
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
    from spark_rapids_tpu.ops.base import InMemorySourceExec as JSrc
    from spark_rapids_tpu.parallel import SinglePartitioning as JSingle
    from spark_rapids_tpu.parallel.exchange import (
        BroadcastExchangeExec as JBx, ShuffleExchangeExec as JSx)
    from spark_rapids_tpu_torch.ops import InMemorySourceExec
    from spark_rapids_tpu_torch.parallel.exchange import (
        BroadcastExchangeExec, ShuffleExchangeExec)
    from spark_rapids_tpu_torch.parallel.partitioning import \
        SinglePartitioning

    def build(Src, Sx, Bx, Single, D, HB, **kw):
        schema = (("a", D.INT64),)
        src = Src(schema, [[HB.from_pydict(schema, {"a": [1, 2, 3]})]],
                  **kw)
        inner = Sx(src, Single())
        bx = Bx(inner)
        top = Sx(bx, Single())
        return top, bx, inner

    top, bx, inner = build(InMemorySourceExec, ShuffleExchangeExec,
                           BroadcastExchangeExec, SinglePartitioning, dt,
                           HostBatch, device="cpu")
    jtop, jbx, jinner = build(JSrc, JSx, JBx, JSingle, jdt, JHostBatch)
    g, disp, deps = CO.stage_plan(top)
    jg, jdisp, jdeps = JCO.stage_plan(jtop)
    assert (disp, deps) == (jdisp, jdeps)
    ids = [g.by_exchange[id(e)] for e in (top, bx, inner)]
    assert ids == [jg.by_exchange[id(e)] for e in (jtop, jbx, jinner)]
    tsid, bsid, isid = ids
    assert bsid not in disp and isid in disp and tsid in disp
    assert deps[bsid] == {isid} and deps[tsid] == {isid}
    # The broadcast stage's cache key follows its upstream generations.
    info = CO.ClusterExecInfo("/nowhere", "w", {}, bcast_tags={
        id(bx): bsid}, bcast_deps={bsid: [isid]}, plan_fp="f00",
        gen_source=lambda: {isid: 2})
    assert info.broadcast_tag(bx) == f"bc-f00-s{bsid}-g2"
    assert info.broadcast_tag(top) is None


def test_hrw_owner_and_replay_state_agree():
    rng = np.random.default_rng(3)
    for _ in range(20):
        wids = [f"w{int(i)}" for i in rng.choice(50, rng.integers(1, 6),
                                                 replace=False)]
        for sid in range(12):
            assert CO._hrw_owner(wids, sid) == JCO._hrw_owner(wids, sid)
    assert CO._hrw_owner([], 3) is None is JCO._hrw_owner([], 3)
    recs = [
        {"t": "reg", "wid": "wA"}, {"t": "reg", "wid": "wB"},
        {"t": "submit", "qid": 3, "stages": [1, 2, 4],
         "deps": {"1": [], "2": [1], "4": [2]}, "conf": {},
         "pkl": "/p/q3/plan.pkl", "store": ["hostfile", "", ""],
         "fp": "abc"},
        {"t": "dispatch", "qid": 3, "sid": 1, "gen": 0, "wid": "wA"},
        {"t": "done", "qid": 3, "sid": 1, "gen": 0, "wid": "wA",
         "bytes": 77},
        {"t": "dispatch", "qid": 3, "sid": 2, "gen": 0, "wid": "wB"},
        {"t": "requeue", "qid": 3, "sid": 2, "gen": 1},
        {"t": "dispatch", "qid": 3, "sid": 2, "gen": 0, "wid": "wB"},
        {"t": "dispatch", "qid": 3, "sid": 2, "gen": 1, "wid": "wA"},
        {"t": "drain", "wid": "wB"},
        {"t": "submit", "qid": 5, "stages": [1], "deps": {"1": []},
         "conf": {}, "pkl": "/p/q5/plan.pkl"},
        {"t": "finish", "qid": 5},
        {"t": "reg", "wid": "wC"}, {"t": "retire", "wid": "wC"},
        {"t": "bogus"}, {"t": "submit", "qid": "x"}]
    assert J.replay_state(recs) == JJ.replay_state(recs)
    st = J.replay_state(recs)
    assert st["next_qid"] == 6 and st["draining"] == ["wB"]


def test_journal_tolerates_a_torn_line(tmp_path):
    for Jm in (J, JJ):
        path = str(tmp_path / f"{Jm.__name__}.jsonl")
        jr = Jm.Journal(path, fsync=True)
        jr.append({"t": "reg", "wid": "wA"})
        jr.append({"t": "submit", "qid": 1, "stages": [1]})
        with open(path, "a", encoding="utf-8") as f:
            f.write('{"t": "done", "qid": 1, "si')
        assert [r["t"] for r in jr.records()] == ["reg", "submit"]
    def untimed(Jm):
        return [{k: v for k, v in r.items() if k != "ts"} for r in
                Jm.Journal(str(tmp_path / f"{Jm.__name__}.jsonl")).records()]
    assert untimed(J) == untimed(JJ)


# ---------------------------------------------------------------------------
# The coordinators, verb for verb
# ---------------------------------------------------------------------------

def _coordinators(data_dir, tmp_path, **over):
    ps = _port(tmp_path, cluster=True, **NO_BCAST, **over)
    rs = _ref(tmp_path, cluster=True, **NO_BCAST, **over)
    co = CL.get_coordinator(ps.conf)
    jco = JCL.get_coordinator(rs.conf)
    q = co.submit(tpch.QUERIES["q3"](ps, data_dir)._physical(), ps.conf)
    jq = jco.submit(jtpch.QUERIES["q3"](rs, data_dir)._physical(), rs.conf)
    assert q is not None and jq is not None
    return (co, q), (jco, jq)


def _send(co, line: str) -> str:
    return RV._roundtrip(co.addr, line + "\n", timeout_s=10.0, retries=1,
                         backoff_ms=10)


def _norm(reply: str, q) -> str:
    """A reply with the query's plan-file path (base64) made neutral."""
    b64 = base64.b64encode(q.pkl_path.encode()).decode()
    return reply.replace(b64, "<plan>")


def test_coordinator_verbs_reply_as_the_reference(data_dir, tmp_path):
    (co, q), (jco, jq) = _coordinators(data_dir, tmp_path)
    assert q.qid == jq.qid and sorted(q.tasks) == sorted(jq.tasks)

    def both(line):
        got, want = _send(co, line), _send(jco, line)
        assert _norm(got, q) == _norm(want, jq), line
        return got.split()

    assert both("CREG wA tok1") == ["OK"]
    assert both("CBEAT wA") == ["OK"]
    done = []
    while True:
        resp = both("CPOLL wA -")
        if resp[0] == "CIDLE":
            break
        assert resp[0] == "CTASK" and int(resp[1]) == q.qid
        sid, gen = int(resp[2]), int(resp[3])
        for d in q.tasks[sid].deps:
            assert q.tasks[d].status == "done"
        assert base64.b64decode(resp[5]).decode() == q.pkl_path
        if not done:
            # The first stage fails once: it requeues at the next
            # generation, as in the reference.
            msg = base64.b64encode(b"boom").decode()
            assert both(f"CFAIL wA {q.qid} {sid} {gen} - {msg}") == ["OK"]
            assert q.tasks[sid].gen == jq.tasks[sid].gen == gen + 1
            done.append(None)
            continue
        assert both(f"CDONE wA {q.qid} {sid} {gen} 100") == ["OK"]
        done.append(sid)
    assert sorted(done[1:]) == sorted(q.tasks)
    for sid in q.tasks:
        t, jt = q.tasks[sid], jq.tasks[sid]
        assert (t.status, t.producer, t.gen, t.retries, t.bytes) == \
            (jt.status, jt.producer, jt.gen, jt.retries, jt.bytes)
    assert both("CDEMO wA 1") == ["OK"]
    assert both("CDRAIN wA") == ["OK"]
    assert both("CPOLL wA -") == ["CRETIRE"]
    got = json.loads(base64.b64decode(_send(co, "CSTATS").split()[1]))
    want = json.loads(base64.b64decode(_send(jco, "CSTATS").split()[1]))
    assert sorted(got) == sorted(want)
    assert got["queries"] == want["queries"]


def test_retry_budget_gate_and_stale_queries_as_the_reference(
        data_dir, tmp_path):
    over = {"spark.rapids.sql.cluster.maxTaskRetries": 1,
            "spark.rapids.sql.cluster.minWorkers": 2}
    (co, q), (jco, jq) = _coordinators(data_dir, tmp_path, **over)
    for c in (co, jco):
        c.dispatch(["CREG", "wA"])
    # The gate holds at one worker.
    assert co.dispatch(["CPOLL", "wA", "-"]) == \
        jco.dispatch(["CPOLL", "wA", "-"]) == b"CIDLE -\n"
    sid = min(q.tasks)
    for c, qq, E in ((co, q, CO.ClusterDispatchError),
                     (jco, jq, JCO.ClusterDispatchError)):
        with c._lock:
            qq._requeue_locked(qq.tasks[sid], "first")
            assert qq.error is None
            qq._requeue_locked(qq.tasks[sid], "second")
            assert isinstance(qq.error, E)
    assert str(q.error).split(":")[0] == str(jq.error).split(":")[0]
    for c, qq in ((co, q), (jco, jq)):
        qq.finish()
    assert co.dispatch(["CPOLL", "wA", str(q.qid)]) == \
        jco.dispatch(["CPOLL", "wA", str(jq.qid)])


def test_journal_replay_restores_the_run_as_the_reference(data_dir,
                                                         tmp_path):
    """One stage committed, one in flight, the coordinator closed with
    its directory kept; one made over the directory replays the journal:
    the in-flight task stays running at its generation (its worker's
    late CDONE still lands), the committed one, whose manifest was never
    written, requeues at the next generation. The same in both."""

    def replayed(Cm, COm, session):
        co = Cm.get_coordinator(session.conf)
        Q = tpch.QUERIES if Cm is CL else jtpch.QUERIES
        q = co.submit(Q["q3"](session, data_dir)._physical(),
                      session.conf)
        co.dispatch(["CREG", "wA"])
        first = co.dispatch(["CPOLL", "wA", "-"]).decode().split()
        co.dispatch(["CDONE", "wA", first[1], first[2], first[3], "5"])
        co.dispatch(["CPOLL", "wA", "-"])
        co.close(remove_dir=False)
        COm._CO = None      # closed above, its directory kept
        co2 = COm.ClusterCoordinator(session.conf)
        try:
            q2 = co2.queries[q.qid]
            return (co2._next_qid, sorted(co2.workers),
                    {sid: (t.status, t.gen, t.retries)
                     for sid, t in q2.tasks.items()})
        finally:
            co2.close()

    got = replayed(CL, CO, _port(tmp_path, cluster=True, **NO_BCAST))
    want = replayed(JCL, JCO, _ref(tmp_path, cluster=True, **NO_BCAST))
    assert got == want
    states = sorted(v[:2] for v in got[2].values())
    assert ("running", 0) in states and ("pending", 1) in states


# ---------------------------------------------------------------------------
# Exclusive manifest and fetch-only sessions
# ---------------------------------------------------------------------------

def _exclusive_conf(tmp_path, wid):
    return C.TpuConf({
        C.SHUFFLE_TRANSPORT_HOSTFILE_DIR.key: str(tmp_path),
        C.SHUFFLE_TRANSPORT_HOSTFILE_WORKER_ID.key: wid,
        C.SHUFFLE_TRANSPORT_HOSTFILE_EXCLUSIVE_MANIFEST.key: True})


def _kv(keys, vals):
    return host_to_device(HostBatch(
        ("k", "v"),
        [HostColumn(dt.INT64, np.asarray(keys, np.int64),
                    np.ones(len(keys), bool)),
         HostColumn(dt.INT64, np.asarray(vals, np.int64),
                    np.ones(len(vals), bool))]), device="cpu")


def _rows(handles):
    return [r for h in handles for r in device_to_host(h.get()).to_pylist()]


def _open(tmp_path, wid, tag, n):
    return HostFileTransport().open(_exclusive_conf(tmp_path, wid), tag, n,
                                    owner=1, device="cpu")


def test_recompute_commit_replaces_the_manifest(tmp_path):
    w1 = _open(tmp_path, "dead", "s5", 2)
    w1.write_shard(0, _kv([1, 2], [10, 20]))
    w1.write_shard(1, _kv([3], [30]))
    w1.commit()
    path = os.path.join(str(tmp_path), "s5", "exchange.manifest.json")
    with open(path, encoding="utf-8") as f:
        assert json.load(f)["worker"] == "dead"
    w2 = _open(tmp_path, "survivor", "s5", 2)
    w2.write_shard(0, _kv([1, 2], [10, 20]))
    w2.write_shard(1, _kv([3], [30]))
    w2.commit()
    with open(path, encoding="utf-8") as f:
        m = json.load(f)
    assert m["worker"] == "survivor"
    files = [e["file"] for es in m["shards"].values() for e in es]
    assert files and all(f.startswith("survivor/") for f in files)
    assert [n for n in os.listdir(os.path.join(str(tmp_path), "s5"))
            if n.endswith(".manifest.json")] == ["exchange.manifest.json"]
    r = _open(tmp_path, "reader", "s5", 2)
    assert len(r._load_manifests()) == 1
    assert _rows(r.fetch_shards(0)) == [(1, 10), (2, 20)]
    assert _rows(r.fetch_shards(1)) == [(3, 30)]
    assert CO.ClusterExecInfo.adopt_manifest(r, 2) == [2, 1]


def test_fetch_only_session_never_deletes_the_producer(tmp_path):
    w = _open(tmp_path, "prod", "s1", 1)
    w.write_shard(0, _kv([7], [70]))
    w.commit()
    r = _open(tmp_path, "cons", "s1", 1)
    r.fetch_only = True
    assert _rows(r.fetch_shards(0)) == [(7, 70)]
    r.invalidate()
    r.close()
    # keep_on_close: a cluster stage output outlives its context.
    w.keep_on_close = True
    w.close()
    assert _rows(_open(tmp_path, "cons2", "s1", 1).fetch_shards(0)) == \
        [(7, 70)]


# ---------------------------------------------------------------------------
# Worker processes
# ---------------------------------------------------------------------------

def _spawn_worker(addr, wid, extra_env=None):
    env = dict(os.environ)
    env.pop("SRT_FAULTS", None)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    if extra_env:
        env.update(extra_env)
    return subprocess.Popen(
        [sys.executable, "-m", "spark_rapids_tpu_torch.parallel.cluster."
         "worker", "--coordinator", addr, "--worker-id", wid, "--device",
         "cpu", "--heartbeat-ms", "500", "--poll-ms", "10", "--log-level",
         "WARNING"], env=env, cwd=REPO_ROOT)


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=20)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)


def _collect_with_timeout(df, timeout_s=WORKER_TIMEOUT_S):
    out = {}

    def run():
        try:
            out["rows"] = df.collect()
        except BaseException as e:      # surfaced below
            out["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout_s)
    assert not th.is_alive(), f"collect still running after {timeout_s} s"
    if "err" in out:
        raise out["err"]
    return out["rows"]


def test_pickled_scans_run_in_a_fresh_process(data_dir, tmp_path):
    """A worker's case without the cluster: q4's and q18's plans over
    parquet, pickled here and run one after the other in a fresh
    process, whose first arrow allocation would otherwise come from a
    short-lived prefetch thread (pyarrow's mimalloc pool then segfaulted
    in ``ParquetFile``)."""
    import pickle
    queries = ("q4", "q18")
    conf = {"spark.rapids.sql.cost.enabled": False}
    want = {}
    for q in queries:
        phys = tpch.QUERIES[q](_port(tmp_path, **conf), data_dir)._physical()
        with open(tmp_path / f"{q}.pkl", "wb") as f:
            pickle.dump(phys, f)
        want[q] = phys.collect()
    script = (
        "import pickle, sys\n"
        "for q in sys.argv[2:]:\n"
        "    with open(f'{sys.argv[1]}/{q}.pkl', 'rb') as f:\n"
        "        rows = pickle.load(f).collect()\n"
        "    with open(f'{sys.argv[1]}/{q}.rows', 'wb') as f:\n"
        "        pickle.dump(rows, f)\n")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO_ROOT
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("SRT_FAULTS", None)
    r = subprocess.run([sys.executable, "-c", script, str(tmp_path),
                        *queries], env=env, cwd=REPO_ROOT,
                       capture_output=True, text=True,
                       timeout=WORKER_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-2000:]
    for q in queries:
        with open(tmp_path / f"{q}.rows", "rb") as f:
            assert_rows_equal(pickle.load(f), want[q], approx_float=True,
                              msg=f"{q} in a fresh process")


def test_driver_plus_two_workers_match_reference(data_dir, tmp_path):
    queries = ("q1", "q3")
    single = {q: tpch.QUERIES[q](_port(tmp_path), data_dir).collect()
              for q in queries}
    sc = _port(tmp_path, cluster=True, **{
        "spark.rapids.sql.cluster.minWorkers": 2,
        "spark.rapids.sql.cluster.dispatchTimeoutMs":
            WORKER_TIMEOUT_S * 1000})
    co = CL.get_coordinator(sc.conf)
    addr = f"{co.addr[0]}:{co.addr[1]}"
    # Each query's stages form a chain: its leaf goes to the leaf's
    # rendezvous-hash owner and the rest follow its shards. Under these
    # two ids q1's leaf (stage 2) hashes to wA and q3's (stage 3) to wB.
    wids = ("wA", "wB")
    assert [CO._hrw_owner(list(wids), s) for s in (2, 3)] == list(wids)
    procs = [_spawn_worker(addr, w) for w in wids]
    try:
        for q in queries:
            df = tpch.QUERIES[q](sc, data_dir)
            got = _collect_with_timeout(df)
            assert got == single[q], q
            assert df.metrics()["Cluster@query"]["stagesDispatched"] >= 1
            want = jtpch.QUERIES[q](_ref(tmp_path), data_dir).collect_host()
            assert_rows_equal(got, want, approx_float=True,
                              msg=f"{q} cluster vs reference")
        st = co.stats()["workers"]
        assert all(st[w]["completed"] >= 1 for w in wids), st
        assert all(p.poll() is None for p in procs)
    finally:
        _stop(procs)
    # The query's spool went with its run.
    spool = [f for a, _, fs in os.walk(co.base_dir) for f in fs
             if "journal" not in a]
    assert spool == []


def test_worker_death_costs_one_stage_recompute(data_dir, tmp_path):
    want = tpch.QUERIES["q3"](_port(tmp_path, **NO_BCAST),
                              data_dir).collect()
    sc = _port(tmp_path, cluster=True, **NO_BCAST, **{
        "spark.rapids.sql.cluster.heartbeatTimeoutMs": 3000,
        "spark.rapids.sql.cluster.dispatchTimeoutMs":
            WORKER_TIMEOUT_S * 1000})
    co = CL.get_coordinator(sc.conf)
    addr = f"{co.addr[0]}:{co.addr[1]}"
    # The armed worker starts alone, takes the first stage and SIGKILLs
    # itself there; the survivor starts once the death is declared.
    procs = [_spawn_worker(addr, "w0", {
        "SRT_FAULTS": "workerdeath@cluster.stage:1"})]

    def spawn_survivor():
        end = time.monotonic() + WORKER_TIMEOUT_S
        while time.monotonic() < end:
            st = co.stats()["workers"]
            if "w0" in st and not st["w0"]["alive"]:
                procs.append(_spawn_worker(addr, "w1"))
                return
            time.sleep(0.05)

    th = threading.Thread(target=spawn_survivor, daemon=True)
    th.start()
    try:
        c0 = dict(faults.counters())
        got = _collect_with_timeout(tpch.QUERIES["q3"](sc, data_dir))
        c1 = faults.counters()
        delta = {k: c1.get(k, 0) - c0.get(k, 0) for k in (
            "clusterWorkerDeaths", "stageRecomputes", "retriesAttempted")}
        assert got == want
        assert delta == {"clusterWorkerDeaths": 1, "stageRecomputes": 1,
                         "retriesAttempted": 0}
        assert procs[0].wait(timeout=30) == -9
    finally:
        th.join(5)
        _stop(procs)


# ---------------------------------------------------------------------------
# Stand-downs and keys
# ---------------------------------------------------------------------------

def test_disabled_by_default_makes_no_coordinator(data_dir, tmp_path):
    s = _port(tmp_path)
    assert not CO.cluster_enabled(s.conf)
    tpch.QUERIES["q1"](s, data_dir).collect()
    assert CO._CO is None


@pytest.mark.parametrize("why", ["mesh", "host_placed", "no_stage"])
def test_stand_downs_run_locally(why, data_dir, tmp_path):
    over = {"spark.rapids.sql.cluster.dispatchTimeoutMs": 2000}
    if why == "mesh":
        over[C.SHUFFLE_TRANSPORT.key] = "mesh"
    if why == "host_placed":
        # Constants under which the cost model puts this small plan on
        # the host (those of tests/test_torch_cost.py).
        over.update({"spark.rapids.sql.cost.enabled": True,
                     "spark.rapids.sql.cost.deviceSyncFloorMs": 4.0,
                     "spark.rapids.sql.cost.deviceThroughputGBps": 2.5,
                     "spark.rapids.sql.cost.hostThroughputGBps": 0.9})
    sc = _port(tmp_path, cluster=True, **over)
    if why == "no_stage":
        df = sc.create_dataframe({"k": ["a", "b", "c"], "v": [1, 2, 3]},
                                 [("k", dt.STRING), ("v", dt.INT32)])
        from spark_rapids_tpu_torch.plan.logical import col
        got = df.filter(col("v") > 1).select("k").collect()
        assert sorted(got) == [("b",), ("c",)]
        assert "Cluster@query" not in df.metrics()
        return
    df = tpch.QUERIES["q1"](sc, data_dir)
    phys = df._physical()
    if why == "host_placed":
        assert not phys.root_on_device
    want = tpch.QUERIES["q1"](_port(tmp_path, **over), data_dir).collect()
    t0 = time.monotonic()
    assert df.collect() == want
    assert time.monotonic() - t0 < 2.0      # no dispatch wait
    assert "Cluster@query" not in df.metrics()
    co = CO._CO
    assert co is None or not co.queries


def test_remote_coordinator_raises_not_ported(data_dir, tmp_path):
    sc = _port(tmp_path, cluster=True, **{
        "spark.rapids.sql.cluster.coordinator.remote": True})
    with pytest.raises(NotPortedError, match="remote.py"):
        tpch.QUERIES["q1"](sc, data_dir).collect()
    assert CO._CO is None


def test_cluster_keys_are_the_references():
    names = ("CLUSTER_ENABLED", "CLUSTER_COORDINATOR",
             "CLUSTER_COORDINATOR_REMOTE", "CLUSTER_DIR",
             "CLUSTER_DISPATCH_TIMEOUT_MS", "CLUSTER_HEARTBEAT_TIMEOUT_MS",
             "CLUSTER_JOURNAL_ENABLED", "CLUSTER_JOURNAL_FSYNC",
             "CLUSTER_MAX_TASK_RETRIES", "CLUSTER_MIN_WORKERS",
             "CLUSTER_POLL_MS", "CLUSTER_STEAL_DELAY_MS",
             "BROADCAST_CACHE_ENABLED", "BROADCAST_CACHE_FETCH_TIMEOUT_MS",
             "MESH_DEGRADE_ENABLED")
    for n in names:
        mine, ref = getattr(C, n), getattr(JC, n)
        assert (mine.key, mine.default) == (ref.key, ref.default), n


# ---------------------------------------------------------------------------
# The broadcast cache
# ---------------------------------------------------------------------------

def test_broadcast_cache_publishes_once_and_fetches(tmp_path):
    """The first process to build a broadcast single publishes it under
    its generation-keyed tag; another process's exchange adopts it
    instead of collecting its child; a bumped upstream generation (a
    recompute) is a miss; the key off, or no cluster marker, bypasses
    the cache."""
    from spark_rapids_tpu_torch import ops as TO
    from spark_rapids_tpu_torch.ops.base import ExecContext
    from spark_rapids_tpu_torch.parallel import broadcast_cache as BC
    from spark_rapids_tpu_torch.parallel.exchange import \
        BroadcastExchangeExec

    schema = (("k", dt.INT64), ("v", dt.INT64))
    src = TO.InMemorySourceExec(schema, [[HostBatch.from_pydict(
        schema, {"k": [3, 1, 2], "v": [30, 10, 20]})]], device="cpu")
    bx = BroadcastExchangeExec(src)
    gens = {1: 0}

    def ctx_for(wid, **conf):
        ctx = ExecContext(C.TpuConf(conf))
        ctx.cache["cluster"] = CO.ClusterExecInfo(
            str(tmp_path / "spool"), wid, {}, bcast_tags={id(bx): 7},
            bcast_deps={7: [1]}, plan_fp="abc",
            gen_source=lambda: dict(gens))
        return ctx

    T.reset_counters()
    a = ctx_for("wA")
    want = device_to_host(bx.collect_single_device(a)).to_pylist()
    # A probe that found nothing, then the local build: two misses.
    assert T.counters().get("broadcastCachePublishes") == 1
    assert T.counters().get("broadcastCacheMisses") == 2
    b = ctx_for("wB")
    hit = BC.maybe_fetch(b, bx)
    assert hit is not None
    assert device_to_host(hit[1]).to_pylist() == want
    hit[0].release()
    assert T.counters().get("broadcastCacheHits") == 1
    gens[1] = 1                         # the upstream stage recomputed
    assert BC.maybe_fetch(ctx_for("wC"), bx) is None
    assert T.counters().get("broadcastCacheMisses") == 3
    off = ctx_for("wD", **{C.BROADCAST_CACHE_ENABLED.key: False})
    assert BC.maybe_fetch(off, bx) is None
    assert BC.maybe_fetch(ExecContext(), bx) is None
    assert T.counters().get("broadcastCacheMisses") == 3
    for ctx in (a, b, off):
        ctx.close()
