"""A cluster worker process: executes assigned stages of a query's DAG
(port of the JAX package's ``parallel/cluster/worker.py``).

    python -m spark_rapids_tpu_torch.parallel.cluster.worker \
        --coordinator 127.0.0.1:40123 --worker-id w0 [--device cpu]

It runs on the CUDA card unless given ``--device cpu``; a plan made for
another kind of device fails its stage (``CFAIL``) instead of running
here. ``run_worker`` is the same loop as a ``multiprocessing`` target
(start it with ``spawn``: a CUDA process must not fork).

Lifecycle: register with the coordinator's rendezvous (``CREG``, retried
until a deadline), heartbeat from a daemon thread (``CBEAT``), pull stage
tasks in the main loop (``CPOLL``). For each task the worker unpickles
the query's physical plan ONCE a query (``stage_plan``'s deterministic
DFS numbering makes its stage ids the driver's), installs a
:class:`ClusterExecInfo` marking the assigned stage LOCAL (a write
session) and every other dispatchable stage REMOTE (fetch-only adoption
of the committed spool), and drives the boundary exchange's
``stage_prematerialize``: the code path of the single-process stage
pass, pointed at the shared spool. Success reports ``CDONE`` with the
output's observed bytes (the coordinator's locality scores) and the
per-node stats; failure reports ``CFAIL``, tagged with the lost dep
stage when the error carries a ``fault_owner``, so the coordinator
recomputes the dep instead of retrying the consumer blindly.

Chaos: ``SRT_FAULTS=workerdeath@cluster.stage:1`` in ONE worker's
environment SIGKILLs it at the injection site just before it executes a
stage; the coordinator's heartbeat monitor declares the death and
requeues the task on a survivor (exactly one stage recompute).
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":          # a bare script: the repo on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))))

import argparse
import base64
import hashlib
import json
import logging
import pickle
import signal
import threading
import time
from typing import Dict, Optional, Tuple

import torch

_LOG = logging.getLogger("spark_rapids_tpu_torch.cluster.worker")


class _QueryState:
    """One query's cached plan + execution context on this worker:
    unpickled once, reused across every task of the query."""

    __slots__ = ("root", "conf", "graph", "info", "ctx", "gens")

    def __init__(self, root, conf, graph, info, ctx):
        self.root = root
        self.conf = conf
        self.graph = graph
        self.info = info
        self.ctx = ctx
        self.gens: Dict[int, int] = {}     # sid -> last generation seen


class Worker:
    def __init__(self, coordinator: Tuple[str, int], worker_id: str,
                 poll_ms: int = 25, heartbeat_ms: int = 2000,
                 max_idle_s: float = 0.0, reconnect_s: float = 120.0,
                 device=None):
        from spark_rapids_tpu_torch import resolve_device
        self.addr = coordinator
        # Where this worker runs its stages (None: the card, raising
        # without one). A plan made for another kind of device fails
        # its task rather than run here.
        self.device = resolve_device(device)
        self.wid = worker_id
        self.poll_ms = max(int(poll_ms), 1)
        self.heartbeat_ms = max(int(heartbeat_ms), 1)
        self.max_idle_s = float(max_idle_s)
        self.reconnect_s = float(reconnect_s)
        self.queries: Dict[int, _QueryState] = {}
        self._stop = threading.Event()
        self.tasks_done = 0
        # Incarnation token: one value per PROCESS, sent with every
        # CREG. The supervisor restarts a dead worker under the SAME
        # wid (HRW placement re-converges), and on a loaded host the
        # replacement can register BEFORE the heartbeat sweep notices
        # the silence — without the token the coordinator would read
        # that CREG as a beat from the old incarnation and its RUNNING
        # stage would stay assigned forever. A token mismatch is proof
        # of death; a reconnect after a coordinator outage reuses the
        # same token and stays a no-op.
        self.token = "%x.%x" % (os.getpid(),
                                int(time.time() * 1000.0) & 0xFFFFFF)
        # Self-retirement handshake: --max-idle-s
        # expiry sends CDRAIN and waits for the coordinator's CRETIRE
        # instead of silently exiting, so membership drops NOW rather
        # than after heartbeatTimeoutMs of ghost liveness.
        self._retiring = False
        self._retire_deadline = 0.0

    # -- control plane --------------------------------------------------------
    def _call(self, line: str, timeout_s: float = 10.0) -> str:
        from spark_rapids_tpu_torch.parallel.transport import rendezvous as RV
        if not line.endswith("\n"):
            line += "\n"
        return RV._roundtrip(self.addr, line, timeout_s=timeout_s,
                             retries=3, backoff_ms=50)

    def _call_persistent(self, line: str, deadline_s: float) -> bool:
        """Deliver a must-arrive verb (CDONE/CFAIL) across a
        coordinator outage: keep retrying with capped backoff until the
        deadline. A restarted coordinator replays its journal, restores
        the task RUNNING under this worker's generation, and the
        retried report lands exactly as if nothing happened."""
        from spark_rapids_tpu_torch.parallel.transport.rendezvous import \
            RendezvousUnavailableError
        end = time.monotonic() + deadline_s
        delay = 0.1
        while True:
            try:
                self._call(line, timeout_s=5.0)
                return True
            except RendezvousUnavailableError:
                if self._stop.is_set() or time.monotonic() >= end:
                    _LOG.warning("worker %s: gave up delivering %r "
                                 "after %.0fs", self.wid,
                                 line.split()[0], deadline_s)
                    return False
                time.sleep(delay)
                delay = min(delay * 2, 2.0)

    def _reconnect(self) -> bool:
        """Ride out a coordinator outage (THE fix for the old
        die-on-refused behavior): back off with a 2s cap inside the
        reconnect window, then re-register. Loaded queries, their
        warm execution contexts, spooled stage state, and kernel
        caches all survive — a coordinator restart costs this worker
        one CREG, not its whole state."""
        from spark_rapids_tpu_torch import monitoring
        from spark_rapids_tpu_torch.parallel.transport.rendezvous import \
            RendezvousUnavailableError
        end = time.monotonic() + self.reconnect_s
        delay = 0.1
        _LOG.warning("worker %s: coordinator unreachable — "
                     "reconnecting for up to %.0fs", self.wid,
                     self.reconnect_s)
        while not self._stop.is_set() and time.monotonic() < end:
            time.sleep(delay)
            delay = min(delay * 2, 2.0)
            try:
                self._call(f"CREG {self.wid} {self.token}",
                           timeout_s=5.0)
            except RendezvousUnavailableError:
                continue
            monitoring.instant("worker-reconnect", "recovery",
                               args={"worker": self.wid})
            _LOG.warning("worker %s: re-registered with coordinator "
                         "(queries kept warm: %s)", self.wid,
                         sorted(self.queries) or "none")
            return True
        return False

    def register(self, deadline_s: float = 30.0) -> None:
        """CREG with retry-until-deadline: the launcher may start
        workers before the coordinator binds (elastic join is the same
        code path — a worker registering mid-run just starts winning
        polls)."""
        from spark_rapids_tpu_torch.parallel.transport.rendezvous import \
            RendezvousUnavailableError
        end = time.monotonic() + deadline_s
        while True:
            try:
                self._call(f"CREG {self.wid} {self.token}")
                return
            except RendezvousUnavailableError:
                if time.monotonic() >= end:
                    raise
                time.sleep(0.1)

    def _heartbeat_loop(self) -> None:
        from spark_rapids_tpu_torch.parallel.transport.rendezvous import \
            RendezvousUnavailableError
        interval = self.heartbeat_ms / 3000.0
        while not self._stop.wait(interval):
            line = f"CBEAT {self.wid}"
            try:
                # Memory-pressure piggyback: this worker's catalog
                # watermark score (the max over its loaded queries: one
                # hot query is enough to shed placement here) rides the
                # heartbeat while telemetry is on.
                from spark_rapids_tpu_torch.monitoring import telemetry
                if telemetry.enabled():
                    from spark_rapids_tpu_torch.memory import stores
                    score = 0.0
                    for st in list(self.queries.values()):
                        cat = getattr(st.ctx, "_catalog", None)
                        if cat is not None:
                            score = max(score,
                                        stores.pressure_score(cat))
                    telemetry.set_gauge("srt_pressure_score", score)
                    blob = base64.b64encode(json.dumps(
                        {"series": {"srt_pressure_score|": score}}
                    ).encode()).decode()
                    line = f"CBEAT {self.wid} {blob}"
            except Exception:          # a beat must never die on stats
                pass
            try:
                self._call(line, timeout_s=5.0)
            except RendezvousUnavailableError:
                # The main loop owns the exit decision; a missed beat
                # on a live coordinator merely looks slow.
                pass

    # -- task execution -------------------------------------------------------
    def _load_query(self, qid: int, pkl_path: str) -> _QueryState:
        st = self.queries.get(qid)
        if st is not None:
            return st
        from spark_rapids_tpu_torch import config as C
        from spark_rapids_tpu_torch import faults, monitoring
        from spark_rapids_tpu_torch.ops.base import ExecContext
        from spark_rapids_tpu_torch.parallel.cluster.coordinator import (
            ClusterCoordinator, ClusterExecInfo, cluster_store_kind,
            stage_plan)
        with open(pkl_path, "rb") as f:
            blob = f.read()
        root, raw, binds = pickle.loads(blob)
        want = root.plan_device()
        want = self.device if want is None else torch.device(want)
        if want.type != self.device.type:
            raise RuntimeError(
                f"worker {self.wid} runs on {self.device}, but query "
                f"{qid}'s plan reads onto {want}")
        conf = C.TpuConf(raw)
        # The process-global settings a collect adopts: the trace, the
        # telemetry, the fault schedule, the wire codec, the kernel
        # gates.
        from spark_rapids_tpu_torch.columnar import wire
        from spark_rapids_tpu_torch.ops import native
        monitoring.maybe_configure(conf)
        monitoring.telemetry.maybe_configure(conf)
        faults.maybe_configure(conf)
        wire.maybe_configure(conf)
        native.maybe_configure(conf)
        graph, dispatchable, deps = stage_plan(root)
        tags = {id(graph.stages[sid].boundary): (sid, f"s{sid}")
                for sid in dispatchable}
        # Store coordinates ride IN the shipped conf (submit pins
        # them), so every worker publishes/fetches through the same
        # endpoint + key prefix the driver resolved. The spool dir
        # fallback: remote submissions park the plan under <dir>/plans,
        # so derive the query spool from the cluster dir, not the
        # pickle's parent.
        kind = cluster_store_kind(conf)
        endpoint = prefix = ""
        if kind == "objectstore":
            endpoint = str(conf.get(
                C.SHUFFLE_TRANSPORT_OBJECTSTORE_ENDPOINT) or "")
            prefix = str(conf.get(
                C.SHUFFLE_TRANSPORT_OBJECTSTORE_PREFIX) or "")
        pkl_dir = os.path.dirname(pkl_path)
        if os.path.basename(pkl_dir) == "plans":
            spool = os.path.join(os.path.dirname(pkl_dir), f"q{qid}")
        else:
            spool = pkl_dir
        bcast_tags, bcast_deps = \
            ClusterCoordinator._broadcast_maps(graph, deps)
        st_holder: list = []
        info = ClusterExecInfo(
            spool, self.wid, tags, local_sid=None, store_kind=kind,
            store_endpoint=endpoint, store_prefix=prefix,
            bcast_tags=bcast_tags, bcast_deps=bcast_deps,
            plan_fp=hashlib.sha256(blob).hexdigest()[:12],
            gen_source=lambda: dict(st_holder[0].gens)
            if st_holder else {})
        ctx = ExecContext(conf)
        ctx.cache["engine"] = "device"
        ctx.cache["cluster"] = info
        if binds is not None:
            # Parameterized plan-cache template: the driver's bound
            # literals ride along in the plan blob so bind slots
            # resolve to THIS collect's values in every process.
            ctx.cache["plan_binds"] = tuple(binds[0])
            ctx.cache["plan_bind_dtypes"] = tuple(binds[1])
        st = _QueryState(root, conf, graph, info, ctx)
        st_holder.append(st)
        self.queries[qid] = st
        _LOG.info("worker %s: loaded query %d (%d dispatchable stages)",
                  self.wid, qid, len(dispatchable))
        return st

    def _close_query(self, qid: int) -> None:
        st = self.queries.pop(qid, None)
        if st is not None:
            try:
                st.ctx.close()
            except Exception:                  # pragma: no cover - teardown
                _LOG.exception("worker %s: context close of query %d",
                               self.wid, qid)

    def _sync_gens(self, st: _QueryState, sid: int, gen: int,
                   depgens: str) -> None:
        """Invalidate locally-cached stage state whose generation moved
        on: a requeued/recomputed stage's old spool is gone, so this
        worker's cached sessions and bucket caches for it are stale."""
        want = {sid: gen}
        if depgens and depgens != "-":
            for ent in depgens.split(","):
                d, _, g = ent.partition(":")
                want[int(d)] = int(g)
        for s, g in want.items():
            seen = st.gens.get(s)
            if seen is not None and seen != g:
                boundary = st.graph.stages[s].boundary
                if boundary is not None:
                    boundary.stage_invalidate(st.ctx)
                _LOG.info("worker %s: stage s%d moved gen %d -> %d; "
                          "dropped cached state", self.wid, s, seen, g)
            st.gens[s] = g

    def execute(self, qid: int, sid: int, gen: int, depgens: str,
                pkl_path: str) -> None:
        from spark_rapids_tpu_torch import faults, monitoring
        from spark_rapids_tpu_torch.memory import oom
        from spark_rapids_tpu_torch.ops.base import query_metrics_entry
        st = None
        try:
            st = self._load_query(qid, pkl_path)
            self._sync_gens(st, sid, gen, depgens)
            st.info.set_local(sid)
            # The workerdeath chaos site: a SIGKILL here leaves the
            # task RUNNING at the coordinator until the heartbeat
            # timeout declares this worker dead — real process death,
            # not a simulated exception.
            if faults.check_fault("cluster.stage",
                                  ("workerdeath",)) is not None:
                _LOG.warning("worker %s: injected workerdeath — "
                             "SIGKILL", self.wid)
                logging.shutdown()
                os.kill(os.getpid(), signal.SIGKILL)
            boundary = st.graph.stages[sid].boundary
            # The stage's catalog is the OOM ladder's active catalog, as
            # in a collect.
            oom.set_active_catalog(st.ctx.catalog,
                                   query_metrics_entry(st.ctx, "Recovery"))
            try:
                with monitoring.span("cluster-stage", "cluster",
                                     args={"query": qid, "stage": sid,
                                           "worker": self.wid}):
                    boundary.stage_prematerialize(st.ctx)
            finally:
                oom.set_active_catalog(None)
            sess = st.ctx.cache.get(boundary._cache_key(True))
            nbytes = sess.observed_bytes() if sess is not None else 0
        except Exception as e:
            lost = None if st is None else self._lost_dep(st, sid, e)
            msg = base64.b64encode(
                f"{type(e).__name__}: {e}"[:512].encode()).decode()
            _LOG.warning("worker %s: stage s%d of query %d failed "
                         "(lost dep: %s): %s", self.wid, sid, qid,
                         lost, e, exc_info=True)
            self._call_persistent(
                f"CFAIL {self.wid} {qid} {sid} {gen} "
                f"{'-' if lost is None else lost} {msg}",
                deadline_s=self.reconnect_s)
            return
        finally:
            if st is not None:
                st.info.set_local(None)
        self.tasks_done += 1
        extra = self._stage_report(st)
        self._call_persistent(
            f"CDONE {self.wid} {qid} {sid} {gen} {nbytes}"
            + (f" {extra}" if extra else ""),
            deadline_s=self.reconnect_s)

    def _stage_report(self, st: _QueryState) -> Optional[str]:
        """b64(JSON) CDONE piggyback: this query's per-node observed
        metrics in the shared DFS-preorder indexing (the driver merges
        them into its own ctx so a cluster ``explain_analyze`` shows
        worker-stage rows/bytes), plus — when the flight recorder is on
        — this worker's trace ring and thread names for the driver's
        merged one-file Perfetto export. Cumulative per query: each
        CDONE supersedes the last, so the coordinator keeps only the
        latest report per worker."""
        try:
            from spark_rapids_tpu_torch import monitoring
            from spark_rapids_tpu_torch.monitoring import history
            payload: dict = {}
            nodes = [n for n in history.node_stats(st.root, st.ctx)
                     if n["rows"] is not None or n["bytes"] is not None
                     or n["batches"] or n["wall_ms"]]
            if nodes:
                payload["nodes"] = nodes
            if monitoring.enabled():
                payload["events"] = [list(e) for e in monitoring.events()]
                payload["threads"] = {
                    str(k): v
                    for k, v in monitoring.thread_names().items()}
                payload["tag"] = (monitoring.process_tag()
                                  or f"worker {self.wid}")
            if not payload:
                return None
            return base64.b64encode(
                json.dumps(payload, default=str).encode()).decode()
        except Exception:              # stats must never fail the task
            _LOG.warning("worker %s: stage report build failed",
                         self.wid, exc_info=True)
            return None

    def _lost_dep(self, st: _QueryState, sid: int,
                  e: BaseException) -> Optional[int]:
        """Map an owner-tagged failure (ShardLostError, persistent CRC
        loss) to the DEP stage whose spool is gone — the coordinator
        recomputes it before requeueing this task. The failing stage's
        OWN id is not a lost dep (its output was never committed)."""
        owner = getattr(e, "fault_owner", None)
        if owner is None:
            return None
        lost = st.graph.by_exchange.get(owner)
        if lost is None or lost == sid:
            return None
        # A lost dep's local fetch state is stale the moment the
        # coordinator recomputes it; drop it now so the retried task
        # re-adopts the rewritten manifest.
        boundary = st.graph.stages[lost].boundary
        if boundary is not None:
            boundary.stage_invalidate(st.ctx)
        st.gens.pop(lost, None)
        return lost

    # -- main loop ------------------------------------------------------------
    def run(self) -> int:
        from spark_rapids_tpu_torch import monitoring
        from spark_rapids_tpu_torch.parallel.transport.rendezvous import \
            RendezvousUnavailableError
        # Trace exports from this process name their tracks after the
        # worker, so side-by-side per-process traces stay attributable.
        monitoring.set_process_tag(f"worker {self.wid}")
        self.register()
        hb = threading.Thread(target=self._heartbeat_loop,
                              name=f"srt-worker-hb-{self.wid}",
                              daemon=True)
        hb.start()
        _LOG.info("worker %s: registered with %s:%d", self.wid,
                  self.addr[0], self.addr[1])
        idle_since = time.monotonic()
        # Hot-poll backoff: right after finishing a stage the next
        # dispatch is usually imminent (the downstream stage just
        # unblocked), so poll tightly; every consecutive empty poll
        # doubles the sleep up to the configured interval, so workers
        # sitting out a long foreign stage don't burn the core the
        # busy worker needs. Fully idle workers (no loaded query) stay
        # at the configured interval.
        hot_s = min(self.poll_ms, 2) / 1000.0
        poll_s = self.poll_ms / 1000.0
        delay_s = poll_s
        try:
            while not self._stop.is_set():
                known = ",".join(str(q) for q in self.queries) or "-"
                try:
                    resp = self._call(f"CPOLL {self.wid} {known}")
                except RendezvousUnavailableError:
                    if self._reconnect():
                        idle_since = time.monotonic()
                        continue
                    _LOG.warning("worker %s: coordinator unreachable "
                                 "past the %.0fs reconnect window — "
                                 "exiting", self.wid, self.reconnect_s)
                    return 1
                parts = resp.split()
                if parts and parts[0] == "CRETIRE":
                    # Clean retirement: the coordinator already dropped
                    # this worker from membership (no heartbeat-timeout
                    # wait, no death counter) — exit for real.
                    monitoring.instant("worker-retire-ack", "cluster",
                                       args={"worker": self.wid})
                    _LOG.info("worker %s: retired by coordinator — "
                              "exiting cleanly", self.wid)
                    return 0
                if parts and parts[0] == "CTASK":
                    qid, sid, gen = (int(parts[1]), int(parts[2]),
                                     int(parts[3]))
                    pkl_path = base64.b64decode(parts[5]).decode()
                    self.execute(qid, sid, gen, parts[4], pkl_path)
                    idle_since = time.monotonic()
                    delay_s = hot_s
                    continue
                if parts and parts[0] == "CIDLE" and parts[1] != "-":
                    for q in parts[1].split(","):
                        if q:
                            self._close_query(int(q))
                if self.max_idle_s and not self._retiring and \
                        time.monotonic() - idle_since > self.max_idle_s:
                    # Deregister-then-exit (NOT a silent return): the
                    # CDRAIN/CRETIRE handshake retires this worker at
                    # the coordinator immediately; silently exiting
                    # left a ghost member other dispatches waited
                    # heartbeatTimeoutMs to bury.
                    self._retiring = True
                    self._retire_deadline = time.monotonic() + 10.0
                    try:
                        self._call(f"CDRAIN {self.wid}", timeout_s=5.0)
                    except RendezvousUnavailableError:
                        _LOG.info("worker %s: idle %.0fs and the "
                                  "coordinator is gone — exiting",
                                  self.wid, self.max_idle_s)
                        return 0
                    _LOG.info("worker %s: idle %.0fs — draining for "
                              "clean retirement", self.wid,
                              self.max_idle_s)
                    delay_s = hot_s       # the CRETIRE is imminent
                    continue
                if self._retiring and \
                        time.monotonic() > self._retire_deadline:
                    # The CRETIRE never came (coordinator restarted
                    # without its journal?): fall back to the old
                    # silent exit rather than polling forever.
                    _LOG.warning("worker %s: no CRETIRE within 10s of "
                                 "CDRAIN — exiting anyway", self.wid)
                    return 0
                if self.queries:
                    time.sleep(delay_s)
                    delay_s = min(delay_s * 2, poll_s)
                else:
                    delay_s = poll_s
                    time.sleep(poll_s)
            return 0
        finally:
            self._stop.set()
            for qid in list(self.queries):
                self._close_query(qid)

    def stop(self) -> None:
        self._stop.set()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="spark-rapids-tpu (PyTorch + CUDA) cluster worker")
    ap.add_argument("--coordinator", required=True,
                    help="host:port of the driver's cluster rendezvous")
    ap.add_argument("--worker-id", required=True)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain-PyTorch path; default: the "
                         "CUDA card (no card: the worker exits with an "
                         "error)")
    ap.add_argument("--poll-ms", type=int, default=25)
    ap.add_argument("--heartbeat-ms", type=int, default=2000)
    ap.add_argument("--max-idle-s", type=float, default=0.0,
                    help="exit after this long without a task (0=never)")
    ap.add_argument("--reconnect-s", type=float, default=120.0,
                    help="how long to ride out a coordinator outage "
                         "before exiting")
    ap.add_argument("--log-level", default="INFO")
    a = ap.parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, a.log_level.upper(), logging.INFO),
        format=f"%(asctime)s {a.worker_id} %(levelname)s %(message)s")
    host, _, port = a.coordinator.rpartition(":")
    w = Worker((host or "127.0.0.1", int(port)), a.worker_id,
               poll_ms=a.poll_ms, heartbeat_ms=a.heartbeat_ms,
               max_idle_s=a.max_idle_s, reconnect_s=a.reconnect_s,
               device=a.device)
    signal.signal(signal.SIGTERM, lambda *_: w.stop())
    return w.run()


def run_worker(addr: str, worker_id: str, device=None, env=None,
               **kw) -> int:
    """A worker as a ``multiprocessing`` (``spawn``) target: ``env`` is
    set in this process first (an armed ``SRT_FAULTS`` for one worker),
    then the worker runs until retired or stopped."""
    if env:
        os.environ.update(env)
        if "SRT_FAULTS" in env:
            # The schedule the env arms at import, armed now.
            from spark_rapids_tpu_torch import faults
            faults.configure(env["SRT_FAULTS"],
                             int(env.get("SRT_FAULTS_SEED", "0")))
    host, _, port = addr.rpartition(":")
    return Worker((host or "127.0.0.1", int(port)), worker_id,
                  device=device, **kw).run()


if __name__ == "__main__":
    sys.exit(main())
