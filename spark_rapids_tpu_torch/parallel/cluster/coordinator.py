"""The driver-side cluster coordinator: stage-task scheduling and
membership (port of the JAX package's
``parallel/cluster/coordinator.py``).

One :class:`ClusterCoordinator` a driver process owns the control plane,
a :class:`ClusterServer` that extends the rendezvous wire protocol
(``parallel/transport/rendezvous.py``) with stage-task verbs, and the
shared spool directory. Each eligible query submits a :class:`QueryRun`
whose physical plan is pickled to the spool once; workers
(``worker.py``) unpickle it, rebuild the same stage DAG (its DFS
numbering is deterministic) and execute their assigned stages,
publishing each stage output as an exclusive-manifest hostfile exchange
under ``<spool>/q<qid>/s<sid>/`` (or under the query's objectstore key
prefix when the session runs on that transport).

Control-plane verbs (one UTF-8 line a connection, like the rendezvous
grammar)::

    CREG <wid> [<token>]                         -> OK
    CBEAT <wid> [<b64 json>]                     -> OK
    CPOLL <wid> <known-qids|->                   -> CTASK <qid> <sid> <gen>
                                                      <depgens|-> <b64 path>
                                                  | CIDLE <stale-qids|->
                                                  | CRETIRE
    CDONE <wid> <qid> <sid> <gen> <bytes> [<b64>] -> OK
    CFAIL <wid> <qid> <sid> <gen> <lost|-> <b64> -> OK
    CSTATS                                       -> OK <b64 json>
    CDRAIN <wid>                                 -> OK
    CDEMO <wid> <0|1>                            -> OK

``CDRAIN`` marks a worker draining: no new stage tasks, its in-flight
stages commit, and its next idle ``CPOLL`` answers ``CRETIRE`` so it
exits cleanly. ``CDEMO`` toggles a straggler demotion: a demoted worker
drops below the steal-delay placement preference, as a worker under
memory pressure does (``scheduler.pressure.*``, scored off ``CBEAT``).
The remote driver's verbs (``CSUB``, ``CWAIT``, ``CREC``, ``CRESET``,
``CFIN``, ``CREPT``) belong to the standalone coordinator and are not
here.

Scheduling is pull-based: an idle worker polls and the coordinator
picks, among the READY tasks (every dep committed, the
``cluster.minWorkers`` gate open), the one this worker holds the most
input bytes for; ties go to the stage's rendezvous-hash owner
(``_hrw_owner``, md5 of ``wid|sid``), then to the smallest stage id, so
placement is deterministic. A ready task is reserved for its preferred
worker for ``cluster.stealDelayMs``. A worker registering mid-run
simply starts winning polls.

Failures:

- a worker silent past ``heartbeatTimeoutMs`` is declared dead; its
  RUNNING task's partial spool is cleared, its generation bumps (a
  zombie's late commit of the old generation is ignored) and the task
  requeues onto a survivor: ONE stage recompute, counted as a lineage
  recompute (``stageRecomputes``), never a dead query;
- a worker that loses a DEP shard mid-fetch reports the owning stage
  (``CFAIL ... <lost-sid>``): the dep recomputes, the task requeues
  behind it;
- the driver's own loss after the barrier flows through the planner's
  stage-recompute rung, which calls :meth:`QueryRun.recompute`.

The journal (``journal.py``, ``cluster.journal.enabled``) records every
transition; a coordinator made over the same ``cluster.dir`` replays it.
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import os
import pickle
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.parallel.scheduler import QueryRejectedError
from spark_rapids_tpu_torch.parallel.transport.rendezvous import \
    RendezvousServer

_LOG = logging.getLogger("spark_rapids_tpu_torch.cluster")

_PENDING, _RUNNING, _DONE = "pending", "running", "done"

# How long a retired wid's stray heartbeats are ignored before the id
# may be reused by a fresh CREG (the retiring worker's daemon beat
# thread may land one more CBEAT after its CRETIRE).
_RETIRE_GRACE_S = 10.0


class ClusterDispatchError(QueryRejectedError):
    """A query's stage-task set could not be completed (dispatch
    timeout, task retry budget exhausted, or a worker-reported
    non-recoverable stage failure).

    Subclasses :class:`QueryRejectedError` so the dispatch-timeout
    variant participates in the scheduler's backpressure contract: the
    coordinator barrier raises it with ``kind='dispatch-timeout'`` and
    a ``retry_after_ms`` hint, so after the planner's transient ladder
    is exhausted ``collect_with_retry`` backs off and resubmits instead
    of re-raising. Every other variant (retry budget exhausted, worker
    stage error) ships no hint — retrying as-is cannot help. The
    message is NOT rewritten into the ``REJECTED:`` shape: dispatch
    timeouts keep their ``UNAVAILABLE:`` marker so
    ``is_transient_error`` still routes them into the recovery ladder
    first."""

    def __init__(self, message: str, kind: str = "dispatch",
                 queue_depth: Optional[int] = None,
                 retry_after_ms: Optional[float] = None):
        RuntimeError.__init__(self, message)
        self.reason = message
        self.kind = kind
        self.queue_depth = queue_depth
        self.retry_after_ms = retry_after_ms


def dispatch_timeout_error(message: str,
                           queue_depth: Optional[int] = None,
                           retry_after_ms: Optional[float] = None
                           ) -> ClusterDispatchError:
    """The dispatch-timeout rejection: built with
    ``kind='dispatch-timeout'`` and a ``retry_after_ms`` hint — never
    hintless — and recorded in the same structured shed-load telemetry
    as every scheduler rejection, so ``srt_queries_rejected`` and the
    retry-hint gauges cover coordinator-barrier sheds too."""
    hint = float(retry_after_ms) if retry_after_ms and \
        retry_after_ms > 0 else 250.0
    try:
        from spark_rapids_tpu_torch.parallel.scheduler import _telemetry_reject
        _telemetry_reject("dispatch-timeout", int(queue_depth or 0),
                          hint)
    except Exception:                  # telemetry must never mask the
        pass                           # rejection itself
    return ClusterDispatchError(message, kind="dispatch-timeout",
                                queue_depth=queue_depth,
                                retry_after_ms=hint)


def cluster_enabled(conf) -> bool:
    return bool(conf.get(C.CLUSTER_ENABLED))


def stage_plan(root, graph=None) -> Tuple[object, Set[int],
                                          Dict[int, Set[int]]]:
    """(stage graph, dispatchable stage ids, dispatchable-dep map).

    Dispatchable = stages whose boundary is a shuffle exchange: their
    durable output lives in the transport spool, so ANY process can
    produce or consume it. Broadcast stages are NOT dispatchable — a
    broadcast single materializes into the consuming process's catalog
    (Spark broadcast semantics: every executor holds the value), so
    each process computes broadcast stages locally; the dep map
    therefore flows THROUGH them transitively to the shuffle stages
    they consume."""
    from spark_rapids_tpu_torch.parallel import stages as S
    from spark_rapids_tpu_torch.parallel.exchange import ShuffleExchangeExec
    g = graph if graph is not None else S.build_stage_graph(root)
    dispatchable = {sid for sid, st in g.stages.items()
                    if isinstance(st.boundary, ShuffleExchangeExec)}
    deps: Dict[int, Set[int]] = {}

    def ddeps(sid: int) -> Set[int]:
        got = deps.get(sid)
        if got is not None:
            return got
        out: Set[int] = set()
        for p in g.stages[sid].parents:
            if p in dispatchable:
                out.add(p)
            out |= ddeps(p)
        deps[sid] = out
        return out

    for sid in g.stages:
        ddeps(sid)
    return g, dispatchable, deps


def _hrw_owner(wids: List[str], sid: int) -> Optional[str]:
    """Highest-random-weight (rendezvous hash) owner of stage ``sid``
    among worker ids ``wids``: deterministic for a given worker set
    (md5, not the salted builtin hash), and removing one worker only
    reassigns that worker's stages."""
    if not wids:
        return None
    return max(wids, key=lambda w: hashlib.md5(
        f"{w}|{sid}".encode()).digest())


def cluster_store_kind(conf) -> str:
    """Which transport cluster stage outputs publish through: the
    objectstore when the session runs on it, the hostfile spool for
    everything else (inprocess/hostfile — the shared directory is the
    DCN stand-in either way)."""
    from spark_rapids_tpu_torch.parallel import transport as T
    return "objectstore" if T.transport_name(conf) == "objectstore" \
        else "hostfile"


class ClusterExecInfo:
    """Per-process cluster execution marker, parked at
    ``ctx.cache["cluster"]``: maps each dispatchable boundary exchange
    (by its in-process identity) to its cross-process stage tag and
    builds the exclusive-manifest transport sessions the exchange layer
    opens instead of its default transport — hostfile on the shared
    spool, or the objectstore under the query's key prefix when the
    session runs on that transport. ``local_sid`` is the stage THIS
    process is currently producing (None on the driver): its boundary
    gets a write session; every other tagged exchange gets a fetch-only
    session that adopts the committed manifest.

    Broadcast artifact cache: ``bcast_tags``
    maps each broadcast-boundary exchange to its stage id and
    ``broadcast_tag`` derives its cluster-wide cache key — plan
    fingerprint + the GENERATIONS of its dispatchable upstream stages,
    so a recomputed input invalidates the key and a stale cached build
    can never be adopted."""

    def __init__(self, spool_dir: str, worker_id: str,
                 tags: Dict[int, Tuple[int, str]],
                 local_sid: Optional[int] = None,
                 store_kind: str = "hostfile",
                 store_endpoint: str = "", store_prefix: str = "",
                 bcast_tags: Optional[Dict[int, int]] = None,
                 bcast_deps: Optional[Dict[int, List[int]]] = None,
                 plan_fp: str = "", gen_source=None):
        self.spool_dir = spool_dir
        self.worker_id = worker_id
        self.tags = tags                  # id(exchange) -> (sid, tag)
        self.local_sid = local_sid
        self.store_kind = store_kind
        self.store_endpoint = store_endpoint
        self.store_prefix = store_prefix
        self.bcast_tags = bcast_tags or {}    # id(exchange) -> sid
        self.bcast_deps = bcast_deps or {}    # sid -> dispatchable deps
        self.plan_fp = plan_fp
        self.gen_source = gen_source          # callable -> {sid: gen}

    def set_local(self, sid: Optional[int]) -> None:
        self.local_sid = sid

    def sid_of(self, exchange) -> Optional[int]:
        ent = self.tags.get(id(exchange))
        return None if ent is None else ent[0]

    def is_remote(self, exchange) -> bool:
        ent = self.tags.get(id(exchange))
        return ent is not None and ent[0] != self.local_sid

    def open_session(self, ctx, tag: str, num_partitions: int,
                     owner: Optional[int] = None,
                     fetch_timeout_ms: Optional[int] = None, device=None):
        """One exclusive-manifest cluster session on the query's store
        (hostfile spool or objectstore prefix); keep_on_close because
        the COORDINATOR owns query-end store cleanup, not any one
        context's teardown. Fetched shards decode onto ``device`` (the
        plan's; None: the card)."""
        from spark_rapids_tpu_torch.parallel import transport as T
        raw = dict(ctx.conf.raw)
        if self.store_kind == "objectstore":
            from spark_rapids_tpu_torch.parallel.transport.objectstore import \
                ObjectStoreTransport
            raw[C.SHUFFLE_TRANSPORT_OBJECTSTORE_ENDPOINT.key] = \
                self.store_endpoint
            raw[C.SHUFFLE_TRANSPORT_OBJECTSTORE_PREFIX.key] = \
                self.store_prefix
            raw[C.SHUFFLE_TRANSPORT_OBJECTSTORE_WORKER_ID.key] = \
                self.worker_id
            raw[C.SHUFFLE_TRANSPORT_OBJECTSTORE_EXCLUSIVE_MANIFEST.key] \
                = True
            if fetch_timeout_ms is not None:
                raw[C.SHUFFLE_TRANSPORT_OBJECTSTORE_FETCH_TIMEOUT_MS
                    .key] = int(fetch_timeout_ms)
            sess = ObjectStoreTransport().open(
                C.TpuConf(raw), tag, num_partitions, owner=owner,
                catalog=ctx.catalog, metrics=T.metrics_entry(ctx),
                device=device)
        else:
            from spark_rapids_tpu_torch.parallel.transport.hostfile import \
                HostFileTransport
            raw[C.SHUFFLE_TRANSPORT_HOSTFILE_DIR.key] = self.spool_dir
            raw[C.SHUFFLE_TRANSPORT_HOSTFILE_WORKER_ID.key] = \
                self.worker_id
            raw[C.SHUFFLE_TRANSPORT_HOSTFILE_EXCLUSIVE_MANIFEST.key] = \
                True
            raw[C.SHUFFLE_TRANSPORT_HOSTFILE_RENDEZVOUS.key] = ""
            if fetch_timeout_ms is not None:
                raw[C.SHUFFLE_TRANSPORT_HOSTFILE_FETCH_TIMEOUT_MS.key] \
                    = int(fetch_timeout_ms)
            sess = HostFileTransport().open(
                C.TpuConf(raw), tag, num_partitions, owner=owner,
                catalog=ctx.catalog, metrics=T.metrics_entry(ctx),
                device=device)
        sess.keep_on_close = True
        return sess

    def session_for(self, ctx, exchange):
        """The cluster transport session for a tagged exchange, or None
        (untagged — the exchange opens its configured transport as
        before)."""
        ent = self.tags.get(id(exchange))
        if ent is None:
            return None
        sid, tag = ent
        sess = self.open_session(
            ctx, tag, exchange.partitioning.num_partitions,
            owner=id(exchange), device=exchange.plan_device())
        sess.fetch_only = sid != self.local_sid
        return sess

    def broadcast_tag(self, exchange) -> Optional[str]:
        """The broadcast artifact cache key for a broadcast-boundary
        exchange, or None (not a tagged broadcast stage / no plan
        fingerprint). Generation-keyed: a recomputed upstream shuffle
        stage changes the key, so a cached build of stale inputs is
        simply never found — the gen sum is defense-in-depth on top of
        bit-identical recomputes."""
        sid = self.bcast_tags.get(id(exchange))
        if sid is None or not self.plan_fp:
            return None
        gens: Dict[int, int] = {}
        if callable(self.gen_source):
            try:
                gens = self.gen_source() or {}
            except Exception:
                gens = {}
        gsum = sum(int(gens.get(d, 0))
                   for d in self.bcast_deps.get(sid, ()))
        return f"bc-{self.plan_fp}-s{sid}-g{gsum}"

    @staticmethod
    def adopt_manifest(sess, num_partitions: int) -> List[int]:
        """Reconstruct the map-side observations (exact per-bucket row
        counts + shard bytes) from the committed manifest, so the
        reduce side's AQE coalescing and the replanner's byte
        observations are IDENTICAL to the process that produced the
        stage — the bit-identity keystone."""
        rows = [0] * num_partitions
        for m in sess._load_manifests():
            for p_s, entries in m.get("shards", {}).items():
                p = int(p_s)
                for e in entries:
                    rows[p] += int(e.get("rows") or 0)
                    sess.record_shard_bytes(p, int(e.get("bytes") or 0))
        return rows


def merge_worker_reports(ctx, root, reports: Dict[str, dict]) -> None:
    """Fold the workers' CDONE stats blobs into the driver's view:
    per-node observed rows/bytes/wall land in ``ctx.metrics`` under
    the driver's own operator instances (matched by the shared DFS
    preorder index — both processes unpickled the same plan, so the
    walk agrees), and each worker's shipped trace ring is stashed in
    ``ctx.cache`` for the merged Perfetto export. The driver's own
    observations always win; among workers, the report that saw the
    most rows for a node wins (the producer saw the full output, a
    stage that merely fetched it saw a fetch-side partial)."""
    if not reports:
        return
    from spark_rapids_tpu_torch.ops.base import Metrics
    ops: List = []

    def walk(op):
        ops.append(op)
        for c in op.children:
            walk(c)

    walk(root)
    filled: Dict[str, float] = {}   # key -> best worker row count
    events: Dict[str, tuple] = {}
    for wid in sorted(reports):
        rep = reports[wid]
        for n in rep.get("nodes") or []:
            i = n.get("idx")
            if not isinstance(i, int) or i >= len(ops):
                continue
            op = ops[i]
            if op.name != n.get("name"):
                continue    # plan-shape mismatch: refuse to mislabel
            vals: Dict[str, float] = {}
            if n.get("rows") is not None:
                vals["numOutputRows"] = float(n["rows"])
            if n.get("bytes") is not None:
                vals["numOutputBytes"] = float(n["bytes"])
            if n.get("batches"):
                vals["numOutputBatches"] = float(n["batches"])
            if n.get("wall_ms"):
                vals["totalTime"] = float(n["wall_ms"]) * 1e6
            if not vals:
                continue
            key = f"{op.name}@{id(op):x}"
            m = ctx.metrics.get(key)
            if m is not None and key not in filled:
                continue    # the driver observed this node itself
            score = vals.get("numOutputRows",
                             vals.get("totalTime", 0.0) / 1e9)
            if key in filled and filled[key] >= score:
                continue
            filled[key] = score
            m = ctx.metrics.setdefault(key, Metrics(owner=op.name))
            with m.lock:
                m.values.clear()
                m.values.update(vals)
        if rep.get("events"):
            threads = {int(k): v for k, v in
                       (rep.get("threads") or {}).items()}
            events[wid] = (rep["events"], threads,
                           rep.get("tag") or f"worker {wid}")
    if events:
        ctx.cache["cluster_worker_events"] = events


class _StageTask:
    __slots__ = ("sid", "deps", "status", "worker", "gen", "retries",
                 "bytes", "producer", "ready_ts", "started_ts")

    def __init__(self, sid: int, deps: Set[int]):
        self.sid = sid
        self.deps = deps
        self.status = _PENDING
        self.worker: Optional[str] = None
        self.gen = 0
        self.retries = 0
        self.bytes = 0
        self.producer: Optional[str] = None
        self.ready_ts: Optional[float] = None   # first observed ready
        self.started_ts: Optional[float] = None  # last dispatch time


class _WorkerInfo:
    __slots__ = ("wid", "last_seen", "alive", "completed", "pressure",
                 "draining", "demoted", "last_beat", "beat_ms",
                 "stage_wall_ms", "incarnation")

    def __init__(self, wid: str, now: float):
        self.wid = wid
        self.last_seen = now
        self.alive = True
        self.completed = 0
        # Latest memory-pressure score off this worker's CBEAT
        # telemetry piggyback (0.0 until it reports one): the signal
        # shed-aware placement demotes loaded workers on.
        self.pressure = 0.0
        # Self-healing plane: draining workers get no new
        # stage tasks and retire on their next idle CPOLL; demoted
        # (straggler) workers drop below steal-delay preference like
        # pressure-shed ones until the supervisor promotes them back.
        self.draining = False
        self.demoted = False
        # Straggler evidence the supervisor's outlier detector pulls
        # through CSTATS: recent CBEAT inter-arrival gaps and per-stage
        # dispatch->commit walls, both in ms (bounded ring).
        self.last_beat: Optional[float] = None
        self.beat_ms: List[float] = []
        self.stage_wall_ms: List[float] = []
        # Per-PROCESS token off CREG: a re-register under the same wid
        # with a DIFFERENT token is proof the previous incarnation died
        # (supervisor restart racing the heartbeat sweep) — its RUNNING
        # stages requeue immediately instead of orphaning.
        self.incarnation: Optional[str] = None

    def sample(self, ring: List[float], value_ms: float,
               cap: int = 32) -> None:
        ring.append(round(value_ms, 3))
        if len(ring) > cap:
            del ring[:len(ring) - cap]


class QueryRun:
    """One query's dispatch state: the pickled plan, its stage tasks,
    and the driver-side wait/recovery surface the planner drives."""

    def __init__(self, co: "ClusterCoordinator", qid: int, conf,
                 tasks: Dict[int, _StageTask], driver_tags):
        self.co = co
        self.qid = qid
        self.qdir = os.path.join(co.base_dir, f"q{qid}")
        self.pkl_path = os.path.join(self.qdir, "query.pkl")
        self.tasks = tasks
        self._driver_tags = driver_tags
        self.min_workers = max(int(conf.get(C.CLUSTER_MIN_WORKERS)), 1)
        self.poll_ms = max(int(conf.get(C.CLUSTER_POLL_MS)), 1)
        self.hb_timeout_ms = max(
            int(conf.get(C.CLUSTER_HEARTBEAT_TIMEOUT_MS)), 1)
        self.dispatch_timeout_ms = max(
            int(conf.get(C.CLUSTER_DISPATCH_TIMEOUT_MS)), 1)
        self.max_retries = max(int(conf.get(C.CLUSTER_MAX_TASK_RETRIES)),
                               0)
        self.steal_delay_s = max(
            int(conf.get(C.CLUSTER_STEAL_DELAY_MS)), 0) / 1000.0
        # Memory-pressure shedding (scheduler.pressure.*): a worker at
        # or past shedScore is demoted below steal-delay preference so
        # it sheds NEW stages instead of spilling under more of them.
        self.pressure_enabled = bool(conf.get(C.PRESSURE_ENABLED))
        self.shed_score = float(conf.get(C.PRESSURE_SHED_SCORE))
        self.error: Optional[BaseException] = None
        self._ctx = None
        self._root = None       # driver's unpickled plan root (submit)
        self._trace_qid = 0
        self.finished = False
        # Stage-output store: hostfile spool (default) or objectstore
        # (kind, endpoint, key prefix) — set by submit()/replay.
        self.store_kind = "hostfile"
        self.store_endpoint = ""
        self.store_prefix = ""
        self.plan_fp = ""                 # sha256 of the plan pickle
        self._bcast_tags: Dict[int, int] = {}
        self._bcast_deps: Dict[int, List[int]] = {}
        # Counted recomputes (requeues that bumped stageRecomputes):
        # surfaced through CWAIT so a REMOTE driver can mirror them
        # into its own fault counters.
        self.recomputes = 0
        # A replayed query's plan file may not have landed before the
        # crash: replay clears this and dispatch holds until the file
        # exists (checked once in _pick_locked).
        self._pkl_ready = True
        # Latest per-worker CDONE stats blob (node stats + trace ring).
        # Each report is cumulative for this query on that worker, so
        # last-writer-wins per wid is the correct merge discipline.
        self.worker_reports: Dict[str, dict] = {}
        # QoS class rank (parallel/qos/): CPOLL offers ready stages of
        # higher-priority queries first, BEFORE byte-score locality. The
        # default class ("batch", rank 1) keeps the (rank, qid) sort
        # identical to the plain qid sort when no query sets a class.
        from spark_rapids_tpu_torch.parallel import qos as Q
        try:
            cls = Q.resolve_class(str(conf.get(C.QOS_PRIORITY_CLASS)))
        except ValueError:
            cls = Q.DEFAULT_CLASS
        self.qos_rank = Q.CLASS_RANK[cls]

    # -- driver side (planner hooks) -----------------------------------------
    def install(self, ctx) -> None:
        """Mark ``ctx`` as this query's cluster execution context: the
        exchanges of the plan resolve their cross-process tags and
        fetch-only roles through the installed ClusterExecInfo."""
        self._ctx = ctx
        self._trace_qid = ctx.cache.get("trace_query", 0)
        ctx.cache["cluster"] = ClusterExecInfo(
            self.qdir, f"drv{os.getpid()}", self._driver_tags,
            local_sid=None, store_kind=self.store_kind,
            store_endpoint=self.store_endpoint,
            store_prefix=self.store_prefix,
            bcast_tags=self._bcast_tags, bcast_deps=self._bcast_deps,
            plan_fp=self.plan_fp,
            gen_source=lambda: {sid: t.gen
                                for sid, t in self.tasks.items()})

    def _metrics(self):
        from spark_rapids_tpu_torch.ops.base import query_metrics_entry
        return query_metrics_entry(self._ctx, "Cluster")

    def run(self, ctx) -> None:
        """Dispatch-and-wait barrier: returns once every stage task of
        this query is committed to the spool (requeueing through worker
        deaths and reported shard losses on the way), so the local
        collect that follows only ever FETCHES remote stage outputs."""
        from spark_rapids_tpu_torch import faults, monitoring
        t0 = time.monotonic()
        deadline = t0 + self.dispatch_timeout_ms / 1000.0
        while True:
            faults.check_cancelled()
            with self.co._lock:
                self.co._check_workers_locked()
                err = self.error
                done = all(t.status == _DONE
                           for t in self.tasks.values())
            if err is not None:
                raise err
            if done:
                break
            if time.monotonic() > deadline:
                with self.co._lock:
                    depth = sum(1 for t in self.tasks.values()
                                if t.status != _DONE)
                    hint = self.co._dispatch_retry_hint_locked(depth)
                raise dispatch_timeout_error(
                    f"UNAVAILABLE: cluster dispatch of query {self.qid} "
                    f"incomplete after {self.dispatch_timeout_ms}ms "
                    f"({self._progress()})",
                    queue_depth=depth, retry_after_ms=hint)
            time.sleep(self.poll_ms / 1000.0)
        m = self._metrics()
        m.add("dispatchWaitMs", (time.monotonic() - t0) * 1000.0)
        with self.co._lock:
            workers = {t.producer for t in self.tasks.values()
                       if t.producer}
        with m.lock:
            m.values["workersUsed"] = max(
                m.values.get("workersUsed", 0), len(workers))
        monitoring.instant(
            "cluster-dispatch-complete", "cluster",
            args={"query": self.qid, "stages": len(self.tasks),
                  "workers": len(workers)}, qid=self._trace_qid)
        self._merge_worker_reports()

    def _merge_worker_reports(self) -> None:
        ctx, root = self._ctx, self._root
        if ctx is None or root is None:
            return
        with self.co._lock:
            reports = dict(self.worker_reports)
        merge_worker_reports(ctx, root, reports)

    def _progress(self) -> str:
        by = {}
        for t in self.tasks.values():
            by[t.status] = by.get(t.status, 0) + 1
        return ", ".join(f"{k}={v}" for k, v in sorted(by.items()))

    def recompute(self, sid: int) -> None:
        """Planner rung-1 hook: the driver lost stage ``sid``'s durable
        output post-dispatch (ShardLostError / persistent CRC failure
        on the reduce fetch). Clear the stage's spool and requeue it;
        the planner's continue re-enters :meth:`run`, which waits for
        the rewritten manifest."""
        with self.co._lock:
            t = self.tasks.get(sid)
            if t is None:
                return
            self._requeue_locked(t, "driver-observed shard loss")

    def reset(self) -> None:
        """Planner rung-3 hook (fresh-context retry): every stage task
        redispatches from a clean store."""
        with self.co._lock:
            for t in self.tasks.values():
                t.gen += 1
                t.status = _PENDING
                t.worker = None
                t.ready_ts = None
            shutil.rmtree(self.qdir, ignore_errors=True)
            os.makedirs(self.qdir, exist_ok=True)
            if getattr(self, "_blob", None) is not None:
                self.co._write_plan(self)
        if self.store_kind == "objectstore" and self.store_prefix:
            self.co._objectstore_delete(self.store_endpoint,
                                        self.store_prefix + "/")
        self.co._jlog({"t": "reset", "qid": self.qid})

    def finish(self) -> None:
        """Query end (success or failure): retire the run and remove
        the query's store state (spool tree and/or objectstore prefix)
        — the coordinator owns this cleanup, so worker/driver context
        teardowns never race each other over live shard files (their
        sessions are keep_on_close)."""
        with self.co._lock:
            self.finished = True
            self.co.queries.pop(self.qid, None)
            none_active = not self.co.queries
            wids = self.co._alive_wids_locked()
            draining = [w.wid for w in self.co.workers.values()
                        if w.alive and w.draining]
        shutil.rmtree(self.qdir, ignore_errors=True)
        if not self.pkl_path.startswith(self.qdir + os.sep):
            try:                 # a plan parked outside the
                os.remove(self.pkl_path)    # query's spool tree
            except OSError:
                pass
        if self.store_kind == "objectstore" and self.store_prefix:
            self.co._objectstore_delete(self.store_endpoint,
                                        self.store_prefix + "/")
        self.co._jlog({"t": "finish", "qid": self.qid})
        if none_active and self.co.journal is not None:
            # Compaction: with no in-flight query, only the live
            # membership (plus the replay audit trail — the evidence
            # that past restarts recovered) is worth keeping —
            # atomically shrink the journal instead of growing it
            # forever.
            replays = [r for r in self.co.journal.records()
                       if r.get("t") == "replay"]
            self.co.journal.rewrite(
                replays[-8:] +
                [{"t": "reg", "wid": w, "ts": time.time()}
                 for w in wids] +
                [{"t": "drain", "wid": w} for w in draining])

    # -- coordinator side (lock held) ----------------------------------------
    def _clear_stage_store_locked(self, sid: int) -> None:
        """Drop one stage's durable output ahead of its recompute (the
        rewritten generation must never merge with partial leftovers)."""
        shutil.rmtree(os.path.join(self.qdir, f"s{sid}"),
                      ignore_errors=True)
        if self.store_kind == "objectstore" and self.store_prefix:
            self.co._objectstore_delete(
                self.store_endpoint, f"{self.store_prefix}/s{sid}/")

    def _requeue_locked(self, t: _StageTask, why: str,
                        count_recompute: bool = True) -> None:
        from spark_rapids_tpu_torch import faults, monitoring
        t.gen += 1
        t.status = _PENDING
        t.worker = None
        t.ready_ts = None
        t.retries += 1
        self._clear_stage_store_locked(t.sid)
        if count_recompute:
            self.recomputes += 1
        self.co._jlog({"t": "requeue", "qid": self.qid, "sid": t.sid,
                       "gen": t.gen, "retries": t.retries,
                       "counted": count_recompute, "why": why})
        if t.retries > self.max_retries:
            self.error = ClusterDispatchError(
                f"stage task s{t.sid} of query {self.qid} exhausted its "
                f"{self.max_retries} requeue(s): {why}")
            return
        if count_recompute:
            faults.record("stageRecomputes")
            faults.record(f"stageRecomputes.stage{t.sid}")
            if self._ctx is not None:
                self._metrics().add("tasksRequeued", 1)
        monitoring.instant("cluster-task-requeue", "recovery",
                           args={"query": self.qid, "stage": t.sid,
                                 "why": why}, qid=self._trace_qid)
        _LOG.warning("cluster: requeueing stage s%d of query %d "
                     "(gen %d): %s", t.sid, self.qid, t.gen, why)

    def _ready_locked(self) -> List[_StageTask]:
        now = time.monotonic()
        out = []
        for t in self.tasks.values():
            if t.status == _PENDING and all(
                    self.tasks[d].status == _DONE
                    for d in t.deps if d in self.tasks):
                if t.ready_ts is None:
                    t.ready_ts = now    # starts the steal-delay clock
                out.append(t)
        return out

    def _pick_locked(self, wid: str) -> Optional[Tuple[str, _StageTask]]:
        """The stage task worker ``wid`` should run next: the ready
        task it holds the most input-shard bytes for (locality), ties
        to the task whose rendezvous-hash owner this worker is
        (stable placement), then to the smallest stage id
        (determinism). None = nothing ready or the minWorkers dispatch
        gate is closed.

        The affinity tier matters for repeated queries: score ties
        (every leaf stage — no input shards yet) would otherwise land
        on whichever worker polls first, scattering the same stage
        onto a different process each query and re-paying its
        per-process kernel traces. Highest-random-weight hashing over
        the live worker set keeps the split deterministic across
        queries AND work-conserving — a worker whose owned tasks are
        all taken still picks up anything ready.

        Delay scheduling closes the remaining race: a ready task is
        reserved for its *preferred* worker — the alive worker with
        the best (score, owned) pair — for ``stealDelayMs``. Without
        the reservation a momentarily busy worker loses its stages to
        whichever idle process polls first, so the stage→worker map
        flips between otherwise identical queries and the thief pays
        a fresh per-process kernel trace. The delay keeps stealing
        (and so work conservation) for genuinely stuck owners while
        making hot-path placement deterministic."""
        if self.error is not None or self.finished:
            return None
        if not self._pkl_ready:
            # A replayed query: hold dispatch until its plan file exists,
            # so a fast-polling worker never opens a missing file.
            if not os.path.exists(self.pkl_path):
                return None
            self._pkl_ready = True
        # Draining workers are not placement targets: they fall out of
        # the dispatch gate, the locality ranking AND rendezvous-hash
        # ownership, so their remaining work commits and they retire.
        alive = self.co._placeable_wids_locked()
        if wid not in alive or len(alive) < self.min_workers:
            return None
        ready = self._ready_locked()
        if not ready:
            return None

        def score(t: _StageTask, w: str) -> int:
            return sum(self.tasks[d].bytes for d in t.deps
                       if d in self.tasks
                       and self.tasks[d].producer == w)

        def owned(t: _StageTask, w: str) -> int:
            return 1 if _hrw_owner(alive, t.sid) == w else 0

        def unpressured(w: str) -> int:
            """Shed-aware demotion tier (scheduler.pressure.*): an
            unpressured worker outranks a pressured one for BOTH the
            steal-delay reservation and the pick itself, so a loaded
            worker sheds new stages to its peers instead of spilling
            under them. All-pressured (or the gate off) collapses the
            tier to a constant — placement is exactly the old
            (locality, affinity) order. Supervisor straggler demotion
            (CDEMO) rides the SAME tier: a demoted worker only gets a
            stage when every healthy peer is busy past the
            reservation window."""
            info = self.co.workers.get(w)
            if info is not None and info.demoted:
                return 0
            if not self.pressure_enabled:
                return 1
            if info is None or info.pressure < self.shed_score:
                return 1
            return 0

        def rank(t: _StageTask, w: str) -> Tuple[int, int, int]:
            return (unpressured(w), score(t, w), owned(t, w))

        now = time.monotonic()

        def eligible(t: _StageTask) -> bool:
            if self.steal_delay_s <= 0 or \
                    now - (t.ready_ts or now) >= self.steal_delay_s:
                return True     # reservation expired: anyone may take it
            mine = rank(t, wid)
            return all(rank(t, w) <= mine for w in alive if w != wid)

        ready = [t for t in ready if eligible(t)]
        if not ready:
            if self.pressure_enabled and not unpressured(wid):
                # This poll was shed purely by pressure demotion (a
                # less-loaded peer holds the reservation): visible in
                # telemetry + the event log, like every other rung.
                from spark_rapids_tpu_torch import monitoring
                from spark_rapids_tpu_torch.monitoring import telemetry
                telemetry.inc("srt_pressure_sheds")
                monitoring.instant(
                    "pressure-shed", "recovery",
                    args={"worker": wid,
                          "pressure": self.co.workers[wid].pressure})
            return None         # reserved for others — poll again shortly
        best = max(ready, key=lambda t: rank(t, wid) + (-t.sid,))
        best.status = _RUNNING
        best.worker = wid
        best.started_ts = now
        depgens = ",".join(f"{d}:{self.tasks[d].gen}"
                           for d in sorted(best.deps)) or "-"
        line = (f"CTASK {self.qid} {best.sid} {best.gen} {depgens} "
                f"{base64.b64encode(self.pkl_path.encode()).decode()}\n")
        self.co._jlog({"t": "dispatch", "qid": self.qid,
                       "sid": best.sid, "gen": best.gen, "wid": wid})
        return line, best

    def _on_done_locked(self, wid: str, sid: int, gen: int,
                        nbytes: int, report: Optional[dict] = None) -> None:
        t = self.tasks.get(sid)
        if t is None or t.gen != gen or t.status != _RUNNING or \
                t.worker != wid:
            return          # stale generation (zombie worker) — ignored
        if report is not None:
            self.worker_reports[wid] = report
        t.status = _DONE
        t.bytes = nbytes
        t.producer = wid
        self.co._jlog({"t": "done", "qid": self.qid, "sid": sid,
                       "gen": gen, "wid": wid, "bytes": nbytes})
        w = self.co.workers.get(wid)
        if w is not None:
            w.completed += 1
            if t.started_ts is not None:
                # Dispatch->commit wall sample: the supervisor's
                # straggler detector compares these across the fleet.
                w.sample(w.stage_wall_ms,
                         (time.monotonic() - t.started_ts) * 1000.0)
        if self._ctx is not None:
            self._metrics().add("stagesCompleted", 1)

    def _on_fail_locked(self, wid: str, sid: int, gen: int,
                        lost_sid: Optional[int], msg: str) -> None:
        t = self.tasks.get(sid)
        if t is None or t.gen != gen or t.worker != wid or \
                t.status != _RUNNING:
            return
        if lost_sid is not None and lost_sid in self.tasks:
            lost = self.tasks[lost_sid]
            if lost.status == _DONE:
                self._requeue_locked(lost,
                                     f"shard loss reported by {wid}")
        # The failed task itself retries behind the recomputed dep; a
        # loss-free failure (a real stage error) still retries — a
        # persistent bug exhausts the budget and surfaces the message.
        self._requeue_locked(t, f"{wid} reported: {msg}",
                             count_recompute=lost_sid is not None)


class ClusterServer(RendezvousServer):
    """The rendezvous server plus the cluster control-plane verbs: workers
    register with the rendezvous, so one socket and one wire grammar
    carry shard-commit announcements and stage-task scheduling side by
    side."""

    def __init__(self, co: "ClusterCoordinator", host: str, port: int):
        self._co = co
        super().__init__(host, port)

    def dispatch_extra(self, parts: List[str]) -> Optional[bytes]:
        return self._co.dispatch(parts)


class ClusterCoordinator:
    """Driver-side membership + scheduling authority (one per driver
    process in practice; instantiable standalone for tests/bench)."""

    def __init__(self, conf):
        self._lock = threading.Lock()
        self.workers: Dict[str, _WorkerInfo] = {}
        self.queries: Dict[int, QueryRun] = {}
        # Cleanly retired wids (CDRAIN -> CRETIRE) with the deadline
        # until which their stray daemon-thread heartbeats are ignored;
        # an explicit CREG re-admits the id immediately.
        self._retired: Dict[str, float] = {}
        self._next_qid = 1
        self.base_dir = str(conf.get(C.CLUSTER_DIR) or "") or \
            os.path.join(tempfile.gettempdir(),
                         f"srt_cluster_{os.getpid()}")
        os.makedirs(self.base_dir, exist_ok=True)
        # Store namespace for objectstore-backed queries: distinct
        # clusters sharing one store stay out of each other's keys.
        self.ns = os.path.basename(os.path.normpath(self.base_dir))
        self.hb_timeout_ms = max(
            int(conf.get(C.CLUSTER_HEARTBEAT_TIMEOUT_MS)), 1)
        self._backends: Dict[str, object] = {}
        # Write-ahead journal + replay BEFORE the server accepts
        # connections: a restarted coordinator re-adopts committed
        # stage outputs and re-learns its membership from the journal,
        # so reconnecting workers and a waiting driver resume instead
        # of restarting from zero.
        self.journal = None
        self.journal_replay_ms = 0.0
        if bool(conf.get(C.CLUSTER_JOURNAL_ENABLED)):
            from spark_rapids_tpu_torch.parallel.cluster.journal import Journal
            self.journal = Journal(
                os.path.join(self.base_dir, "journal", "journal.jsonl"),
                fsync=bool(conf.get(C.CLUSTER_JOURNAL_FSYNC)))
            t0 = time.monotonic()
            self._replay()
            self.journal_replay_ms = (time.monotonic() - t0) * 1000.0
        spec = str(conf.get(C.CLUSTER_COORDINATOR) or "")
        if spec:
            host, _, port = spec.rpartition(":")
            self.server = ClusterServer(self, host or "127.0.0.1",
                                        int(port))
        else:
            self.server = ClusterServer(self, "127.0.0.1", 0)
        self.addr = self.server.addr

    # -- journal / failover ---------------------------------------------------
    def _jlog(self, rec: dict) -> None:
        if self.journal is not None:
            self.journal.append(rec)

    def _backend(self, endpoint: str):
        """Process-cached objectstore backend for coordinator-side
        manifest checks and store cleanup."""
        b = self._backends.get(endpoint)
        if b is None:
            from spark_rapids_tpu_torch.parallel.transport.objectstore import \
                make_backend
            b = self._backends[endpoint] = make_backend(endpoint,
                                                        timeout_s=2.0)
        return b

    def _objectstore_delete(self, endpoint: str, prefix: str) -> None:
        """Best-effort key-prefix cleanup: a store outage during
        cleanup degrades to garbage, never to a failed query."""
        try:
            b = self._backend(endpoint)
            for k in b.list_keys(prefix):
                try:
                    b.delete(k)
                except Exception:
                    pass
        except Exception as e:
            _LOG.warning("objectstore cleanup of %s skipped: %s",
                         prefix, e)

    def _stage_committed(self, q: QueryRun, sid: int) -> bool:
        """Is stage ``sid``'s durable output still published (a valid
        committed manifest on the query's store)? The replay path uses
        this to RE-ADOPT outputs that survived the coordinator crash
        instead of recomputing them."""
        from spark_rapids_tpu_torch.parallel.transport.hostfile import \
            valid_manifest
        if q.store_kind == "objectstore":
            try:
                b = self._backend(q.store_endpoint)
                m = json.loads(b.get(
                    f"{q.store_prefix}/s{sid}/exchange.manifest.json"
                ).decode("utf-8"))
                return valid_manifest(m)
            except Exception:
                return False
        path = os.path.join(q.qdir, f"s{sid}", "exchange.manifest.json")
        try:
            with open(path, encoding="utf-8") as f:
                return valid_manifest(json.load(f))
        except (OSError, ValueError):
            return False

    def _replay(self) -> None:
        """Rebuild membership and per-query stage state from the
        journal (coordinator failover): committed stage outputs whose
        manifests still exist are re-adopted as DONE; tasks that were
        in flight are restored RUNNING so the executing worker's
        retried CDONE lands (its generation still matches) — if that
        worker is truly gone, the heartbeat sweep requeues the task,
        which is the ≤1-recompute bound the failover contract
        promises."""
        from spark_rapids_tpu_torch.parallel.cluster import journal as J
        recs = self.journal.records()
        if not recs:
            return
        state = J.replay_state(recs)
        now = time.monotonic()
        for wid in state["workers"]:
            self.workers[wid] = _WorkerInfo(wid, now)
        for wid in state.get("draining", ()):
            w = self.workers.get(wid)
            if w is not None:
                w.draining = True
        recovered: List[int] = []
        for qid in sorted(state["queries"]):
            qs = state["queries"][qid]
            sub = qs["submit"]
            try:
                conf = C.TpuConf(dict(sub.get("conf") or {}))
                q = QueryRun(self, qid, conf, {}, {})
                store = sub.get("store") or ["hostfile", "", ""]
                q.store_kind, q.store_endpoint, q.store_prefix = \
                    str(store[0]), str(store[1]), str(store[2])
                q.plan_fp = str(sub.get("fp") or "")
                if sub.get("pkl"):
                    q.pkl_path = str(sub["pkl"])
                # Re-verify the plan file on first dispatch: the crash
                # may have landed between admission and the plan write.
                q._pkl_ready = False
                deps = {int(k): {int(x) for x in v} for k, v in
                        (sub.get("deps") or {}).items()}
                q.tasks = {int(s): _StageTask(int(s),
                                              deps.get(int(s), set()))
                           for s in sub["stages"]}
                q.recomputes = int(qs.get("recomputes", 0))
                for sid, ts in qs["tasks"].items():
                    t = q.tasks.get(int(sid))
                    if t is None:
                        continue
                    t.gen = int(ts["gen"])
                    t.retries = int(ts["retries"])
                    if ts["status"] == "done":
                        if self._stage_committed(q, t.sid):
                            t.status = _DONE
                            t.bytes = int(ts["bytes"])
                            t.producer = ts.get("wid")
                        else:
                            # The journaled output did not survive the
                            # crash: one recompute, counted.
                            q._requeue_locked(
                                t, "journal replay: committed manifest"
                                   " missing")
                    elif ts["status"] == "running":
                        t.status = _RUNNING
                        t.worker = ts.get("wid")
            except Exception:
                _LOG.warning("journal replay: dropping unreadable "
                             "query %s", qid, exc_info=True)
                continue
            self.queries[qid] = q
            recovered.append(qid)
        self._next_qid = max(self._next_qid, int(state["next_qid"]))
        from spark_rapids_tpu_torch import monitoring
        monitoring.instant(
            "coordinator-replay", "recovery",
            args={"queries": recovered, "workers": state["workers"]})
        self._jlog({"t": "replay", "queries": recovered,
                    "workers": state["workers"]})
        if recovered or state["workers"]:
            _LOG.warning("cluster: journal replay recovered %d "
                         "worker(s), %d in-flight quer%s",
                         len(state["workers"]), len(recovered),
                         "y" if len(recovered) == 1 else "ies")

    # -- membership/scheduling (socket threads) ------------------------------
    def _alive_count_locked(self) -> int:
        return sum(1 for w in self.workers.values() if w.alive)

    def _alive_wids_locked(self) -> List[str]:
        return [w.wid for w in self.workers.values() if w.alive]

    def _placeable_wids_locked(self) -> List[str]:
        """Workers new stage tasks may land on: alive and NOT
        draining. Draining workers keep finishing their in-flight
        stages but drop out of the dispatch gate, locality ranking and
        rendezvous-hash ownership."""
        return [w.wid for w in self.workers.values()
                if w.alive and not w.draining]

    def _dispatch_retry_hint_locked(self, pending: int) -> float:
        """retry_after_ms for a dispatch-timeout rejection: the
        not-yet-done stage count drained at the fleet's observed mean
        stage wall (250ms prior before any stage has committed),
        spread over the live workers."""
        walls = [v for w in self.workers.values()
                 for v in w.stage_wall_ms]
        base = sum(walls) / len(walls) if walls else 250.0
        alive = max(self._alive_count_locked(), 1)
        return round(max(250.0, base * max(pending, 1) / alive), 1)

    def _inflight_locked(self, wid: str) -> int:
        return sum(1 for q in self.queries.values()
                   for t in q.tasks.values()
                   if t.status == _RUNNING and t.worker == wid)

    def _retire_locked(self, w: _WorkerInfo) -> None:
        """Drain completion: drop the worker from membership as a
        CLEAN retirement — no death counter, no requeue (it has no
        RUNNING task by construction) — and shield its id against the
        stray heartbeat race."""
        from spark_rapids_tpu_torch import faults, monitoring
        self.workers.pop(w.wid, None)
        self._retired[w.wid] = time.monotonic() + _RETIRE_GRACE_S
        faults.record("clusterWorkerRetirements")
        monitoring.instant("worker-retired", "cluster",
                           args={"worker": w.wid,
                                 "completed": w.completed})
        self._jlog({"t": "retire", "wid": w.wid})
        _LOG.info("cluster: worker %s drained and retired cleanly "
                  "(%d stage task(s) completed)", w.wid, w.completed)

    def _touch_locked(self, wid: str) -> Optional[_WorkerInfo]:
        now = time.monotonic()
        exp = self._retired.get(wid)
        if exp is not None:
            if now < exp:
                # A retired worker's daemon beat thread may land one
                # last CBEAT after its CRETIRE: swallowing it keeps the
                # id from being resurrected as a ghost member.
                return None
            del self._retired[wid]
        w = self.workers.get(wid)
        if w is None or not w.alive:
            from spark_rapids_tpu_torch import monitoring
            fresh = w is None
            w = self.workers[wid] = _WorkerInfo(wid, now)
            monitoring.instant("worker-join", "cluster",
                               args={"worker": wid, "rejoin": not fresh})
            self._jlog({"t": "reg", "wid": wid})
            _LOG.info("cluster: worker %s %sjoined", wid,
                      "" if fresh else "re")
        w.last_seen = now
        return w

    def _check_workers_locked(self) -> None:
        """Heartbeat monitor (driven from QueryRun.run's wait loop): a
        silent worker is declared dead and every RUNNING task it held —
        across all active queries — requeues onto survivors."""
        now = time.monotonic()
        for w in self.workers.values():
            if not w.alive or \
                    (now - w.last_seen) * 1000.0 < self.hb_timeout_ms:
                continue
            self._declare_dead_locked(
                w, f"heartbeat silent for >{self.hb_timeout_ms}ms")

    def _declare_dead_locked(self, w: _WorkerInfo, why: str) -> None:
        """Declare one worker dead and requeue every RUNNING task it
        held across all active queries. Shared by the heartbeat sweep
        and the CREG incarnation check."""
        w.alive = False
        from spark_rapids_tpu_torch import faults, monitoring
        faults.record("clusterWorkerDeaths")
        monitoring.instant("worker-death", "recovery",
                           args={"worker": w.wid})
        _LOG.warning("cluster: worker %s %s — declared dead; "
                     "requeueing its tasks", w.wid, why)
        for q in self.queries.values():
            for t in q.tasks.values():
                if t.status == _RUNNING and t.worker == w.wid:
                    if q._ctx is not None:
                        q._metrics().add("workerDeaths", 1)
                    q._requeue_locked(
                        t, f"worker {w.wid} died mid-stage")

    def dispatch(self, parts: List[str]) -> Optional[bytes]:
        try:
            return self._dispatch(parts)
        except Exception:                      # a torn request must not
            _LOG.exception("cluster verb failed: %r", parts)
            return b"ERR\n"                    # kill the handler thread

    def _dispatch(self, parts: List[str]) -> Optional[bytes]:
        cmd = parts[0].upper()
        if cmd == "CREG" and len(parts) in (2, 3):
            wid = parts[1]
            token = parts[2] if len(parts) == 3 else None
            with self._lock:
                # An explicit re-register always re-admits the id —
                # retirement only shields against STRAY beats.
                self._retired.pop(wid, None)
                w = self.workers.get(wid)
                if (token is not None and w is not None and w.alive
                        and w.incarnation is not None
                        and w.incarnation != token):
                    # Same wid, different process: the supervisor's
                    # replacement registered before the heartbeat sweep
                    # noticed the old incarnation's silence. Without
                    # this the dead process's RUNNING stages would stay
                    # assigned to a wid that keeps beating — a
                    # permanent dispatch stall.
                    self._declare_dead_locked(
                        w, "re-registered under a new incarnation "
                           f"({w.incarnation} -> {token})")
                w = self._touch_locked(wid)
                if token is not None and w is not None:
                    w.incarnation = token
            return b"OK\n"
        if cmd == "CBEAT" and len(parts) in (2, 3):
            with self._lock:
                w = self._touch_locked(parts[1])
                if w is not None:
                    # Heartbeat inter-arrival ring: the supervisor's
                    # straggler detector reads these through CSTATS.
                    now = time.monotonic()
                    if w.last_beat is not None:
                        w.sample(w.beat_ms,
                                 (now - w.last_beat) * 1000.0)
                    w.last_beat = now
            if len(parts) == 3:
                # Memory-pressure piggyback: the worker's catalog score
                # rides the heartbeat as a b64 JSON blob; CPOLL placement
                # demotes pressured workers below steal-delay preference
                # (_pick_locked). Two-part beats stay valid.
                try:
                    blob = json.loads(
                        base64.b64decode(parts[2]).decode())
                    score = blob.get("series", {}).get(
                        "srt_pressure_score|")
                    if score is not None:
                        with self._lock:
                            w = self.workers.get(parts[1])
                            if w is not None:
                                w.pressure = float(score)
                except Exception:
                    _LOG.warning("cluster: bad CBEAT blob from %s",
                                 parts[1], exc_info=True)
            return b"OK\n"
        if cmd == "CPOLL" and len(parts) == 3:
            wid, known = parts[1], parts[2]
            with self._lock:
                w = self._touch_locked(wid)
                if w is None:
                    # Still inside the retire grace window: repeat the
                    # retire answer (idempotent) instead of ghosting.
                    return b"CRETIRE\n"
                if w.draining:
                    if self._inflight_locked(wid) == 0:
                        self._retire_locked(w)
                        return b"CRETIRE\n"
                    return b"CIDLE -\n"   # finish in-flight, no new work
                stale = [q for q in known.split(",")
                         if q and q != "-"
                         and int(q) not in self.queries]
                # Priority classes first (QoS rank, interactive < batch
                # < background), stage-id/locality order within a query
                # unchanged; qid tiebreak keeps the scan deterministic.
                for qid in sorted(self.queries,
                                  key=lambda q:
                                  (self.queries[q].qos_rank, q)):
                    picked = self.queries[qid]._pick_locked(wid)
                    if picked is not None:
                        line, _ = picked
                        return line.encode()
            return f"CIDLE {','.join(stale) or '-'}\n".encode()
        if cmd == "CDONE" and len(parts) in (6, 7):
            _, wid, qid, sid, gen, nbytes = parts[:6]
            report = None
            if len(parts) == 7:
                # Per-node observed stats + trace ring piggyback (the
                # cluster explain_analyze / merged-Perfetto plumbing).
                # Old-format CDONEs (6 parts) stay valid forever.
                try:
                    report = json.loads(
                        base64.b64decode(parts[6]).decode())
                except Exception:
                    _LOG.warning("cluster: bad CDONE report blob from "
                                 "%s", wid, exc_info=True)
            with self._lock:
                self._touch_locked(wid)
                q = self.queries.get(int(qid))
                if q is not None:
                    q._on_done_locked(wid, int(sid), int(gen),
                                      int(nbytes), report=report)
            return b"OK\n"
        if cmd == "CFAIL" and len(parts) == 7:
            _, wid, qid, sid, gen, lost, b64 = parts
            msg = base64.b64decode(b64).decode("utf-8", "replace")
            with self._lock:
                self._touch_locked(wid)
                q = self.queries.get(int(qid))
                if q is not None:
                    q._on_fail_locked(
                        wid, int(sid), int(gen),
                        None if lost == "-" else int(lost), msg)
            return b"OK\n"
        if cmd == "CDRAIN" and len(parts) == 2:
            # Clean scale-down / self-retirement: stop
            # dispatching to the worker; its in-flight stages commit,
            # then its next idle CPOLL answers CRETIRE. Idempotent,
            # and a no-op for unknown or already-retired ids.
            wid = parts[1]
            with self._lock:
                w = self.workers.get(wid)
                if w is not None and w.alive and not w.draining:
                    w.draining = True
                    from spark_rapids_tpu_torch import monitoring
                    monitoring.instant(
                        "worker-drain", "cluster",
                        args={"worker": wid,
                              "inflight": self._inflight_locked(wid)})
                    self._jlog({"t": "drain", "wid": wid})
                    _LOG.info("cluster: worker %s draining (%d stage "
                              "task(s) in flight)", wid,
                              self._inflight_locked(wid))
            return b"OK\n"
        if cmd == "CDEMO" and len(parts) == 3:
            # Straggler demotion toggle (supervisor): a demoted worker
            # ranks below every non-demoted peer in CPOLL placement —
            # the same tier pressure shedding uses — until promoted.
            wid, flag = parts[1], parts[2] not in ("0", "false")
            with self._lock:
                w = self.workers.get(wid)
                changed = w is not None and w.demoted != flag
                if changed:
                    w.demoted = flag
            if changed:
                from spark_rapids_tpu_torch import monitoring
                monitoring.instant(
                    "worker-straggler" if flag else "worker-promoted",
                    "cluster", args={"worker": wid})
                _LOG.warning("cluster: worker %s %s steal-delay "
                             "preference (straggler %s)", wid,
                             "demoted below" if flag else
                             "promoted back into",
                             "demotion" if flag else "recovery")
            return b"OK\n"
        if cmd == "CSTATS" and len(parts) == 1:
            blob = base64.b64encode(
                json.dumps(self.stats()).encode()).decode()
            return f"OK {blob}\n".encode()
        return None

    def stats(self) -> dict:
        with self._lock:
            now = time.monotonic()
            return {
                "workers": {
                    w.wid: {"alive": w.alive, "completed": w.completed,
                            "idle_ms": int((now - w.last_seen) * 1000),
                            "draining": w.draining,
                            "demoted": w.demoted,
                            "pressure": round(w.pressure, 4),
                            "inflight": self._inflight_locked(w.wid),
                            "beat_ms": list(w.beat_ms),
                            "stage_wall_ms": list(w.stage_wall_ms)}
                    for w in self.workers.values()},
                "retired": sorted(self._retired),
                "queries": {
                    str(qid): {
                        str(t.sid): {"status": t.status,
                                     "worker": t.worker, "gen": t.gen,
                                     "retries": t.retries,
                                     "producer": t.producer,
                                     "bytes": t.bytes}
                        for t in q.tasks.values()}
                    for qid, q in self.queries.items()},
            }

    # -- query submission (driver thread) ------------------------------------
    def _store_params(self, conf) -> Tuple[str, str]:
        """(store kind, endpoint) for a new query's stage outputs."""
        kind = cluster_store_kind(conf)
        endpoint = ""
        if kind == "objectstore":
            from spark_rapids_tpu_torch.parallel.transport.objectstore import \
                resolve_endpoint
            endpoint = resolve_endpoint(conf)
        return kind, endpoint

    @staticmethod
    def _broadcast_maps(graph, deps) -> Tuple[Dict[int, int],
                                              Dict[int, List[int]]]:
        """(bcast_tags, bcast_deps) for the broadcast artifact cache:
        each broadcast-boundary stage keyed by its exchange identity,
        plus the dispatchable upstream stages whose generations key the
        cache entry."""
        from spark_rapids_tpu_torch.parallel.exchange import \
            BroadcastExchangeExec
        tags = {id(st.boundary): sid for sid, st in graph.stages.items()
                if isinstance(st.boundary, BroadcastExchangeExec)}
        bdeps = {sid: sorted(deps.get(sid, ()))
                 for sid in tags.values()}
        return tags, bdeps

    def submit(self, phys, conf, graph=None,
               binds=None) -> Optional[QueryRun]:
        """Partition ``phys``'s stage DAG into dispatchable tasks and
        open a QueryRun, or None when the plan has no dispatchable
        stage or cannot cross a process boundary (unpicklable)."""
        from spark_rapids_tpu_torch.parallel import stages as S
        if graph is None:
            graph = S.build_stage_graph(phys.root)
        _, dispatchable, deps = stage_plan(phys.root, graph)
        if not dispatchable:
            return None
        with self._lock:
            qid = self._next_qid
            self._next_qid += 1
        kind, endpoint = self._store_params(conf)
        prefix = f"{self.ns}/q{qid}" if kind == "objectstore" else ""
        worker_raw = {
            k: v for k, v in phys.conf.raw.items()
            # Conf-armed fault schedules stay driver-side: a spec
            # shipped to every worker would fire the same injection N
            # times (once per process). Worker-scoped chaos arms via
            # each worker's SRT_FAULTS environment instead.
            if not k.startswith("spark.rapids.sql.test.faults")
            and k != C.CLUSTER_ENABLED.key}
        if kind == "objectstore":
            # Pin the query's store coordinates into the shipped conf:
            # every worker (and the driver's fetch sessions) resolves
            # the SAME endpoint + key prefix regardless of its local
            # env, so the store is part of the plan, not the ambiance.
            worker_raw[C.SHUFFLE_TRANSPORT.key] = "objectstore"
            worker_raw[C.SHUFFLE_TRANSPORT_OBJECTSTORE_ENDPOINT.key] = \
                endpoint
            worker_raw[C.SHUFFLE_TRANSPORT_OBJECTSTORE_PREFIX.key] = \
                prefix
        try:
            blob = pickle.dumps((phys.root, worker_raw, binds))
        except Exception as e:
            _LOG.warning("cluster: plan not picklable (%s: %s) — "
                         "standing down to local execution",
                         type(e).__name__, e)
            return None
        bcast_tags, bcast_deps = self._broadcast_maps(graph, deps)
        with self._lock:
            tasks = {sid: _StageTask(sid, deps.get(sid, set())
                                     & dispatchable)
                     for sid in dispatchable}
            driver_tags = {id(graph.stages[sid].boundary):
                           (sid, f"s{sid}")
                           for sid in dispatchable}
            q = QueryRun(self, qid, conf, tasks, driver_tags)
            q._blob = blob
            q._root = phys.root
            q.store_kind, q.store_endpoint, q.store_prefix = \
                kind, endpoint, prefix
            q.plan_fp = hashlib.sha256(blob).hexdigest()[:12]
            q._bcast_tags = bcast_tags
            q._bcast_deps = bcast_deps
            os.makedirs(q.qdir, exist_ok=True)
            self._write_plan(q)
            q._pkl_ready = True
            self.queries[qid] = q
        self._jlog({
            "t": "submit", "qid": qid,
            "stages": sorted(dispatchable),
            "deps": {str(s): sorted(deps.get(s, set()) & dispatchable)
                     for s in dispatchable},
            "conf": worker_raw, "pkl": q.pkl_path,
            "store": [kind, endpoint, prefix], "fp": q.plan_fp})
        from spark_rapids_tpu_torch import monitoring
        monitoring.instant("cluster-submit", "cluster",
                           args={"query": qid,
                                 "stages": len(dispatchable)})
        return q

    def _write_plan(self, q: QueryRun) -> None:
        tmp = q.pkl_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(q._blob)
        os.replace(tmp, q.pkl_path)

    def close(self, remove_dir: bool = True) -> None:
        """Stop the server; ``remove_dir=False`` keeps the cluster dir
        (journal + plans + spool) — the standalone coordinator uses it
        so a SIGKILL'd-then-restarted process can replay."""
        self.server.close()
        if remove_dir:
            shutil.rmtree(self.base_dir, ignore_errors=True)


# -- process-global coordinator (driver side) --------------------------------

_CO: Optional[ClusterCoordinator] = None
_CO_LOCK = threading.Lock()


def get_coordinator(conf) -> ClusterCoordinator:
    """The driver process's coordinator, created on first use from
    ``conf``'s cluster.* keys (later calls return the same instance —
    one control plane per driver, like the query manager)."""
    global _CO
    with _CO_LOCK:
        if _CO is None:
            _CO = ClusterCoordinator(conf)
        return _CO


def shutdown_coordinator() -> None:
    """Tear down the process-global coordinator (tests/bench)."""
    global _CO
    with _CO_LOCK:
        co, _CO = _CO, None
    if co is not None:
        co.close()


def maybe_prepare(phys, ctx, graph=None) -> Optional[QueryRun]:
    """The planner's prepare hook: a QueryRun for this collect, or None
    when the query must run locally. Stand-downs keep cluster mode
    CORRECT rather than clever — any query the dispatch model cannot
    represent simply executes exactly as before."""
    conf = ctx.conf
    if not cluster_enabled(conf):
        return None
    if not phys.root_on_device or phys.host_fallback_nodes():
        return None             # host islands run the oracle engine
    from spark_rapids_tpu_torch.parallel import transport as T
    if T.transport_name(conf) == "mesh":
        return None             # collective exchange owns the shuffle
    binds = None
    if "plan_binds" in ctx.cache:
        # A plan-cache template executes against per-collect bound
        # literals; workers need them to resolve bind slots.
        binds = (ctx.cache["plan_binds"], ctx.cache["plan_bind_dtypes"])
    if bool(conf.get(C.CLUSTER_COORDINATOR_REMOTE)):
        # The driver as a client of a standalone coordinator comes with
        # the coordinator's own process (remote.py, main): never run
        # such a query locally in silence.
        from spark_rapids_tpu_torch.plan.logical import NotPortedError
        raise NotPortedError(
            "spark.rapids.sql.cluster.coordinator.remote=true: the driver "
            "client of a standalone coordinator (parallel/cluster/"
            "remote.py) and the coordinator's main are not ported yet; "
            "they are the next cluster slice (ROADMAP A13)")
    co = get_coordinator(conf)
    q = co.submit(phys, conf, graph, binds)
    if q is None:
        return None
    q.install(ctx)
    m = q._metrics()
    m.add("stagesDispatched", len(q.tasks))
    return q
