"""The coordinator's write-ahead journal (port of the JAX package's
``parallel/cluster/journal.py``).

The coordinator's in-memory state (worker registrations and every
query's per-stage task state: dispatch, done, generation, requeue) dies
with its process. This module keeps it as an append-only JSONL journal
under ``<cluster.dir>/journal/``, in the event log's idiom
(``monitoring/history.py``): one JSON object a line, appended under a
lock, read back torn-line tolerant. A coordinator made over the same
directory replays it, re-adopts stage outputs whose manifests are still
committed, and requeues only what was in flight: a coordinator crash
costs at most one recompute per affected stage.

Record kinds (all carry ``ts``)::

    {"t":"reg","wid":...}                          worker registration
    {"t":"submit","qid":...,"stages":[sid,...],
     "deps":{sid:[sid,...]},"conf":{...},"pkl":...} query admission
    {"t":"dispatch","qid":...,"sid":...,"gen":...,
     "wid":...}                                    task handed to a worker
    {"t":"done","qid":...,"sid":...,"gen":...,
     "wid":...,"bytes":...}                        stage output committed
    {"t":"requeue","qid":...,"sid":...,"gen":...,
     "retries":...}                                recompute scheduled
    {"t":"reset","qid":...}                        whole-query reset
    {"t":"finish","qid":...}                       query finished
    {"t":"drain","wid":...} / {"t":"retire",...}   drain and retirement
    {"t":"replay","ms":...,"queries":[...],
     "workers":[...]}                              a restart recovered

Appends are buffered (``cluster.journal.fsync`` false by default): a
torn or unflushed tail costs at most the recompute the crash causes
anyway. After the last active query finishes, the journal is rewritten
atomically with only the live registrations, so it does not grow
without bound.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

_LOG = logging.getLogger("spark_rapids_tpu_torch.cluster")


class Journal:
    """Append-only JSONL WAL with a torn-line-tolerant reader. Safe for
    concurrent appends from coordinator handler threads (one lock, one
    O_APPEND file); never raises out of ``append`` — a journal write
    failure degrades durability, it must not fail a running query."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path), exist_ok=True)

    def append(self, rec: dict) -> None:
        rec = dict(rec)
        rec.setdefault("ts", time.time())
        try:
            line = json.dumps(rec, sort_keys=True)
            with self._lock:
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
                    if self.fsync:
                        f.flush()
                        os.fsync(f.fileno())
        except Exception:
            _LOG.warning("journal append failed (%s)", self.path,
                         exc_info=True)

    def records(self) -> List[dict]:
        """All parseable records, in append order; a torn trailing line
        (the crash was mid-append) is skipped, exactly like the event
        log's reader."""
        out: List[dict] = []
        try:
            with open(self.path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue
        except FileNotFoundError:
            pass
        return out

    def rewrite(self, recs: List[dict]) -> None:
        """Atomic compaction (tmp + rename): replaces the journal with
        ``recs`` — the same old-complete-or-new-complete contract every
        manifest in this codebase uses."""
        try:
            tmp = self.path + ".tmp"
            with self._lock:
                with open(tmp, "w", encoding="utf-8") as f:
                    for rec in recs:
                        f.write(json.dumps(rec, sort_keys=True) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)
        except Exception:
            _LOG.warning("journal compaction failed (%s)", self.path,
                         exc_info=True)


def replay_state(recs: List[dict]) -> Dict:
    """Fold raw journal records into the recovered logical state:

    - ``workers``: wids seen registering (latest knowledge; liveness is
      re-established by their reconnect heartbeats),
    - ``draining``: wids whose drain (CDRAIN) was journaled but whose
      retirement was not — a restarted coordinator re-marks them
      draining so the retire handshake completes instead of the worker
      polling forever for its CRETIRE,
    - ``queries``: qid -> {"submit": rec, "tasks": {sid: {"status",
      "gen", "wid", "bytes", "retries"}}} for every UNFINISHED query,
    - ``next_qid``: one past the highest qid ever admitted.

    Pure function of the record list so it is unit-testable without a
    coordinator."""
    workers: List[str] = []
    draining: List[str] = []
    queries: Dict[int, dict] = {}
    next_qid = 1
    for r in recs:
        t = r.get("t")
        if t == "reg":
            wid = str(r.get("wid", ""))
            if wid and wid not in workers:
                workers.append(wid)
            if wid in draining:
                draining.remove(wid)
        elif t == "drain":
            wid = str(r.get("wid", ""))
            if wid in workers and wid not in draining:
                draining.append(wid)
        elif t == "retire":
            wid = str(r.get("wid", ""))
            if wid in workers:
                workers.remove(wid)
            if wid in draining:
                draining.remove(wid)
        elif t == "submit":
            try:
                qid = int(r["qid"])
                stages = [int(s) for s in r["stages"]]
            except (KeyError, TypeError, ValueError):
                continue
            next_qid = max(next_qid, qid + 1)
            queries[qid] = {
                "submit": r, "recomputes": 0,
                "tasks": {sid: {"status": "pending", "gen": 0,
                                "wid": None, "bytes": 0, "retries": 0}
                          for sid in stages}}
        elif t in ("dispatch", "done", "requeue"):
            q = queries.get(r.get("qid"))
            if q is None:
                continue
            task = q["tasks"].get(int(r.get("sid", -1)))
            if task is None:
                continue
            gen = int(r.get("gen", 0))
            if t == "dispatch":
                # A dispatch for an older generation is stale news.
                if gen >= task["gen"]:
                    task.update(status="running", gen=gen,
                                wid=r.get("wid"))
            elif t == "done":
                if gen >= task["gen"]:
                    task.update(status="done", gen=gen,
                                wid=r.get("wid"),
                                bytes=int(r.get("bytes", 0)))
            else:  # requeue: gen already bumped by the writer
                if gen >= task["gen"]:
                    task.update(status="pending", gen=gen, wid=None,
                                retries=int(r.get("retries",
                                              task["retries"] + 1)))
                    if r.get("counted", True):
                        # Recompute baseline: a restarted coordinator
                        # must not re-report pre-crash recomputes to a
                        # remote driver as fresh ones.
                        q["recomputes"] = q.get("recomputes", 0) + 1
        elif t == "reset":
            q = queries.get(r.get("qid"))
            if q is not None:
                for task in q["tasks"].values():
                    task.update(status="pending", wid=None, bytes=0)
        elif t == "finish":
            queries.pop(r.get("qid"), None)
    return {"workers": workers, "draining": draining,
            "queries": queries, "next_qid": next_qid}
