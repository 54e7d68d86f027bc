"""Priority classes and weighted fair queueing with a hard starvation
bound (port of the JAX package's ``parallel/qos/policy.py``).

Three fixed priority classes, ``interactive`` > ``batch`` >
``background``, drain through :class:`WfqQueue`, a stride scheduler:
every class carries a virtual time that advances by ``1/weight`` each
time it is served, and the next run slot goes to the non-empty class
with the SMALLEST virtual time (ties break by class rank). Service is
proportional to the weight vector over any window, and the drain order
is a pure function of the arrival schedule: no clocks, no randomness.

On top of the stride order sits a HARD starvation bound: every time a
non-empty class is passed over for a dispatch its bypass counter ticks;
once a class has been bypassed ``starvation_bound`` times in a row its
head runs NEXT regardless of virtual time (the engagement is counted).

Within a class, entries drain shortest-job-first by a cost estimate in
ms. The port has no cost model yet, so every query it admits is
un-priced: un-priced entries order after every priced one, FIFO among
themselves.

Pure data structure: no locks (the QueryManager's lock covers it), no
engine imports.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

CLASSES: Tuple[str, ...] = ("interactive", "batch", "background")
CLASS_RANK: Dict[str, int] = {name: i for i, name in enumerate(CLASSES)}
DEFAULT_CLASS = "batch"
_UNPRICED = float("inf")


def resolve_class(name: Optional[str]) -> str:
    """Normalize a priority-class spec (a ``priority=`` kwarg or the conf
    value) to one of :data:`CLASSES`; empty or None is ``batch``."""
    if not name:
        return DEFAULT_CLASS
    v = str(name).strip().lower()
    if v not in CLASS_RANK:
        raise ValueError(
            f"unknown priority class {name!r} (expected one of {CLASSES})")
    return v


def parse_weights(spec: str) -> Dict[str, float]:
    """``"8,3,1"`` -> ``{interactive: 8, batch: 3, background: 1}``.
    Weights must be positive."""
    parts = [p.strip() for p in str(spec).split(",")]
    if len(parts) != len(CLASSES):
        raise ValueError(
            f"scheduler.qos.weights expects {len(CLASSES)} comma-separated "
            f"values (one per class {CLASSES}), got {spec!r}")
    out = {}
    for name, p in zip(CLASSES, parts):
        w = float(p)
        if w <= 0:
            raise ValueError(
                f"scheduler.qos.weights: weight for {name!r} must be > 0, "
                f"got {w}")
        out[name] = w
    return out


class QueueEntry:
    """One waiting query: its class, SJF cost key, arrival sequence and
    the wake event the granted slot sets. ``granted`` / ``cancelled``
    make removal race-free under the manager's lock (a cancelled entry
    is skipped at pop time)."""

    __slots__ = ("qos_class", "cost_ms", "seq", "event", "tenant",
                 "granted", "cancelled")

    def __init__(self, qos_class: str, cost_ms: Optional[float], seq: int,
                 event, tenant: Optional[str] = None):
        self.qos_class = qos_class
        self.cost_ms = float(cost_ms) if cost_ms is not None else _UNPRICED
        self.seq = seq
        self.event = event
        self.tenant = tenant
        self.granted = False
        self.cancelled = False

    def sort_key(self) -> Tuple[float, int]:
        return (self.cost_ms, self.seq)


class _ClassQueue:
    __slots__ = ("heap", "vtime", "bypass", "live")

    def __init__(self):
        self.heap: List[Tuple[Tuple[float, int], QueueEntry]] = []
        self.vtime = 0.0
        self.bypass = 0
        self.live = 0           # entries in the heap not cancelled

    def push(self, entry: QueueEntry) -> None:
        heapq.heappush(self.heap, (entry.sort_key(), entry))
        self.live += 1

    def pop(self) -> Optional[QueueEntry]:
        while self.heap:
            _, e = heapq.heappop(self.heap)
            if e.cancelled:
                continue
            self.live -= 1
            return e
        return None


class WfqQueue:
    """The QoS run queue: one SJF heap per class, drained by stride
    scheduling with a hard starvation bound."""

    def __init__(self, weights: Dict[str, float], starvation_bound: int):
        self.weights = dict(weights)
        self.starvation_bound = max(int(starvation_bound), 1)
        self._classes = {name: _ClassQueue() for name in CLASSES}
        self._seq = 0
        self._global_vtime = 0.0

    def __len__(self) -> int:
        return sum(c.live for c in self._classes.values())

    def depth(self, qos_class: Optional[str] = None) -> int:
        if qos_class is None:
            return len(self)
        return self._classes[qos_class].live

    def push(self, qos_class: str, cost_ms: Optional[float], event,
             tenant: Optional[str] = None) -> QueueEntry:
        cq = self._classes[qos_class]
        if cq.live == 0:
            # A class idle for a while joins at the CURRENT virtual time
            # instead of cashing in credit for its idle stretch.
            cq.vtime = max(cq.vtime, self._global_vtime)
        self._seq += 1
        entry = QueueEntry(qos_class, cost_ms, self._seq, event, tenant)
        cq.push(entry)
        return entry

    def discard(self, entry: QueueEntry) -> None:
        """Remove a waiter that timed out or was cancelled while queued:
        the heap drops it at pop time, the counts adjust now."""
        if not entry.cancelled and not entry.granted:
            entry.cancelled = True
            self._classes[entry.qos_class].live -= 1

    def pop_next(self) -> Tuple[Optional[QueueEntry], bool]:
        """The next query to grant a run slot: ``(entry, starved)``,
        ``starved`` True when the starvation bound, not the stride order,
        picked the class; ``(None, False)`` when nothing is queued."""
        nonempty = [(name, cq) for name, cq in self._classes.items()
                    if cq.live > 0]
        if not nonempty:
            return None, False
        starved = [(name, cq) for name, cq in nonempty
                   if cq.bypass >= self.starvation_bound]
        engaged = False
        if starved:
            # The longest-bypassed class runs next; ties break by class
            # rank.
            name, cq = max(
                starved,
                key=lambda nc: (nc[1].bypass, -CLASS_RANK[nc[0]]))
            engaged = True
        else:
            name, cq = min(
                nonempty,
                key=lambda nc: (nc[1].vtime, CLASS_RANK[nc[0]]))
        entry = cq.pop()
        assert entry is not None
        entry.granted = True
        # The system virtual time is the vtime service happened at;
        # classes that re-activate later join here.
        self._global_vtime = max(self._global_vtime, cq.vtime)
        cq.vtime += 1.0 / self.weights[name]
        cq.bypass = 0
        for other, ocq in self._classes.items():
            if other != name and ocq.live > 0:
                ocq.bypass += 1
        return entry, engaged
