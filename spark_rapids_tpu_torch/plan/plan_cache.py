"""Parameterized plan cache (port of the JAX package's
``plan/plan_cache.py``): a repeated query shape with new literals re-binds
its literals instead of re-planning.

Every ``collect()`` of a new DataFrame runs pruning, pushdown, tagging,
conversion and fusion from scratch, and its in-memory sources encode and
pack their batches anew. One mechanism removes both for a repeated shape:

1. :func:`parameterize` rewrites a logical plan's bindable literal leaves
   (numeric / bool operands of comparisons and arithmetic in filters and
   projections, and ``limit(n)`` budgets) into positional BIND SLOTS
   (``("bindslot", i, dtype)`` Column nodes that resolve to value-free
   ``exprs.bindslots.BindSlotExpr`` leaves). Literals in structural
   positions (string widths, patterns, isin sets, pad / round / slice
   arguments, aggregate internals) stay inline.
2. The parameterized shape keys a process-global LRU: (structural plan
   fingerprint with input schemas and sources, conf snapshot, the
   session's device). A hit returns the planned and fused
   ``PhysicalPlan`` TEMPLATE, with its sources' packed encodings.
3. :class:`BoundPlan` marries the shared template with THIS call's
   literal values; ``collect()`` installs them in the execution context,
   where the device steps read them as 0-d tensors and host-side
   consumers (limit budgets, scan row-group pruning) as python values.

Correctness lines:

- Invalidation is conservative: ANY conf change misses (the snapshot is
  the whole raw conf), as does another device (a CPU session and a CUDA
  session over the same host batches plan for their own device);
  schema, path and option changes miss structurally, and so does a
  scanned file rewritten in place (its mtime and size key the scan).
- Per-query state stays per execution: the ExecContext, its cache (built
  sides, exchange pieces, prefetch payloads) and metrics are fresh per
  collect; nothing is written back into the template but pure functions
  of plan-time state (a source's packed batches, a range exchange's
  sampled bounds, which any execution may use).
- In-memory sources key by source-batch OBJECT identity; the key holds
  strong references, so an id can never be recycled into a false hit
  (the LRU bound caps what that pins).
- Plans holding opaque callables (pandas UDF nodes, generate) raise
  :class:`Uncacheable` and plan fresh.

``SRT_PLAN_CACHE=0`` (env) or ``spark.rapids.sql.planCache.enabled``
=false plans every DataFrame anew, as before the cache. So does an armed
fault schedule (``faults.py``; counted as ``planCacheBypasses``): chaos
schedules target per-plan state, and a shared template would couple
independently armed queries. With the flight recorder on, each bind is a
``plan-bind`` span (``planning``, query level) and a ``plan-cache-hit`` /
``plan-cache-miss`` instant; ``planBindNs`` counts its time either way.
"""

from __future__ import annotations

import collections
import copy
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.exprs.bindslots import BindValue
from spark_rapids_tpu_torch.ops.kernel_cache import schema_fingerprint
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.logical import (
    Column, LogicalPlan, canonical_node)

# ---------------------------------------------------------------------------
# Process-global counters
# ---------------------------------------------------------------------------

_COUNTER_LOCK = threading.Lock()
_COUNTERS: Dict[str, float] = {}


def _record(name: str, amount: float = 1) -> None:
    with _COUNTER_LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + amount


def counters() -> Dict[str, float]:
    """planCacheHits / planCacheMisses / planCacheEvictions /
    planCacheUncacheable / bindOnlyExecutions / planBindNs."""
    with _COUNTER_LOCK:
        return dict(_COUNTERS)


def reset_counters() -> None:
    with _COUNTER_LOCK:
        _COUNTERS.clear()


def plan_cache_enabled(conf) -> bool:
    """The conf key wins; else the SRT_PLAN_CACHE env; else the default."""
    if conf.raw.get(C.PLAN_CACHE_ENABLED.key) is not None:
        return bool(conf.get(C.PLAN_CACHE_ENABLED))
    env = os.environ.get("SRT_PLAN_CACHE")
    if env is not None:
        return env.strip() not in ("0", "false", "no")
    return bool(C.PLAN_CACHE_ENABLED.default)


# ---------------------------------------------------------------------------
# Literal hoisting (parameterization)
# ---------------------------------------------------------------------------

# Expression kinds whose DIRECT literal operands flow as pure data: the
# scalar expands into a column and no shape depends on the value.
# Everything else keeps its literal inline.
_SAFE_BINARY = {"add", "sub", "mul", "div", "mod",
                "eq", "lt", "le", "gt", "ge"}


def _bindable_dtype(v) -> Optional[dt.DataType]:
    """The slot dtype of a hoistable literal: EXACTLY the inference
    ``exprs.base.lit`` applies, so a template plans with the types the
    unhoisted plan would."""
    if isinstance(v, bool):
        return dt.BOOL
    if isinstance(v, int):
        return dt.INT32 if -2**31 <= v < 2**31 else dt.INT64
    if isinstance(v, float):
        return dt.FLOAT64
    return None


class _Hoister:
    """Collects hoisted values and dtypes in deterministic DFS order (two
    equal-shaped plans number their slots identically)."""

    def __init__(self):
        self.values: List[Any] = []
        self.dtypes: List[dt.DataType] = []

    def _slot(self, value, dtype) -> int:
        self.values.append(value)
        self.dtypes.append(dtype)
        return len(self.values) - 1

    def rewrite(self, c: Column) -> Column:
        node = c.node
        kind = node[0]
        hoist_at = (1, 2) if kind in _SAFE_BINARY else ()
        out: List[Any] = [kind]
        changed = False
        for idx, x in enumerate(node[1:], start=1):
            if isinstance(x, Column):
                if idx in hoist_at and x.node[0] == "lit":
                    t = _bindable_dtype(x.node[1])
                    if t is not None:
                        out.append(Column(
                            ("bindslot", self._slot(x.node[1], t), t)))
                        changed = True
                        continue
                nx = self.rewrite(x)
                changed |= nx is not x
                out.append(nx)
            elif isinstance(x, tuple):
                nx, tchanged = self._rewrite_tuple(x)
                out.append(nx if tchanged else x)
                changed |= tchanged
            else:
                out.append(x)
        if not changed:
            return c
        return Column(tuple(out))

    def _rewrite_tuple(self, t: tuple) -> Tuple[tuple, bool]:
        out: List[Any] = []
        changed = False
        for y in t:
            if isinstance(y, Column):
                ny = self.rewrite(y)
                changed |= ny is not y
                out.append(ny)
            elif isinstance(y, tuple):
                ny, ychanged = self._rewrite_tuple(y)
                out.append(ny if ychanged else y)
                changed |= ychanged
            else:
                out.append(y)
        return tuple(out), changed


def parameterize(plan: LogicalPlan):
    """``plan`` with its bindable literals hoisted into slots:
    ``(parameterized_plan, values, dtypes)``; the plan itself where
    nothing hoists."""
    h = _Hoister()
    new = _walk(plan, h)
    return new, tuple(h.values), tuple(h.dtypes)


def _walk(plan: LogicalPlan, h: _Hoister) -> LogicalPlan:
    kids = [_walk(c, h) for c in plan.children]
    same_kids = all(a is b for a, b in zip(kids, plan.children))
    if isinstance(plan, L.LogicalFilter):
        cond = h.rewrite(plan.condition)
        if cond is plan.condition and same_kids:
            return plan
        return L.LogicalFilter(kids[0], cond)
    if isinstance(plan, L.LogicalProject):
        projections = [(n, h.rewrite(c)) for n, c in plan.projections]
        if same_kids and all(a[1] is b[1] for a, b in
                             zip(projections, plan.projections)):
            return plan
        return L.LogicalProject(kids[0], projections)
    if isinstance(plan, L.LogicalLimit) and isinstance(plan.n, int):
        # Limit budgets are host-side python ints: hoisted as BindValue
        # markers the limit execs resolve per execution.
        return L.LogicalLimit(kids[0], BindValue(h._slot(
            int(plan.n), dt.INT64)))
    if same_kids:
        return plan
    cp = copy.copy(plan)
    cp.children = tuple(kids)
    return cp


# ---------------------------------------------------------------------------
# Structural plan keys
# ---------------------------------------------------------------------------

class Uncacheable(Exception):
    """This plan shape cannot be keyed safely (opaque callables, unknown
    node types): plan fresh every time."""


class _IdKey:
    """Identity-hashed strong reference: keys an in-memory source batch by
    OBJECT identity while pinning the object, so a garbage-collected id
    can never be recycled into a false cache hit."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _IdKey) and other.obj is self.obj


def _file_stamp(path) -> Tuple[int, int]:
    """(mtime in ns, size) of a scanned file; a path that cannot be read
    plans fresh, where the scan raises its own error."""
    try:
        st = os.stat(path)
    except OSError:
        raise Uncacheable(f"scan of unreadable {path!r}")
    return st.st_mtime_ns, st.st_size


def _canon_cols(pairs) -> Tuple:
    return tuple((n, canonical_node(c)) for n, c in pairs)


def plan_key(plan: LogicalPlan) -> Tuple:
    """Hashable structural fingerprint of a (parameterized) logical plan:
    node types, schemas, canonical expression ASTs (bind slots are
    value-free), join and grouping shapes. Two plans with equal keys plan
    to semantically identical templates. Every logical node the port has
    is modelled here or refused (generate and the pandas nodes)."""
    kids = tuple(plan_key(c) for c in plan.children)
    if isinstance(plan, L.InMemoryScan):
        return ("mem", schema_fingerprint(plan.source_schema),
                tuple(tuple(_IdKey(hb) for hb in p)
                      for p in plan.partitions))
    if isinstance(plan, L.FileScan):
        # A template's scan fixed its units (row groups, stripes) from the
        # footers at plan time, so a file rewritten in place must miss:
        # each path keys with its (mtime, size), as the scan cache does.
        return ("scan", plan.fmt, tuple(plan.paths),
                tuple(_file_stamp(p) for p in plan.paths),
                schema_fingerprint(plan.source_schema),
                tuple(sorted((str(k), repr(v))
                             for k, v in plan.options.items())),
                canonical_node(plan.predicates))
    if isinstance(plan, L.LogicalRange):
        return ("range", plan.start, plan.end, plan.step,
                plan.num_partitions)
    if isinstance(plan, L.LogicalFilter):
        return ("filter", canonical_node(plan.condition)) + kids
    if isinstance(plan, L.LogicalProject):
        return ("project", _canon_cols(plan.projections)) + kids
    if isinstance(plan, L.LogicalAggregate):
        return ("agg", plan.grouping, _canon_cols(plan.group_by),
                _canon_cols(plan.aggregates)) + kids
    if isinstance(plan, L.LogicalWindow):
        return ("window", _canon_cols(plan.exprs), plan.spec_key()) + kids
    if isinstance(plan, L.LogicalSort):
        return ("sort", tuple(canonical_node(o)
                              for o in plan.orders)) + kids
    if isinstance(plan, L.LogicalLimit):
        n = plan.n
        return ("limit",
                ("bindval", n.slot) if isinstance(n, BindValue)
                else int(n)) + kids
    if isinstance(plan, L.LogicalRepartition):
        return ("repart", plan.num_partitions,
                tuple(canonical_node(k) for k in (plan.keys or ()))) + kids
    if isinstance(plan, L.LogicalUnion):
        return ("union",) + kids
    if isinstance(plan, L.LogicalJoin):
        return ("join", plan.join_type, plan.strategy,
                tuple(canonical_node(k) for k in plan.left_keys),
                tuple(canonical_node(k) for k in plan.right_keys),
                None if plan.condition is None
                else canonical_node(plan.condition)) + kids
    # Generate and the pandas-UDF nodes carry opaque callables or shapes
    # this keyer does not model: refuse rather than guess.
    raise Uncacheable(plan.name)


def _conf_key(conf) -> Tuple:
    return tuple(sorted((k, repr(v)) for k, v in conf.raw.items()))


def _faults_armed(conf) -> bool:
    from spark_rapids_tpu_torch import faults
    if str(conf.get(C.TEST_FAULTS) or "").strip():
        return True
    if os.environ.get("SRT_FAULTS", "").strip():
        return True
    return faults.injector() is not None


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------

class PlanCacheEntry:
    __slots__ = ("template", "dtypes", "nbinds")

    def __init__(self, template, dtypes):
        self.template = template
        self.dtypes = tuple(dtypes)
        self.nbinds = len(self.dtypes)


class PlanCache:
    """Bounded LRU of physical plan templates keyed by parameterized
    structure, conf snapshot and device."""

    def __init__(self, max_entries: int = 256):
        self._entries: "collections.OrderedDict[Any, PlanCacheEntry]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def configure(self, max_entries: int) -> None:
        with self._lock:
            self.max_entries = max(int(max_entries), 1)
            self._evict()

    def lookup(self, key) -> Optional[PlanCacheEntry]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                _record("planCacheHits")
            else:
                self.misses += 1
                _record("planCacheMisses")
            return entry

    def insert(self, key, entry: PlanCacheEntry) -> PlanCacheEntry:
        """First writer wins: a concurrent planner of the same key keeps
        the stored template, so every caller shares one exec tree."""
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None:
                return existing
            self._entries[key] = entry
            self._evict()
            return entry

    def _evict(self) -> None:
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.evictions += 1
            _record("planCacheEvictions")

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "entries": len(self._entries)}

    def templates(self) -> list:
        """The cached templates, least recently used first."""
        with self._lock:
            return [e.template for e in self._entries.values()]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = self.misses = self.evictions = 0


_CACHE = PlanCache()


def cache() -> PlanCache:
    """The process-global plan cache."""
    return _CACHE


# ---------------------------------------------------------------------------
# Bound plans
# ---------------------------------------------------------------------------

class BoundPlan:
    """Execution view over a shared plan template plus THIS call's literal
    bindings: the ``df.prepare()`` prepared-statement handle. Attribute
    access falls through to the template (root, meta, conf, tree, ...);
    ``collect`` threads the bindings into the execution context."""

    def __init__(self, template, values, dtypes, cache_hit: bool):
        self.template = template
        self.bind_values = tuple(values)
        self.bind_dtypes = tuple(dtypes)
        self.cache_hit = bool(cache_hit)

    @property
    def provenance(self) -> str:
        return "plan-cache hit, bind-only" if self.cache_hit \
            else "plan-cache miss, template planned"

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "template"), name)

    def install(self, ctx) -> None:
        """Install the binding vector on a caller-built context (the
        funnels that do not go through ``collect``: the writer)."""
        ctx.cache["plan_binds"] = self.bind_values
        ctx.cache["plan_bind_dtypes"] = self.bind_dtypes

    def collect(self, ctx=None, timeout_ms=None, cancel_event=None,
                priority=None, tenant=None):
        """The template's ``collect`` with this call's bindings; the
        scheduler's arguments pass through, and the plan-cache outcome
        lands on the query's ``Scheduler@query`` entry."""
        if self.cache_hit:
            _record("bindOnlyExecutions")
        return self.template.collect(
            ctx, timeout_ms=timeout_ms, cancel_event=cancel_event,
            bindings=(self.bind_values, self.bind_dtypes),
            plan_cache_hit=self.cache_hit, priority=priority,
            tenant=tenant)

    def collect_batches(self, ctx=None, timeout_ms=None, cancel_event=None,
                        priority=None, tenant=None):
        if self.cache_hit:
            _record("bindOnlyExecutions")
        return self.template.collect_batches(
            ctx, bindings=(self.bind_values, self.bind_dtypes),
            timeout_ms=timeout_ms, cancel_event=cancel_event,
            plan_cache_hit=self.cache_hit, priority=priority,
            tenant=tenant)

    def explain(self, mode: str = "ALL") -> str:
        report = self.template.explain(mode)
        return (f"[{self.provenance}; "
                f"{len(self.bind_values)} bind slot(s)]\n{report}")


def plan_or_bind(conf, logical: LogicalPlan, device=None):
    """THE planning funnel behind ``DataFrame._physical``: parameterize,
    fingerprint, and either bind against a cached template (hit) or plan
    one on ``device`` and cache it (miss). Returns a :class:`BoundPlan`,
    or a plain ``PhysicalPlan`` when the cache is disabled, bypassed
    (armed faults), or the shape is uncacheable."""
    from spark_rapids_tpu_torch import monitoring, resolve_device
    from spark_rapids_tpu_torch.plan.planner import Planner
    if not plan_cache_enabled(conf):
        return Planner(conf, device).plan(logical)
    if _faults_armed(conf):
        _record("planCacheBypasses")
        return Planner(conf, device).plan(logical)
    t0 = time.perf_counter_ns()
    try:
        param, values, dtypes = parameterize(logical)
        key = (plan_key(param), _conf_key(conf),
               str(resolve_device(device)))
        hash(key)
    except (Uncacheable, TypeError):
        _record("planCacheUncacheable")
        return Planner(conf, device).plan(logical)
    _CACHE.configure(int(conf.get(C.PLAN_CACHE_MAX_ENTRIES)))
    entry = _CACHE.lookup(key)
    hit = entry is not None
    if not hit:
        entry = _CACHE.insert(
            key, PlanCacheEntry(Planner(conf, device).plan(param), dtypes))
    dur = time.perf_counter_ns() - t0
    _record("planBindNs", dur)
    if monitoring.enabled():
        monitoring.record_span(
            "plan-bind", "planning", monitoring.now_ns() - dur, dur,
            args={"planCacheHit": hit, "bindSlots": len(values)},
            level=monitoring.LEVEL_QUERY)
        monitoring.instant(
            "plan-cache-hit" if hit else "plan-cache-miss", "planning",
            args={"bindSlots": len(values)})
    return BoundPlan(entry.template, values, dtypes, hit)
