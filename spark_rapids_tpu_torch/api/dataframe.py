"""DataFrame API front end (port of the JAX package's ``api/dataframe.py``;
shapes mirror pyspark.sql).

``TpuSession`` is the SparkSession analog: it holds the conf and the
device, builds DataFrames from memory and from ``range``, and plans
queries through the tag -> convert rewrite (plan/planner.py).
``DataFrame.collect`` runs the plan, each node on the engine its tags
give it (the session's device, or the numpy host engine for a node the
reference would keep on the host); ``DataFrame.collect_host`` runs the
whole plan on the host engine, the CPU oracle; ``DataFrame.explain``
prints the will/will-not-run report. A query holding something the port
has not ported is refused when it is planned (``NotImplementedError``).

Python UDFs (``udf``, spark_rapids_tpu_torch.udf) are Columns like any
other. ``map_in_pandas``, ``group_by(...).apply_in_pandas`` /
``agg_in_pandas`` / ``cogroup(...).apply_in_pandas`` and ``to_pandas``
need pandas, imported when they run (the port imports without it).

``TpuSession.read`` (``DataFrameReader``: ``option``, ``parquet``, ``orc``,
``csv``) scans files (``io/scan.py``) and ``DataFrame.write``
(``io/writer.py`` ``DataFrameWriter``) writes them; pyarrow is imported
when they run. ``TpuSession.ingest_spark_plan`` runs a captured Spark
physical plan's text against local files (``plan/spark_ingest.py``).

``TpuSession(device=None)`` runs on the CUDA card and raises when there is
none; ``device="cpu"`` runs the plain-PyTorch path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from spark_rapids_tpu_torch import DeviceLike, config as C, resolve_device
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.logical import Column, col
from spark_rapids_tpu_torch.plan.planner import Planner


class TpuSession:
    """Session: conf + device + DataFrame builders (SparkSession
    analog)."""

    def __init__(self, conf: Optional[Dict] = None,
                 device: DeviceLike = None):
        self.conf = C.TpuConf(conf)
        self.device = resolve_device(device)

    # -- conf ----------------------------------------------------------------
    def set(self, key: str, value) -> "TpuSession":
        self.conf.set(key, value)
        return self

    # -- builders ------------------------------------------------------------
    def create_dataframe(self, data: Union[Dict, List[tuple]],
                         schema: Sequence[Tuple[str, dt.DataType]],
                         num_partitions: int = 1) -> "DataFrame":
        """A DataFrame over ``data`` split into ``num_partitions`` row
        ranges: a dict of column -> values or a list of rows, as in the
        reference, or a dict of column -> numpy array, built straight
        into host batches (fixed-width columns only; no nulls)."""
        schema = tuple(schema)
        if isinstance(data, dict) and data and all(
                isinstance(data[n], np.ndarray) for n, _ in schema):
            return DataFrame(self, L.InMemoryScan(
                schema, _numpy_partitions(data, schema, num_partitions)))
        if isinstance(data, dict):
            rows = list(zip(*[data[n] for n, _ in schema])) \
                if data else []
        else:
            rows = list(data)
        per = max(1, -(-len(rows) // num_partitions)) if rows else 1
        parts = []
        for i in range(num_partitions):
            chunk = rows[i * per:(i + 1) * per]
            cols = {n: [r[ci] for r in chunk]
                    for ci, (n, _) in enumerate(schema)}
            parts.append([HostBatch.from_pydict(schema, cols)])
        return DataFrame(self, L.InMemoryScan(schema, parts))

    def range(self, start: int, end: Optional[int] = None, step: int = 1,
              num_partitions: int = 1) -> "DataFrame":
        """A DataFrame of one INT64 column ``id``: ``start``, ``start +
        step``, ... up to ``end`` exclusive (``range(n)`` is ``0 .. n-1``),
        in ``num_partitions`` contiguous row ranges."""
        if end is None:
            start, end = 0, start
        return DataFrame(self, L.LogicalRange(start, end, step,
                                              num_partitions))

    def ingest_spark_plan(self, plan_text: str, table_paths):
        """Plugin mode: parse a captured Spark physical plan (the text of
        ``df.explain()`` on a cluster) and run it here. ``table_paths``
        maps table names (matched against the captured scan locations)
        to local data paths. See plan/spark_ingest.py."""
        from spark_rapids_tpu_torch.plan.spark_ingest import \
            ingest_spark_plan
        return ingest_spark_plan(plan_text, self, table_paths)

    @property
    def read(self) -> "DataFrameReader":
        return DataFrameReader(self)


class DataFrameReader:
    """``session.read``: file scans with reader options (CSV ``sep`` /
    ``header``). The schema comes from the first file's footer or
    header."""

    def __init__(self, session: TpuSession):
        self._session = session
        self._options: Dict = {}

    def option(self, key: str, value) -> "DataFrameReader":
        self._options[key] = value
        return self

    def _scan(self, fmt: str, paths) -> "DataFrame":
        from spark_rapids_tpu_torch.io.scan import infer_schema
        if isinstance(paths, str):
            paths = [paths]
        schema = infer_schema(fmt, paths, self._options)
        return DataFrame(self._session,
                         L.FileScan(fmt, list(paths), schema,
                                    dict(self._options)))

    def parquet(self, *paths) -> "DataFrame":
        return self._scan("parquet", list(paths))

    def csv(self, *paths) -> "DataFrame":
        return self._scan("csv", list(paths))

    def orc(self, *paths) -> "DataFrame":
        return self._scan("orc", list(paths))


def _numpy_partitions(data: Dict[str, np.ndarray], schema,
                      num_partitions: int) -> List[List[HostBatch]]:
    n = len(data[schema[0][0]])
    per = max(1, -(-n // num_partitions)) if n else 1
    parts = []
    for i in range(num_partitions):
        lo, hi = min(i * per, n), min((i + 1) * per, n)
        cols = []
        for name, t in schema:
            if t.is_string:
                raise TypeError(f"column {name!r}: numpy input takes "
                                "fixed-width columns; pass strings as "
                                "python values")
            v = np.ascontiguousarray(data[name][lo:hi], dtype=t.np_dtype)
            cols.append(HostColumn(t, v, np.ones(hi - lo, np.bool_)))
        parts.append([HostBatch(tuple(n for n, _ in schema), cols)])
    return parts


class GroupedData:
    def __init__(self, df: "DataFrame", keys: Sequence[Union[str, Column]],
                 grouping: Optional[str] = None):
        self._df = df
        self._keys = [(k, col(k)) if isinstance(k, str)
                      else (k.name_hint, k) for k in keys]
        self._grouping = grouping

    def agg(self, *aggs: Column, **named: Column) -> "DataFrame":
        specs = []
        for a in aggs:
            specs.append((self._agg_name(a), a))
        for name, a in named.items():
            specs.append((name, a))
        plan = L.LogicalAggregate(self._df._plan, self._keys, specs,
                                  grouping=self._grouping)
        return DataFrame(self._df._session, plan)

    @staticmethod
    def _agg_name(a: Column) -> str:
        node = a.node
        if node[0] == "alias":
            return node[2]
        if node[0] == "agg":
            kind = node[1]
            child = node[2]
            base = child.name_hint if child is not None else "1"
            return f"{kind}({base})"
        return node[0]

    def count(self) -> "DataFrame":
        return self.agg(L.agg_count().alias("count"))

    # -- pandas-UDF flavors (GpuFlatMapGroupsInPandasExec family) ---------
    def _key_names(self) -> List[str]:
        names = []
        for hint, c in self._keys:
            if c.node[0] != "ref":
                raise ValueError(
                    "pandas group flavors need plain column-name keys")
            names.append(c.node[1])
        return names

    def apply_in_pandas(self, fn, schema) -> "DataFrame":
        """fn(group: pandas.DataFrame) -> pandas.DataFrame, one call per
        group (Spark applyInPandas; GpuFlatMapGroupsInPandasExec)."""
        plan = L.LogicalGroupedMapInPandas(
            self._df._plan, self._key_names(), fn, tuple(schema))
        return DataFrame(self._df._session, plan)

    applyInPandas = apply_in_pandas

    def agg_in_pandas(self, **named) -> "DataFrame":
        """GROUPED_AGG pandas UDFs: each kwarg is
        ``out_name=(input_column, series_fn, result_type)`` where
        series_fn(pandas.Series) -> scalar (GpuAggregateInPandasExec)."""
        aggs = [(out, colname, fn, t)
                for out, (colname, fn, t) in named.items()]
        plan = L.LogicalAggInPandas(self._df._plan, self._key_names(),
                                    aggs)
        return DataFrame(self._df._session, plan)

    def cogroup(self, other: "GroupedData") -> "CoGroupedData":
        return CoGroupedData(self, other)


class CoGroupedData:
    """Pair of grouped frames for cogrouped pandas application
    (Spark's PandasCogroupedOps; GpuCoGroupedMapInPandasExec)."""

    def __init__(self, left: GroupedData, right: GroupedData):
        self._left = left
        self._right = right

    def apply_in_pandas(self, fn, schema) -> "DataFrame":
        """fn(left_group: pdf, right_group: pdf) -> pdf per key in the
        union of both sides' key sets (absent side = empty frame)."""
        plan = L.LogicalCoGroupedMapInPandas(
            self._left._df._plan, self._right._df._plan,
            self._left._key_names(), self._right._key_names(),
            fn, tuple(schema))
        return DataFrame(self._left._df._session, plan)

    applyInPandas = apply_in_pandas


class DataFrame:
    """A logical plan bound to a session. ``DataFrame(session,
    L.InMemoryScan(schema, partitions))`` serves a table already split
    into partitions of host batches."""

    def __init__(self, session: TpuSession, plan: L.LogicalPlan):
        self._session = session
        self._plan = plan

    # -- schema ---------------------------------------------------------------
    @property
    def schema(self):
        return self._plan.schema

    @property
    def columns(self) -> List[str]:
        return [n for n, _ in self.schema]

    # -- transformations ------------------------------------------------------
    def filter(self, condition: Column) -> "DataFrame":
        return DataFrame(self._session,
                         L.LogicalFilter(self._plan, condition))

    where = filter

    def _project(self, projections) -> "DataFrame":
        """Build a projection, extracting window expressions into a chain
        of LogicalWindow nodes first (Spark's ExtractWindowExpressions),
        and generate expressions (``explode(...)``) into LogicalGenerate
        nodes whose element (and ``{name}__pos``) columns it reads."""
        plan = self._plan
        out = []
        for i, (name, c) in enumerate(projections):
            if L.is_window_column(c):
                node = c.node
                while node[0] == "alias":
                    node = node[1].node
                _, fn_col, windef = node
                tmp = f"__window_{i}_{name}"
                plan = L.LogicalWindow(plan, [(tmp, fn_col)], windef)
                out.append((name, col(tmp)))
            elif L.is_generate_column(c):
                node = c.node
                while node[0] == "alias":
                    node = node[1].node
                _, elements, position, outer = node
                plan = L.LogicalGenerate(plan, name, list(elements),
                                         position, outer)
                if position:
                    out.append((f"{name}__pos", col(f"{name}__pos")))
                out.append((name, col(name)))
            else:
                out.append((name, c))
        return DataFrame(self._session, L.LogicalProject(plan, out))

    def select(self, *cols_: Union[str, Column]) -> "DataFrame":
        projections = []
        for c in cols_:
            if isinstance(c, str):
                projections.append((c, col(c)))
            else:
                projections.append((c.name_hint, c))
        return self._project(projections)

    def with_column(self, name: str, c: Column) -> "DataFrame":
        # Replace in place like pyspark's withColumn; append when new.
        if name in self.columns:
            projections = [(n, c if n == name else col(n))
                           for n in self.columns]
        else:
            projections = [(n, col(n)) for n in self.columns]
            projections.append((name, c))
        return self._project(projections)

    withColumn = with_column

    def map_in_pandas(self, fn, schema) -> "DataFrame":
        """fn(iterator of pandas DataFrames) -> iterator of DataFrames
        (Spark mapInPandas; GpuMapInPandasExec analog)."""
        plan = L.LogicalMapInPandas(self._plan, fn, tuple(schema))
        return DataFrame(self._session, plan)

    mapInPandas = map_in_pandas

    def group_by(self, *keys: Union[str, Column]) -> GroupedData:
        return GroupedData(self, keys)

    groupBy = group_by

    def rollup(self, *keys: Union[str, Column]) -> GroupedData:
        """GROUP BY ROLLUP: hierarchical subtotals via ExpandExec."""
        return GroupedData(self, keys, grouping="rollup")

    def cube(self, *keys: Union[str, Column]) -> GroupedData:
        """GROUP BY CUBE: all key-subset subtotals via ExpandExec."""
        return GroupedData(self, keys, grouping="cube")

    def agg(self, *aggs: Column, **named: Column) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs, **named)

    def order_by(self, *orders: Union[str, Column]) -> "DataFrame":
        os_ = [col(o) if isinstance(o, str) else o for o in orders]
        return DataFrame(self._session, L.LogicalSort(self._plan, os_))

    orderBy = order_by
    sort = order_by

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self._session, L.LogicalLimit(self._plan, n))

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL by position (Spark's ``union``): the partitions of
        ``self``, then those of ``other``."""
        return DataFrame(self._session,
                         L.LogicalUnion(self._plan, other._plan))

    unionAll = union

    def repartition(self, n: int, *keys: Union[str, Column]) -> "DataFrame":
        """Hash-repartition into ``n`` partitions on ``keys``, or
        round-robin without keys."""
        ks = [col(k) if isinstance(k, str) else k for k in keys] or None
        return DataFrame(self._session,
                         L.LogicalRepartition(self._plan, n, ks))

    def join(self, other: "DataFrame", on: Union[str, Sequence[str], tuple],
             how: str = "inner", condition: Optional[Column] = None,
             strategy: str = "auto") -> "DataFrame":
        if isinstance(on, str):
            on = [on]
        lkeys = [col(k) if isinstance(k, str) else k for k in on]
        rkeys = list(lkeys)
        plan = L.LogicalJoin(self._plan, other._plan, lkeys, rkeys,
                             how, condition, strategy)
        return DataFrame(self._session, plan)

    def join_on(self, other: "DataFrame",
                left_on: Sequence[Union[str, Column]],
                right_on: Sequence[Union[str, Column]],
                how: str = "inner", condition: Optional[Column] = None,
                strategy: str = "auto") -> "DataFrame":
        lkeys = [col(k) if isinstance(k, str) else k for k in left_on]
        rkeys = [col(k) if isinstance(k, str) else k for k in right_on]
        plan = L.LogicalJoin(self._plan, other._plan, lkeys, rkeys,
                             how, condition, strategy)
        return DataFrame(self._session, plan)

    # -- actions --------------------------------------------------------------
    def cross_join(self, other: "DataFrame") -> "DataFrame":
        plan = L.LogicalJoin(self._plan, other._plan, [], [], "cross")
        return DataFrame(self._session, plan)

    crossJoin = cross_join

    def _physical(self):
        """Plan once per conf version, through the process-global
        parameterized plan cache (``plan/plan_cache.py``), which also
        shares planned templates ACROSS DataFrames of the same shape: a
        repeated query with new literals binds them against the cached
        template instead of re-planning (a ``BoundPlan``; a plain
        ``PhysicalPlan`` where the cache is off or the shape
        uncacheable)."""
        key = self._session.conf.version
        cached = getattr(self, "_phys_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        from spark_rapids_tpu_torch.plan.plan_cache import plan_or_bind
        phys = plan_or_bind(self._session.conf, self._plan,
                            self._session.device)
        self._phys_cache = (key, phys)
        return phys

    def prepare(self):
        """The prepared-statement handle: plan now (or bind against the
        plan cache) and return the bound plan, whose ``collect()`` and
        ``explain()`` skip all planning and whose ``cache_hit`` and
        ``bind_values`` show the plan-cache provenance."""
        return self._physical()

    def collect(self, timeout_ms: Optional[float] = None,
                priority: Optional[str] = None,
                tenant: Optional[str] = None) -> List[tuple]:
        """Run the query through the multi-query scheduler
        (``parallel/scheduler.py``) and return its rows. ``timeout_ms``
        arms a deadline: a query still running when it expires unwinds at
        its next checkpoint with ``QueryCancelledError`` (reason "deadline
        exceeded"), releasing its device permit and every buffer it owns.
        Raises ``QueryRejectedError`` when the run queue is full or the
        admission wait times out.

        With QoS on (``scheduler.qos.enabled``), ``priority`` picks the
        query's class ("interactive" / "batch" / "background"), ``tenant``
        tags it for the per-tenant quotas, and ``timeout_ms`` is also the
        deadline admission tests the cost estimate against (the port's
        queries are un-priced, so they pass). Both default from the conf
        (``qos.priorityClass`` / ``qos.tenant``)."""
        return self._physical().collect(timeout_ms=timeout_ms,
                                        priority=priority, tenant=tenant)

    def collect_with_retry(self, timeout_ms: Optional[float] = None,
                           priority: Optional[str] = None,
                           tenant: Optional[str] = None,
                           max_attempts: Optional[int] = None,
                           max_backoff_ms: Optional[float] = None,
                           seed: int = 0) -> List[tuple]:
        """:meth:`collect` behind the client's backpressure loop
        (``parallel/scheduler.py`` ``collect_with_retry``): a
        ``QueryRejectedError`` with a ``retry_after_ms`` hint backs off
        for the hint (deterministic jitter from ``seed``, capped at
        ``client.retry.maxBackoffMs``) and resubmits, up to
        ``client.retry.maxAttempts`` attempts; a rejection without a hint
        re-raises at once."""
        from spark_rapids_tpu_torch.parallel import scheduler as SC
        return SC.collect_with_retry(
            lambda: self.collect(timeout_ms=timeout_ms,
                                 priority=priority, tenant=tenant),
            conf=self._session.conf, max_attempts=max_attempts,
            max_backoff_ms=max_backoff_ms, seed=seed)

    def submit(self, timeout_ms: Optional[float] = None,
               priority: Optional[str] = None,
               tenant: Optional[str] = None):
        """Async collect: a ``QueryHandle`` whose ``cancel()`` stops the
        query cooperatively, while it is queued or running, and whose
        ``result()`` returns the rows or re-raises the query's error.
        ``priority`` / ``tenant`` as in :meth:`collect`."""
        from spark_rapids_tpu_torch.parallel.scheduler import QueryHandle
        phys = self._physical()

        def run(cancel_event, tmo):
            return phys.collect(timeout_ms=tmo, cancel_event=cancel_event,
                                priority=priority, tenant=tenant)

        return QueryHandle(run, timeout_ms)

    def collect_host(self) -> List[tuple]:
        """Run entirely on the host engine (the CPU oracle): the plan
        re-planned with ``spark.rapids.sql.enabled`` false, so every node
        is on the host and there is no bridge."""
        return self._host_physical().collect()

    def count_rows(self) -> int:
        return len(self.collect())

    def to_pandas(self):
        """``collect``'s rows as a pandas DataFrame (pandas must be
        installed)."""
        import pandas as pd
        rows = self.collect()
        return pd.DataFrame(rows, columns=self.columns)

    @property
    def write(self):
        """A ``DataFrameWriter`` (io/writer.py) over this DataFrame."""
        from spark_rapids_tpu_torch.io.writer import DataFrameWriter
        return DataFrameWriter(self)

    def _host_physical(self):
        """The plan with ``spark.rapids.sql.enabled`` false: every node on
        the host engine (what a write whose gate is off runs)."""
        host_conf = C.TpuConf(dict(self._session.conf.raw))
        host_conf.set("spark.rapids.sql.enabled", False)
        return Planner(host_conf, self._session.device).plan(self._plan)

    def explain(self, mode: str = "ALL") -> str:
        report = self._physical().explain(mode)
        print(report)
        return report

    def explain_analyze(self) -> str:
        """The plan tree annotated with OBSERVED per-operator rows, bytes,
        wall-ms and batches, with the audit entries and (when tracing was
        on) the span-category breakdown in the footer
        (``monitoring/analyze.py``). Reads the LAST collect of this
        DataFrame's plan; collects once if none ran yet."""
        phys = self._physical()
        if getattr(phys, "last_ctx", None) is None:
            self.collect()
        from spark_rapids_tpu_torch.monitoring.analyze import render
        report = render(phys, getattr(phys, "last_ctx", None))
        # Plan provenance: a cache-hit (bind-only) execution must not
        # silently look identical to a freshly planned one.
        prov = getattr(phys, "provenance", None)
        if prov:
            report = f"[{prov}]\n{report}"
        print(report)
        return report

    def trace_export(self, path: Optional[str] = None) -> dict:
        """Export the flight recorder's Chrome trace-event JSON (loads in
        Perfetto / chrome://tracing): one track per query, this
        DataFrame's last collect and whatever else ran, and one per
        thread. Needs ``spark.rapids.sql.trace.enabled`` (or SRT_TRACE=1)
        during the collect; returns the trace document and writes it to
        ``path`` when given."""
        from spark_rapids_tpu_torch import monitoring
        return monitoring.export_chrome(path)

    _METRIC_LEVELS = {
        "ESSENTIAL": {"numOutputRows", "totalTime"},
        "MODERATE": {"numOutputRows", "totalTime", "numOutputBatches",
                     "shuffleTime", "bufferTime"},
    }

    def metrics(self):
        """Per-operator metrics of the LAST collect of this DataFrame's
        plan (GpuExec.scala:27-56 registry; empty before any action).
        ``spark.rapids.sql.metrics.level`` filters verbosity; the audit
        entries (``ops/base.py`` ``audit_metric_groups``: Recovery@query,
        Pipeline@query) keep every counter. A plan-cache template's
        DataFrames share it: each shows whichever collected last."""
        phys = self._physical()
        ctx = getattr(phys, "last_ctx", None)
        if ctx is None:
            return {}
        level = str(self._session.conf.get(C.METRICS_LEVEL)).upper()
        keep = self._METRIC_LEVELS.get(level)
        from spark_rapids_tpu_torch.ops.base import audit_metric_groups
        exempt = audit_metric_groups()
        return {k: {name: v for name, v in m.values.items()
                    if keep is None or name in keep
                    or m.owner in exempt}
                for k, m in ctx.metrics.items()}
