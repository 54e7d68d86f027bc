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

``TpuSession(device=None)`` runs on the CUDA card and raises when there is
none; ``device="cpu"`` runs the plain-PyTorch path. ``read`` (file scans)
is not ported.
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
        of LogicalWindow nodes first (Spark's ExtractWindowExpressions)."""
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
        """Plan once per conf version (no plan cache: the reference's
        parameterized plan cache is not ported)."""
        key = self._session.conf.version
        cached = getattr(self, "_phys_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        phys = Planner(self._session.conf, self._session.device).plan(
            self._plan)
        self._phys_cache = (key, phys)
        return phys

    def collect(self) -> List[tuple]:
        return self._physical().collect()

    def collect_host(self) -> List[tuple]:
        """Run entirely on the host engine (the CPU oracle): the plan
        re-planned with ``spark.rapids.sql.enabled`` false, so every node
        is on the host and there is no bridge."""
        host_conf = C.TpuConf(dict(self._session.conf.raw))
        host_conf.set("spark.rapids.sql.enabled", False)
        return Planner(host_conf, self._session.device).plan(
            self._plan).collect()

    def count_rows(self) -> int:
        return len(self.collect())

    def explain(self, mode: str = "ALL") -> str:
        report = self._physical().explain(mode)
        print(report)
        return report
