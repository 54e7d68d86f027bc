"""Entry points of the port: the flagship q1-shaped step and TPC-H q1, q3
and q4.

- ``entry(device=None)`` mirrors the JAX package's
  ``__graft_entry__.entry()``: a q1-shaped forward step (filter -> hash
  aggregate update -> merge -> finalize) over the 4096-row
  ``make_host_batch`` table, returned as ``(forward, example_args)``.
- ``tpch_q1_plan(partitions, device=None)`` builds TPC-H Q1 (pricing
  summary report) as an exec tree: scan -> filter -> project -> partial
  hash aggregate -> coalesce to one partition -> final hash aggregate ->
  sort. ``tpch_q1_host_batches`` makes its LINEITEM columns with numpy,
  by the formulas and random stream of the JAX package's TPC-H generator
  (``benchmarks/tpch.py`` ``generate``), so the same seed and scale give
  the same rows.
- ``tpch_q3_plan(tables, device=None)`` (shipping priority: two broadcast
  hash joins, aggregate, top 10 by revenue) and ``tpch_q4_plan`` (order
  priority checking: a left-semi broadcast hash join, count, sort) build
  the exec trees the JAX package's planner builds for ``tpch.q3`` and
  ``tpch.q4`` at SF1 with default conf; ``tpch_q3_tables`` and
  ``tpch_q4_tables`` split ``tpch_columns`` into their scans' partitions.

``device=None`` means the CUDA card and raises when there is none; pass
``device="cpu"`` for the plain-PyTorch path.
"""

from __future__ import annotations

import datetime
from typing import List, Sequence

import numpy as np

from spark_rapids_tpu_torch import DeviceLike, resolve_device
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.host import (
    HostBatch, HostColumn, host_to_device)
from spark_rapids_tpu_torch.exprs import (
    Add, And, BoundReference as Ref, EqualTo, GreaterThan,
    GreaterThanOrEqual, LessThan, LessThanOrEqual, Literal, Multiply,
    Subtract, lit)
from spark_rapids_tpu_torch.exprs.base import as_device_column
from spark_rapids_tpu_torch.ops import (
    AggSpec, Average, BroadcastHashJoinExec, CoalescePartitionsExec,
    CountStar, FilterExec, GlobalLimitExec, HashAggregateExec,
    InMemorySourceExec, LocalLimitExec, ProjectExec, SortExec, SortOrder,
    Sum)

# ---------------------------------------------------------------------------
# The flagship q1-shaped step
# ---------------------------------------------------------------------------

ENTRY_SCHEMA = (("flag", dt.INT32), ("status", dt.INT32),
                ("qty", dt.INT64), ("price", dt.FLOAT64))


def make_host_batch(n_rows: int, seed: int = 0) -> HostBatch:
    """The flagship workload's synthetic table (same generator calls as
    the JAX package's ``__graft_entry__.make_host_batch``)."""
    rng = np.random.default_rng(seed)
    return HostBatch.from_pydict(
        ENTRY_SCHEMA,
        {"flag": rng.integers(0, 3, n_rows).tolist(),
         "status": rng.integers(0, 2, n_rows).tolist(),
         "qty": rng.integers(1, 50, n_rows).tolist(),
         "price": (rng.random(n_rows) * 1000).tolist()})


def _q1_agg_exec(device) -> HashAggregateExec:
    src = InMemorySourceExec(ENTRY_SCHEMA, [[]], device=device)
    return HashAggregateExec(
        src,
        [("flag", Ref(0, dt.INT32)), ("status", Ref(1, dt.INT32))],
        [AggSpec("sum_qty", Sum(Ref(2, dt.INT64))),
         AggSpec("sum_price", Sum(Ref(3, dt.FLOAT64))),
         AggSpec("avg_qty", Average(Ref(2, dt.INT64))),
         AggSpec("count", CountStar(None))])


def entry(device: DeviceLike = None):
    """(forward, example_args): the q1-shaped forward step."""
    dev = resolve_device(device)
    agg = _q1_agg_exec(dev)

    def forward(batch):
        # filter: qty <= 45
        cond = as_device_column(
            LessThanOrEqual(Ref(2, dt.INT64), lit(45)).eval(batch), batch)
        filtered = batch.compact(cond.data & cond.validity)
        partial = agg._update_batch(filtered, 0)
        return agg._finalize_batch(agg._merge_batch(partial))

    example = host_to_device(make_host_batch(4096), device=dev)
    return forward, (example,)


# ---------------------------------------------------------------------------
# TPC-H Q1
# ---------------------------------------------------------------------------

_EPOCH = datetime.date(1970, 1, 1)


def days(date_str: str) -> int:
    """'YYYY-MM-DD' -> days since epoch (Spark DateType physical value)."""
    y, m, d = map(int, date_str.split("-"))
    return (datetime.date(y, m, d) - _EPOCH).days


Q1_SCHEMA = (("l_quantity", dt.FLOAT64), ("l_extendedprice", dt.FLOAT64),
             ("l_discount", dt.FLOAT64), ("l_tax", dt.FLOAT64),
             ("l_returnflag", dt.STRING), ("l_linestatus", dt.STRING),
             ("l_shipdate", dt.DATE))

Q1_SHIPDATE_CUTOFF = days("1998-09-02")


# The generator's string pools that the ported queries read, in its order
# (the JAX package's ``benchmarks/tpch.py`` PRIORITIES and SEGMENTS).
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
# Sizes of its other ``pick`` pools: only how many values a draw may take
# matters to the random stream.
_N_O_COMMENTS, _N_SHIPMODES, _N_SHIPINSTRUCT = 14, 7, 4
_N_P_WORDS, _N_P_TYPES, _N_P_CONTAINERS = 92, (6, 5, 5), (5, 8)


def tpch_columns(scale: float, seed: int = 0) -> dict:
    """The columns TPC-H q1, q3 and q4 read, as numpy arrays per table
    (``{"lineitem": {...}, "orders": {...}, "customer": {...}}``): the
    JAX package's TPC-H generator (``benchmarks/tpch.py`` ``generate``),
    drawing its whole random stream in its order, so ``seed`` and
    ``scale`` give its rows. String columns are codes: ``l_returnflag`` and
    ``l_linestatus`` are uint8 character codes, ``o_orderpriority`` and
    ``c_mktsegment`` index ``PRIORITIES`` and ``SEGMENTS``."""
    rng = np.random.default_rng(seed)
    n_ord = max(int(1_500_000 * scale), 10)
    n_cust = max(int(150_000 * scale), 5)
    n_part = max(int(200_000 * scale), 8)
    # ORDERS: custkey, orderdate, status coin, totalprice, priority, comment.
    o_orderkey = np.arange(1, n_ord + 1, dtype=np.int64)
    o_custkey = rng.integers(1, max(n_cust * 2 // 3, 2), n_ord,
                             dtype=np.int64)
    o_orderdate = rng.integers(days("1992-01-01"), days("1998-08-02"),
                               n_ord, dtype=np.int64).astype(np.int32)
    rng.integers(0, 2, n_ord)
    rng.uniform(900.0, 500_000.0, n_ord)
    o_orderpriority = rng.integers(0, len(PRIORITIES), n_ord)
    rng.integers(0, _N_O_COMMENTS, n_ord)
    # LINEITEM: 1..7 lines per order.
    per_order = rng.integers(1, 8, n_ord)
    l_orderkey = np.repeat(o_orderkey, per_order)
    l_orderdate = np.repeat(o_orderdate, per_order)
    n_li = len(l_orderkey)
    l_quantity = rng.integers(1, 51, n_li).astype(np.float64)
    l_extendedprice = np.round(rng.uniform(900.0, 105_000.0, n_li), 2)
    l_discount = rng.integers(0, 11, n_li).astype(np.float64) / 100.0
    l_tax = rng.integers(0, 9, n_li).astype(np.float64) / 100.0
    l_shipdate = (l_orderdate.astype(np.int64)
                  + rng.integers(1, 122, n_li)).astype(np.int32)
    l_commitdate = (l_orderdate.astype(np.int64)
                    + rng.integers(30, 91, n_li)).astype(np.int32)
    l_receiptdate = (l_shipdate.astype(np.int64)
                     + rng.integers(1, 31, n_li)).astype(np.int32)
    cutoff = days("1995-06-17")
    ra = rng.integers(0, 2, n_li)
    returnflag = np.where(l_receiptdate <= cutoff,
                          np.where(ra == 0, ord("A"), ord("R")), ord("N"))
    linestatus = np.where(l_shipdate > cutoff, ord("O"), ord("F"))
    rng.integers(1, n_part + 1, n_li, dtype=np.int64)      # partkey
    rng.integers(0, 4, n_li)                                # suppkey offset
    rng.integers(0, _N_SHIPMODES, n_li)
    rng.integers(0, _N_SHIPINSTRUCT, n_li)
    # PART: name words, type, container, brand, size, retail price.
    for n in (_N_P_WORDS,) * 3 + _N_P_TYPES + _N_P_CONTAINERS:
        rng.integers(0, n, n_part)
    rng.integers(1, 6, n_part)
    rng.integers(1, 6, n_part)
    rng.integers(1, 51, n_part)
    rng.uniform(900.0, 2000.0, n_part)
    # PARTSUPP: 4 suppliers a part; availqty, supplycost.
    rng.integers(1, 10_000, 4 * n_part)
    rng.uniform(1.0, 1000.0, 4 * n_part)
    # CUSTOMER: nationkey, phone parts, then the market segment.
    rng.integers(0, 25, n_cust, dtype=np.int64)
    rng.integers(100, 1000, n_cust)
    rng.integers(100, 1000, n_cust)
    rng.integers(1000, 10000, n_cust)
    c_mktsegment = rng.integers(0, len(SEGMENTS), n_cust)
    return {
        "lineitem": {
            "l_orderkey": l_orderkey, "l_quantity": l_quantity,
            "l_extendedprice": l_extendedprice, "l_discount": l_discount,
            "l_tax": l_tax, "l_returnflag": returnflag.astype(np.uint8),
            "l_linestatus": linestatus.astype(np.uint8),
            "l_shipdate": l_shipdate, "l_commitdate": l_commitdate,
            "l_receiptdate": l_receiptdate},
        "orders": {
            "o_orderkey": o_orderkey, "o_custkey": o_custkey,
            "o_orderdate": o_orderdate,
            "o_shippriority": np.zeros(n_ord, np.int32),
            "o_orderpriority": o_orderpriority},
        "customer": {
            "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
            "c_mktsegment": c_mktsegment},
    }


def tpch_q1_columns(scale: float, seed: int = 0) -> dict:
    """LINEITEM's q1 columns (``tpch_columns``); flags are ``(n,)`` uint8
    character codes."""
    li = tpch_columns(scale, seed)["lineitem"]
    return {name: li[name] for name, _ in Q1_SCHEMA}


# String columns held as codes into a pool; the others are uint8
# character codes (one-byte strings).
_STRING_POOLS = {"o_orderpriority": PRIORITIES, "c_mktsegment": SEGMENTS}


def _pool_matrix(pool) -> tuple:
    w = max(len(v) for v in pool)
    m = np.zeros((len(pool), w), np.uint8)
    for i, v in enumerate(pool):
        m[i, :len(v)] = np.frombuffer(v.encode(), np.uint8)
    return m, np.array([len(v) for v in pool], np.int32)


def _host_batch(schema, cols: dict, lo: int, hi: int) -> HostBatch:
    n = hi - lo
    out = []
    for name, t in schema:
        v = cols[name][lo:hi]
        valid = np.ones(n, np.bool_)
        if t.is_string:
            if name in _STRING_POOLS:
                m, lens = _pool_matrix(_STRING_POOLS[name])
                out.append(HostColumn(t, None, valid, str_matrix=m[v],
                                      str_lengths=lens[v]))
            else:
                out.append(HostColumn(t, None, valid,
                                      str_matrix=v.reshape(n, 1).copy(),
                                      str_lengths=np.ones(n, np.int32)))
        else:
            out.append(HostColumn(t, v.copy(), valid))
    return HostBatch(tuple(n for n, _ in schema), out)


def table_partitions(cols: dict, schema,
                     partitions: int) -> List[List[HostBatch]]:
    """A table's ``schema`` columns split into ``partitions`` row ranges,
    one host batch each (the generator's ``files_per_table`` split)."""
    n = len(cols[schema[0][0]])
    per = max(1, -(-n // partitions))
    parts = []
    for i in range(partitions):
        lo, hi = min(i * per, n), min((i + 1) * per, n)
        if hi == lo and i > 0:
            break
        parts.append([_host_batch(schema, cols, lo, hi)])
    return parts


def tpch_q1_host_batches(scale: float, partitions: int = 8,
                         seed: int = 0) -> List[List[HostBatch]]:
    """LINEITEM's q1 columns split into ``partitions`` row ranges, one
    host batch each (the generator's ``files_per_table`` split)."""
    return table_partitions(tpch_q1_columns(scale, seed), Q1_SCHEMA,
                            partitions)


def q1_aggregates() -> List[AggSpec]:
    """Q1's aggregates over the projected columns
    [returnflag, linestatus, quantity, extendedprice, discount,
    disc_price, charge]."""
    f = dt.FLOAT64
    return [AggSpec("sum_qty", Sum(Ref(2, f))),
            AggSpec("sum_base_price", Sum(Ref(3, f))),
            AggSpec("sum_disc_price", Sum(Ref(5, f))),
            AggSpec("sum_charge", Sum(Ref(6, f))),
            AggSpec("avg_qty", Average(Ref(2, f))),
            AggSpec("avg_price", Average(Ref(3, f))),
            AggSpec("avg_disc", Average(Ref(4, f))),
            AggSpec("count_order", CountStar(None))]


def tpch_q1_plan(partitions: Sequence[Sequence[HostBatch]],
                 device: DeviceLike = None) -> SortExec:
    """TPC-H Q1 over pre-partitioned LINEITEM host batches (schema
    ``Q1_SCHEMA``): partial aggregate per partition, then one final
    aggregate and the sort on (returnflag, linestatus)."""
    src = InMemorySourceExec(Q1_SCHEMA, partitions, device=device)
    f = dt.FLOAT64
    filt = FilterExec(src, LessThanOrEqual(
        Ref(6, dt.DATE), Literal(dt.DATE, Q1_SHIPDATE_CUTOFF)))
    one = lit(1.0)
    disc_price = Multiply(Ref(1, f), Subtract(one, Ref(2, f)))
    charge = Multiply(Multiply(Ref(1, f), Subtract(one, Ref(2, f))),
                      Add(one, Ref(3, f)))
    proj = ProjectExec(filt, [
        ("l_returnflag", Ref(4, dt.STRING)),
        ("l_linestatus", Ref(5, dt.STRING)),
        ("l_quantity", Ref(0, f)), ("l_extendedprice", Ref(1, f)),
        ("l_discount", Ref(2, f)), ("disc_price", disc_price),
        ("charge", charge)])
    keys = [("l_returnflag", Ref(0, dt.STRING)),
            ("l_linestatus", Ref(1, dt.STRING))]
    aggs = q1_aggregates()
    partial = HashAggregateExec(proj, keys, aggs, mode="partial")
    final = HashAggregateExec(CoalescePartitionsExec(partial, 1), keys, aggs,
                              mode="final")
    return SortExec(final, [SortOrder(Ref(0, dt.STRING)),
                            SortOrder(Ref(1, dt.STRING))])


# ---------------------------------------------------------------------------
# TPC-H Q3 and Q4
# ---------------------------------------------------------------------------

# Partitions per table: the generator's files_per_table (8), halved for
# CUSTOMER.
TABLE_PARTITIONS = {"lineitem": 8, "orders": 8, "customer": 4}

Q3_CUSTOMER = (("c_custkey", dt.INT64), ("c_mktsegment", dt.STRING))
Q3_ORDERS = (("o_orderkey", dt.INT64), ("o_custkey", dt.INT64),
             ("o_orderdate", dt.DATE), ("o_shippriority", dt.INT32))
Q3_LINEITEM = (("l_orderkey", dt.INT64), ("l_extendedprice", dt.FLOAT64),
               ("l_discount", dt.FLOAT64), ("l_shipdate", dt.DATE))
Q3_DATE = days("1995-03-15")
Q3_SEGMENT = "BUILDING"
Q3_LIMIT = 10

Q4_ORDERS = (("o_orderkey", dt.INT64), ("o_orderdate", dt.DATE),
             ("o_orderpriority", dt.STRING))
Q4_LINEITEM = (("l_orderkey", dt.INT64), ("l_commitdate", dt.DATE),
               ("l_receiptdate", dt.DATE))
Q4_DATE_LO = days("1993-07-01")
Q4_DATE_HI = days("1993-10-01")


def _tables(cols: dict, schemas: dict) -> dict:
    return {t: table_partitions(cols[t], schema, TABLE_PARTITIONS[t])
            for t, schema in schemas.items()}


def tpch_q3_tables(cols: dict) -> dict:
    """Q3's scans over ``tpch_columns`` output: table -> partitions."""
    return _tables(cols, {"customer": Q3_CUSTOMER, "orders": Q3_ORDERS,
                          "lineitem": Q3_LINEITEM})


def tpch_q4_tables(cols: dict) -> dict:
    """Q4's scans over ``tpch_columns`` output: table -> partitions."""
    return _tables(cols, {"orders": Q4_ORDERS, "lineitem": Q4_LINEITEM})


def _final_keys(keys):
    """A final aggregate's keys: the partial output's leading columns."""
    return [(n, Ref(i, e.data_type())) for i, (n, e) in enumerate(keys)]


def tpch_q3_plan(tables: dict, device: DeviceLike = None) -> GlobalLimitExec:
    """TPC-H Q3: customers of the BUILDING segment join their orders placed
    before 1995-03-15 (broadcast: customer is the build side), those join
    their lines shipped after it (broadcast: the orders-customer join is
    the build side); revenue per (l_orderkey, o_orderdate,
    o_shippriority), top 10 by revenue desc, o_orderdate asc."""
    dev = resolve_device(device)
    f, d = dt.FLOAT64, dt.DATE
    cust = ProjectExec(
        FilterExec(InMemorySourceExec(Q3_CUSTOMER, tables["customer"], dev),
                   EqualTo(Ref(1, dt.STRING), lit(Q3_SEGMENT))),
        [("c_custkey", Ref(0, dt.INT64))])
    orders = ProjectExec(
        FilterExec(InMemorySourceExec(Q3_ORDERS, tables["orders"], dev),
                   LessThan(Ref(2, d), Literal(d, Q3_DATE))),
        [(n, Ref(i, t)) for i, (n, t) in enumerate(Q3_ORDERS)])
    co = BroadcastHashJoinExec(orders, cust, [Ref(1, dt.INT64)],
                               [Ref(0, dt.INT64)], "inner")
    li = ProjectExec(
        FilterExec(InMemorySourceExec(Q3_LINEITEM, tables["lineitem"], dev),
                   GreaterThan(Ref(3, d), Literal(d, Q3_DATE))),
        [(n, Ref(i, t)) for i, (n, t) in enumerate(Q3_LINEITEM[:3])])
    # [l_orderkey, l_extendedprice, l_discount, o_orderkey, o_custkey,
    #  o_orderdate, o_shippriority, c_custkey]
    joined = BroadcastHashJoinExec(li, co, [Ref(0, dt.INT64)],
                                   [Ref(0, dt.INT64)], "inner")
    keys = [("l_orderkey", Ref(0, dt.INT64)), ("o_orderdate", Ref(5, d)),
            ("o_shippriority", Ref(6, dt.INT32))]
    aggs = [AggSpec("revenue", Sum(Multiply(Ref(1, f),
                                            Subtract(lit(1.0), Ref(2, f)))))]
    partial = HashAggregateExec(joined, keys, aggs, mode="partial")
    final = HashAggregateExec(CoalescePartitionsExec(partial, 1),
                              _final_keys(keys), aggs, mode="final")
    top = SortExec(final, [SortOrder(Ref(3, f), ascending=False,
                                     nulls_first=False),
                           SortOrder(Ref(1, d))])
    return GlobalLimitExec(LocalLimitExec(top, Q3_LIMIT), Q3_LIMIT)


def tpch_q4_plan(tables: dict, device: DeviceLike = None) -> SortExec:
    """TPC-H Q4: orders of 1993-Q3 that have a line received after its
    commit date (a left-semi broadcast hash join; the late lines are the
    build side), counted per o_orderpriority."""
    dev = resolve_device(device)
    d = dt.DATE
    orders = FilterExec(
        InMemorySourceExec(Q4_ORDERS, tables["orders"], dev),
        And(GreaterThanOrEqual(Ref(1, d), Literal(d, Q4_DATE_LO)),
            LessThan(Ref(1, d), Literal(d, Q4_DATE_HI))))
    late = ProjectExec(
        FilterExec(InMemorySourceExec(Q4_LINEITEM, tables["lineitem"], dev),
                   LessThan(Ref(1, d), Ref(2, d))),
        [("l_orderkey", Ref(0, dt.INT64))])
    semi = BroadcastHashJoinExec(orders, late, [Ref(0, dt.INT64)],
                                 [Ref(0, dt.INT64)], "semi")
    keys = [("o_orderpriority", Ref(2, dt.STRING))]
    aggs = [AggSpec("order_count", CountStar(None))]
    partial = HashAggregateExec(semi, keys, aggs, mode="partial")
    final = HashAggregateExec(CoalescePartitionsExec(partial, 1),
                              _final_keys(keys), aggs, mode="final")
    return SortExec(final, [SortOrder(Ref(0, dt.STRING))])
