"""TPC-H q1-q6 through the port's DataFrame API (port of the JAX
package's ``benchmarks/tpch.py`` query bodies).

The query bodies ``q1``, ``q6``, ``q3``, ``q5``, ``q2`` and ``q4`` are the
reference's, line for line. Only ``_read`` differs: the reference reads
parquet (through pyarrow, which the port does not use); here a query reads
its tables from a ``tables`` dict of DataFrames. ``tpch_tables`` builds
those from ``entry.tpch_columns`` (the reference generator's rows, draw
for draw) as in-memory scans, one per table a query reads, holding exactly
the columns the query reads (the columns the reference's scan pruning
keeps), in ``entry.TABLE_PARTITIONS`` partitions.

    session = TpuSession({"spark.rapids.sql.variableFloatAgg.enabled":
                          True})
    tables = tpch_tables(session, entry.tpch_columns(1.0))
    rows = q1(session, tables["q1"]).collect()

The default ``variableFloatAgg.enabled=false`` tags every float Sum/Avg
for the host, which the port refuses; TPC-H runs set it true, as the
reference's bench does.
"""

from __future__ import annotations

from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch.api.dataframe import DataFrame
from spark_rapids_tpu_torch.entry import days
from spark_rapids_tpu_torch.plan import logical as L

# The scans of each query: table -> schema (the columns it reads, in the
# generator's column order).
SCANS = {
    "q1": {"lineitem": E.Q1_SCHEMA},
    "q6": {"lineitem": E.Q6_LINEITEM},
    "q3": {"customer": E.Q3_CUSTOMER, "orders": E.Q3_ORDERS,
           "lineitem": E.Q3_LINEITEM},
    "q5": {"region": E.Q5_REGION, "nation": E.Q5_NATION,
           "customer": E.Q5_CUSTOMER, "orders": E.Q5_ORDERS,
           "lineitem": E.Q5_LINEITEM, "supplier": E.Q5_SUPPLIER},
    "q2": {"region": E.Q2_REGION, "nation": E.Q2_NATION,
           "supplier": E.Q2_SUPPLIER, "partsupp": E.Q2_PARTSUPP,
           "part": E.Q2_PART},
    "q4": {"lineitem": E.Q4_LINEITEM, "orders": E.Q4_ORDERS},
}


def tpch_tables(session, cols: dict) -> dict:
    """query -> table -> DataFrame: each query's in-memory scans over
    ``cols`` (``entry.tpch_columns`` output)."""
    return {q: {t: DataFrame(session, L.InMemoryScan(
        schema, E.table_partitions(cols[t], schema, E.TABLE_PARTITIONS[t])))
        for t, schema in scans.items()} for q, scans in SCANS.items()}


def _read(session, tables: dict, table: str):
    return tables[table]


# ---------------------------------------------------------------------------
# Queries (TpchLikeSpark.scala Q1/Q6/Q3/Q5 analogs)
# ---------------------------------------------------------------------------

def q1(session, tables: dict):
    """Pricing summary report: scan+filter+wide hash aggregate."""
    from spark_rapids_tpu_torch.plan.logical import (
        agg_avg, agg_count, agg_sum, col, lit_col)
    li = _read(session, tables, "lineitem")
    disc = li.filter(col("l_shipdate") <= lit_col(days("1998-09-02"))) \
        .with_column("disc_price",
                     col("l_extendedprice") * (1.0 - col("l_discount"))) \
        .with_column("charge",
                     col("l_extendedprice") * (1.0 - col("l_discount"))
                     * (1.0 + col("l_tax")))
    return disc.group_by("l_returnflag", "l_linestatus").agg(
        agg_sum(col("l_quantity")).alias("sum_qty"),
        agg_sum(col("l_extendedprice")).alias("sum_base_price"),
        agg_sum(col("disc_price")).alias("sum_disc_price"),
        agg_sum(col("charge")).alias("sum_charge"),
        agg_avg(col("l_quantity")).alias("avg_qty"),
        agg_avg(col("l_extendedprice")).alias("avg_price"),
        agg_avg(col("l_discount")).alias("avg_disc"),
        agg_count().alias("count_order"),
    ).order_by("l_returnflag", "l_linestatus")


def q6(session, tables: dict):
    """Forecasting revenue change: selective filter + global agg."""
    from spark_rapids_tpu_torch.plan.logical import agg_sum, col, lit_col
    li = _read(session, tables, "lineitem")
    f = li.filter(
        (col("l_shipdate") >= lit_col(days("1994-01-01")))
        & (col("l_shipdate") < lit_col(days("1995-01-01")))
        & (col("l_discount") >= 0.05) & (col("l_discount") <= 0.07)
        & (col("l_quantity") < 24.0))
    return f.agg(agg_sum(col("l_extendedprice") * col("l_discount"))
                 .alias("revenue"))


def q3(session, tables: dict):
    """Shipping priority: two joins + agg + top-10 by revenue."""
    from spark_rapids_tpu_torch.plan.logical import agg_sum, col, lit_col
    cust = _read(session, tables, "customer") \
        .filter(col("c_mktsegment") == lit_col("BUILDING")) \
        .select("c_custkey")
    orders = _read(session, tables, "orders") \
        .filter(col("o_orderdate") < lit_col(days("1995-03-15"))) \
        .select("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority")
    li = _read(session, tables, "lineitem") \
        .filter(col("l_shipdate") > lit_col(days("1995-03-15"))) \
        .select("l_orderkey", "l_extendedprice", "l_discount")
    co = orders.join_on(cust, ["o_custkey"], ["c_custkey"])
    j = li.join_on(co, ["l_orderkey"], ["o_orderkey"])
    return j.group_by("l_orderkey", "o_orderdate", "o_shippriority").agg(
        agg_sum(col("l_extendedprice") * (1.0 - col("l_discount")))
        .alias("revenue")
    ).order_by(col("revenue").desc(), col("o_orderdate").asc()) \
        .limit(10)


def q5(session, tables: dict):
    """Local supplier volume: 5-way join + agg ordered by revenue."""
    from spark_rapids_tpu_torch.plan.logical import agg_sum, col, lit_col
    region = _read(session, tables, "region") \
        .filter(col("r_name") == lit_col("ASIA"))
    nation = _read(session, tables, "nation")
    nat = nation.join_on(region, ["n_regionkey"], ["r_regionkey"]) \
        .select("n_nationkey", "n_name")
    cust = _read(session, tables, "customer") \
        .join_on(nat, ["c_nationkey"], ["n_nationkey"]) \
        .select("c_custkey", "c_nationkey", "n_name")
    orders = _read(session, tables, "orders") \
        .filter((col("o_orderdate") >= lit_col(days("1994-01-01")))
                & (col("o_orderdate") < lit_col(days("1995-01-01")))) \
        .select("o_orderkey", "o_custkey")
    co = orders.join_on(cust, ["o_custkey"], ["c_custkey"]) \
        .select("o_orderkey", "c_nationkey", "n_name")
    li = _read(session, tables, "lineitem") \
        .select("l_orderkey", "l_suppkey", "l_extendedprice", "l_discount")
    j = li.join_on(co, ["l_orderkey"], ["o_orderkey"])
    supp = _read(session, tables, "supplier")
    j2 = j.join_on(supp, ["l_suppkey", "c_nationkey"],
                   ["s_suppkey", "s_nationkey"])
    return j2.group_by("n_name").agg(
        agg_sum(col("l_extendedprice") * (1.0 - col("l_discount")))
        .alias("revenue")
    ).order_by(col("revenue").desc())


def q2(session, tables: dict):
    """Minimum-cost supplier: correlated min subquery as a re-join
    (TpchLikeSpark.scala's Q2 DataFrame shape)."""
    from spark_rapids_tpu_torch.plan.logical import agg_min, col, lit_col
    region = _read(session, tables, "region") \
        .filter(col("r_name") == lit_col("EUROPE"))
    nat = _read(session, tables, "nation") \
        .join_on(region, ["n_regionkey"], ["r_regionkey"]) \
        .select("n_nationkey", "n_name")
    supp = _read(session, tables, "supplier") \
        .join_on(nat, ["s_nationkey"], ["n_nationkey"]) \
        .select("s_suppkey", "s_name", "s_address", "s_phone", "s_acctbal",
                "s_comment", "n_name")
    ps = _read(session, tables, "partsupp") \
        .join_on(supp, ["ps_suppkey"], ["s_suppkey"])
    minc = ps.group_by("ps_partkey").agg(
        agg_min(col("ps_supplycost")).alias("min_cost")) \
        .select(col("ps_partkey").alias("m_partkey"), col("min_cost"))
    part = _read(session, tables, "part") \
        .filter((col("p_size") == 15)
                & col("p_type").endswith("BRASS")) \
        .select("p_partkey", "p_mfgr")
    j = part.join_on(ps, ["p_partkey"], ["ps_partkey"]) \
        .join_on(minc, ["p_partkey"], ["m_partkey"]) \
        .filter(col("ps_supplycost") == col("min_cost"))
    return j.select("s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
                    "s_address", "s_phone", "s_comment") \
        .order_by(col("s_acctbal").desc(), col("n_name").asc(),
                  col("s_name").asc(), col("p_partkey").asc()) \
        .limit(100)


def q4(session, tables: dict):
    """Order priority checking: EXISTS subquery as a left-semi join."""
    from spark_rapids_tpu_torch.plan.logical import agg_count, col, lit_col
    li = _read(session, tables, "lineitem") \
        .filter(col("l_commitdate") < col("l_receiptdate")) \
        .select("l_orderkey")
    o = _read(session, tables, "orders") \
        .filter((col("o_orderdate") >= lit_col(days("1993-07-01")))
                & (col("o_orderdate") < lit_col(days("1993-10-01"))))
    return o.join_on(li, ["o_orderkey"], ["l_orderkey"], how="semi") \
        .group_by("o_orderpriority") \
        .agg(agg_count().alias("order_count")) \
        .order_by("o_orderpriority")


QUERIES = {"q1": q1, "q2": q2, "q3": q3, "q4": q4, "q5": q5, "q6": q6}
