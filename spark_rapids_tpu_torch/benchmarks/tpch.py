"""TPC-H q1-q10, q12-q14, q16-q19 and q21 through the port's DataFrame
API (port of the JAX package's ``benchmarks/tpch.py`` query bodies).

The query bodies ``q1``, ``q6``, ``q3``, ``q5``, ``q2``, ``q4``, ``q7``,
``q8``, ``q9``, ``q10``, ``q12``, ``q13``, ``q14``, ``q16``, ``q17``,
``q18``, ``q19`` and ``q21`` are the reference's, line for line. Only
``_read`` differs: the reference reads parquet (through pyarrow, which
the port does not use); here a query reads its tables from a ``tables``
dict of DataFrames. ``tpch_tables`` builds
those from ``entry.tpch_columns`` (the reference generator's rows, draw
for draw) as in-memory scans, one per table a query reads, holding exactly
the columns the query reads (the columns the reference's scan pruning
keeps), in ``entry.TABLE_PARTITIONS`` partitions.

    session = TpuSession()
    tables = tpch_tables(session, entry.tpch_columns(1.0))
    rows = q1(session, tables["q1"]).collect()

Under the default conf (``variableFloatAgg.enabled=false``) every float
Sum/Avg aggregate (in q1, q3, q5-q10, q14 and q17-q19) is tagged
for the host and runs on the host engine between device subtrees, as in
the reference; with
``{"spark.rapids.sql.variableFloatAgg.enabled": True}``, as the
reference's bench sets it, the whole query stays on the card.
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
    "q7": {"nation": E.Q7_NATION, "supplier": E.Q7_SUPPLIER,
           "customer": E.Q7_CUSTOMER, "orders": E.Q7_ORDERS,
           "lineitem": E.Q7_LINEITEM},
    "q8": {"region": E.Q8_REGION, "nation": E.Q8_NATION,
           "customer": E.Q8_CUSTOMER, "supplier": E.Q8_SUPPLIER,
           "part": E.Q8_PART, "orders": E.Q8_ORDERS,
           "lineitem": E.Q8_LINEITEM},
    "q9": {"part": E.Q9_PART, "supplier": E.Q9_SUPPLIER,
           "nation": E.Q9_NATION, "partsupp": E.Q9_PARTSUPP,
           "orders": E.Q9_ORDERS, "lineitem": E.Q9_LINEITEM},
    "q12": {"lineitem": E.Q12_LINEITEM, "orders": E.Q12_ORDERS},
    "q14": {"lineitem": E.Q14_LINEITEM, "part": E.Q14_PART},
    "q19": {"lineitem": E.Q19_LINEITEM, "part": E.Q19_PART},
    "q10": {"lineitem": E.Q10_LINEITEM, "orders": E.Q10_ORDERS,
            "customer": E.Q10_CUSTOMER, "nation": E.Q10_NATION},
    "q13": {"customer": E.Q13_CUSTOMER, "orders": E.Q13_ORDERS},
    "q16": {"partsupp": E.Q16_PARTSUPP, "supplier": E.Q16_SUPPLIER,
            "part": E.Q16_PART},
    "q17": {"lineitem": E.Q17_LINEITEM, "part": E.Q17_PART},
    "q18": {"lineitem": E.Q18_LINEITEM, "orders": E.Q18_ORDERS,
            "customer": E.Q18_CUSTOMER},
    "q21": {"lineitem": E.Q21_LINEITEM, "orders": E.Q21_ORDERS,
            "supplier": E.Q21_SUPPLIER, "nation": E.Q21_NATION},
}


def tpch_tables(session, cols: dict, queries=None) -> dict:
    """query -> table -> DataFrame: each query's in-memory scans over
    ``cols`` (``entry.tpch_columns`` output), for ``queries`` (default:
    every query of ``SCANS``)."""
    return {q: {t: DataFrame(session, L.InMemoryScan(
        schema, E.table_partitions(cols[t], schema, E.TABLE_PARTITIONS[t])))
        for t, schema in SCANS[q].items()} for q in (queries or SCANS)}


def _read(session, tables: dict, table: str):
    return tables[table]


# ---------------------------------------------------------------------------
# Queries (TpchLikeSpark.scala analogs)
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


def q7(session, tables: dict):
    """Volume shipping between FRANCE and GERMANY by year."""
    from spark_rapids_tpu_torch.plan.logical import (
        col, lit_col, agg_sum, year)
    n1 = _read(session, tables, "nation") \
        .select(col("n_nationkey").alias("s_nkey"),
                col("n_name").alias("supp_nation"))
    n2 = _read(session, tables, "nation") \
        .select(col("n_nationkey").alias("c_nkey"),
                col("n_name").alias("cust_nation"))
    supp = _read(session, tables, "supplier") \
        .join_on(n1, ["s_nationkey"], ["s_nkey"]) \
        .select("s_suppkey", "supp_nation")
    cust = _read(session, tables, "customer") \
        .join_on(n2, ["c_nationkey"], ["c_nkey"]) \
        .select("c_custkey", "cust_nation")
    orders = _read(session, tables, "orders") \
        .select("o_orderkey", "o_custkey") \
        .join_on(cust, ["o_custkey"], ["c_custkey"])
    li = _read(session, tables, "lineitem") \
        .filter((col("l_shipdate") >= lit_col(days("1995-01-01")))
                & (col("l_shipdate") <= lit_col(days("1996-12-31")))) \
        .select("l_orderkey", "l_suppkey", "l_extendedprice", "l_discount",
                "l_shipdate")
    j = li.join_on(supp, ["l_suppkey"], ["s_suppkey"]) \
        .join_on(orders, ["l_orderkey"], ["o_orderkey"]) \
        .filter(((col("supp_nation") == lit_col("FRANCE"))
                 & (col("cust_nation") == lit_col("GERMANY")))
                | ((col("supp_nation") == lit_col("GERMANY"))
                   & (col("cust_nation") == lit_col("FRANCE"))))
    return j.with_column("l_year", year(col("l_shipdate"))) \
        .with_column("volume",
                     col("l_extendedprice") * (1.0 - col("l_discount"))) \
        .group_by("supp_nation", "cust_nation", "l_year") \
        .agg(agg_sum(col("volume")).alias("revenue")) \
        .order_by("supp_nation", "cust_nation", "l_year")


def q8(session, tables: dict):
    """National market share of BRAZIL in AMERICA for a part type."""
    from spark_rapids_tpu_torch.plan.logical import (
        agg_sum, col, lit_col, when, year)
    region = _read(session, tables, "region") \
        .filter(col("r_name") == lit_col("AMERICA"))
    n1 = _read(session, tables, "nation") \
        .join_on(region, ["n_regionkey"], ["r_regionkey"]) \
        .select(col("n_nationkey").alias("c_nkey"))
    n2 = _read(session, tables, "nation") \
        .select(col("n_nationkey").alias("s_nkey"),
                col("n_name").alias("nation"))
    cust = _read(session, tables, "customer") \
        .join_on(n1, ["c_nationkey"], ["c_nkey"]).select("c_custkey")
    supp = _read(session, tables, "supplier") \
        .join_on(n2, ["s_nationkey"], ["s_nkey"]) \
        .select("s_suppkey", "nation")
    part = _read(session, tables, "part") \
        .filter(col("p_type") == lit_col("ECONOMY ANODIZED STEEL")) \
        .select("p_partkey")
    orders = _read(session, tables, "orders") \
        .filter((col("o_orderdate") >= lit_col(days("1995-01-01")))
                & (col("o_orderdate") <= lit_col(days("1996-12-31")))) \
        .join_on(cust, ["o_custkey"], ["c_custkey"]) \
        .select("o_orderkey", "o_orderdate")
    li = _read(session, tables, "lineitem") \
        .select("l_orderkey", "l_partkey", "l_suppkey", "l_extendedprice",
                "l_discount")
    j = li.join_on(part, ["l_partkey"], ["p_partkey"]) \
        .join_on(supp, ["l_suppkey"], ["s_suppkey"]) \
        .join_on(orders, ["l_orderkey"], ["o_orderkey"]) \
        .with_column("o_year", year(col("o_orderdate"))) \
        .with_column("volume",
                     col("l_extendedprice") * (1.0 - col("l_discount")))
    return j.group_by("o_year").agg(
        (agg_sum(when(col("nation") == lit_col("BRAZIL"),
                      col("volume")).otherwise(0.0))).alias("brazil"),
        agg_sum(col("volume")).alias("total"),
    ).with_column("mkt_share", col("brazil") / col("total")) \
        .select("o_year", "mkt_share").order_by("o_year")


def q9(session, tables: dict):
    """Product-type profit by nation and year (p_name like '%green%')."""
    from spark_rapids_tpu_torch.plan.logical import agg_sum, col, year
    part = _read(session, tables, "part") \
        .filter(col("p_name").contains("green")).select("p_partkey")
    supp = _read(session, tables, "supplier") \
        .select("s_suppkey", "s_nationkey")
    nat = _read(session, tables, "nation") \
        .select(col("n_nationkey"), col("n_name").alias("nation"))
    ps = _read(session, tables, "partsupp") \
        .select(col("ps_partkey"), col("ps_suppkey"), col("ps_supplycost"))
    orders = _read(session, tables, "orders") \
        .select("o_orderkey", "o_orderdate")
    li = _read(session, tables, "lineitem") \
        .select("l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                "l_extendedprice", "l_discount")
    j = li.join_on(part, ["l_partkey"], ["p_partkey"]) \
        .join_on(supp, ["l_suppkey"], ["s_suppkey"]) \
        .join_on(ps, ["l_partkey", "l_suppkey"],
                 ["ps_partkey", "ps_suppkey"]) \
        .join_on(orders, ["l_orderkey"], ["o_orderkey"]) \
        .join_on(nat, ["s_nationkey"], ["n_nationkey"]) \
        .with_column("o_year", year(col("o_orderdate"))) \
        .with_column("amount",
                     col("l_extendedprice") * (1.0 - col("l_discount"))
                     - col("ps_supplycost") * col("l_quantity"))
    return j.group_by("nation", "o_year") \
        .agg(agg_sum(col("amount")).alias("sum_profit")) \
        .order_by(col("nation").asc(), col("o_year").desc())


def q12(session, tables: dict):
    """Shipping modes and order priority (two conditional sums)."""
    from spark_rapids_tpu_torch.plan.logical import (
        agg_sum, col, lit_col, when)
    li = _read(session, tables, "lineitem") \
        .filter(col("l_shipmode").isin("MAIL", "SHIP")
                & (col("l_commitdate") < col("l_receiptdate"))
                & (col("l_shipdate") < col("l_commitdate"))
                & (col("l_receiptdate") >= lit_col(days("1994-01-01")))
                & (col("l_receiptdate") < lit_col(days("1995-01-01")))) \
        .select("l_orderkey", "l_shipmode")
    o = _read(session, tables, "orders") \
        .select("o_orderkey", "o_orderpriority")
    j = li.join_on(o, ["l_orderkey"], ["o_orderkey"])
    high = col("o_orderpriority").isin("1-URGENT", "2-HIGH")
    return j.group_by("l_shipmode").agg(
        agg_sum(when(high, 1).otherwise(0)).alias("high_line_count"),
        agg_sum(when(high, 0).otherwise(1)).alias("low_line_count"),
    ).order_by("l_shipmode")


def q14(session, tables: dict):
    """Promotion effect: conditional revenue share of PROMO parts."""
    from spark_rapids_tpu_torch.plan.logical import (
        agg_sum, col, lit_col, when)
    li = _read(session, tables, "lineitem") \
        .filter((col("l_shipdate") >= lit_col(days("1995-09-01")))
                & (col("l_shipdate") < lit_col(days("1995-10-01")))) \
        .select("l_partkey", "l_extendedprice", "l_discount")
    p = _read(session, tables, "part").select("p_partkey", "p_type")
    j = li.join_on(p, ["l_partkey"], ["p_partkey"]) \
        .with_column("revenue",
                     col("l_extendedprice") * (1.0 - col("l_discount")))
    promo = when(col("p_type").startswith("PROMO"),
                 col("revenue")).otherwise(0.0)
    return j.agg(agg_sum(promo).alias("promo"),
                 agg_sum(col("revenue")).alias("total")) \
        .select((col("promo") * 100.0 / col("total"))
                .alias("promo_revenue"))


def q19(session, tables: dict):
    """Discounted revenue: three-way disjunctive predicate over li x part."""
    from spark_rapids_tpu_torch.plan.logical import agg_sum, col, lit_col
    li = _read(session, tables, "lineitem") \
        .filter(col("l_shipmode").isin("AIR", "REG AIR")
                & (col("l_shipinstruct") == lit_col("DELIVER IN PERSON"))) \
        .select("l_partkey", "l_quantity", "l_extendedprice", "l_discount")
    p = _read(session, tables, "part") \
        .select("p_partkey", "p_brand", "p_container", "p_size")
    j = li.join_on(p, ["l_partkey"], ["p_partkey"])
    c1 = ((col("p_brand") == lit_col("Brand#12"))
          & col("p_container").isin("SM CASE", "SM BOX", "SM PACK",
                                    "SM PKG")
          & (col("l_quantity") >= 1.0) & (col("l_quantity") <= 11.0)
          & (col("p_size") >= 1) & (col("p_size") <= 5))
    c2 = ((col("p_brand") == lit_col("Brand#23"))
          & col("p_container").isin("MED BAG", "MED BOX", "MED PKG",
                                    "MED PACK")
          & (col("l_quantity") >= 10.0) & (col("l_quantity") <= 20.0)
          & (col("p_size") >= 1) & (col("p_size") <= 10))
    c3 = ((col("p_brand") == lit_col("Brand#34"))
          & col("p_container").isin("LG CASE", "LG BOX", "LG PACK",
                                    "LG PKG")
          & (col("l_quantity") >= 20.0) & (col("l_quantity") <= 30.0)
          & (col("p_size") >= 1) & (col("p_size") <= 15))
    return j.filter(c1 | c2 | c3).agg(
        agg_sum(col("l_extendedprice") * (1.0 - col("l_discount")))
        .alias("revenue"))


def q10(session, tables: dict):
    """Returned-item reporting: top 20 customers by lost revenue."""
    from spark_rapids_tpu_torch.plan.logical import agg_sum, col, lit_col
    orders = _read(session, tables, "orders") \
        .filter((col("o_orderdate") >= lit_col(days("1993-10-01")))
                & (col("o_orderdate") < lit_col(days("1994-01-01")))) \
        .select("o_orderkey", "o_custkey")
    li = _read(session, tables, "lineitem") \
        .filter(col("l_returnflag") == lit_col("R")) \
        .select("l_orderkey", "l_extendedprice", "l_discount")
    nat = _read(session, tables, "nation") \
        .select("n_nationkey", "n_name")
    cust = _read(session, tables, "customer") \
        .join_on(nat, ["c_nationkey"], ["n_nationkey"]) \
        .select("c_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
                "c_address", "c_comment")
    j = li.join_on(orders, ["l_orderkey"], ["o_orderkey"]) \
        .join_on(cust, ["o_custkey"], ["c_custkey"]) \
        .with_column("revenue",
                     col("l_extendedprice") * (1.0 - col("l_discount")))
    return j.group_by("c_custkey", "c_name", "c_acctbal", "c_phone",
                      "n_name", "c_address", "c_comment") \
        .agg(agg_sum(col("revenue")).alias("revenue")) \
        .select("c_custkey", "c_name", "revenue", "c_acctbal", "n_name",
                "c_address", "c_phone", "c_comment") \
        .order_by(col("revenue").desc()).limit(20)

def q13(session, tables: dict):
    """Customer order-count distribution: filtered LEFT join + count(col)
    (the filter only touches the right side, so it pre-applies)."""
    from spark_rapids_tpu_torch.plan.logical import agg_count, col
    o = _read(session, tables, "orders") \
        .filter(~col("o_comment").like("%special%requests%")) \
        .select("o_orderkey", "o_custkey")
    c = _read(session, tables, "customer").select("c_custkey")
    j = c.join_on(o, ["c_custkey"], ["o_custkey"], how="left")
    counts = j.group_by("c_custkey").agg(
        agg_count(col("o_orderkey")).alias("c_count"))
    return counts.group_by("c_count").agg(
        agg_count().alias("custdist")) \
        .order_by(col("custdist").desc(), col("c_count").desc())

def q16(session, tables: dict):
    """Parts/supplier relationship: anti join on complaint suppliers +
    count distinct."""
    from spark_rapids_tpu_torch.plan.logical import (
        agg_count_distinct, col, lit_col)
    bad = _read(session, tables, "supplier") \
        .filter(col("s_comment").like("%Customer%Complaints%")) \
        .select("s_suppkey")
    p = _read(session, tables, "part") \
        .filter((col("p_brand") != lit_col("Brand#45"))
                & ~col("p_type").startswith("MEDIUM POLISHED")
                & col("p_size").isin(49, 14, 23, 45, 19, 3, 36, 9)) \
        .select("p_partkey", "p_brand", "p_type", "p_size")
    ps = _read(session, tables, "partsupp") \
        .select("ps_partkey", "ps_suppkey") \
        .join_on(bad, ["ps_suppkey"], ["s_suppkey"], how="anti")
    j = ps.join_on(p, ["ps_partkey"], ["p_partkey"])
    return j.group_by("p_brand", "p_type", "p_size").agg(
        agg_count_distinct(col("ps_suppkey")).alias("supplier_cnt")) \
        .order_by(col("supplier_cnt").desc(), col("p_brand").asc(),
                  col("p_type").asc(), col("p_size").asc())

def q17(session, tables: dict):
    """Small-quantity-order revenue: correlated AVG as a grouped re-join."""
    from spark_rapids_tpu_torch.plan.logical import (
        agg_avg, agg_sum, col, lit_col)
    p = _read(session, tables, "part") \
        .filter((col("p_brand") == lit_col("Brand#23"))
                & (col("p_container") == lit_col("MED BOX"))) \
        .select("p_partkey")
    li = _read(session, tables, "lineitem") \
        .select("l_partkey", "l_quantity", "l_extendedprice")
    lp = li.join_on(p, ["l_partkey"], ["p_partkey"])
    lim = lp.group_by("l_partkey").agg(
        agg_avg(col("l_quantity")).alias("avg_qty")) \
        .select(col("l_partkey").alias("a_partkey"),
                (col("avg_qty") * 0.2).alias("qty_limit"))
    j = lp.join_on(lim, ["l_partkey"], ["a_partkey"]) \
        .filter(col("l_quantity") < col("qty_limit"))
    return j.agg(agg_sum(col("l_extendedprice")).alias("s")) \
        .select((col("s") / 7.0).alias("avg_yearly"))

def q18(session, tables: dict):
    """Large-volume customers: HAVING sum(qty) > 300 as a semi join."""
    from spark_rapids_tpu_torch.plan.logical import agg_sum, col
    li = _read(session, tables, "lineitem") \
        .select("l_orderkey", "l_quantity")
    big = li.group_by("l_orderkey").agg(
        agg_sum(col("l_quantity")).alias("sum_qty")) \
        .filter(col("sum_qty") > 300.0) \
        .select(col("l_orderkey").alias("b_orderkey"))
    o = _read(session, tables, "orders") \
        .select("o_orderkey", "o_custkey", "o_orderdate", "o_totalprice") \
        .join_on(big, ["o_orderkey"], ["b_orderkey"], how="semi")
    c = _read(session, tables, "customer").select("c_custkey", "c_name")
    j = li.join_on(o, ["l_orderkey"], ["o_orderkey"]) \
        .join_on(c, ["o_custkey"], ["c_custkey"])
    return j.group_by("c_name", "c_custkey", "o_orderkey", "o_orderdate",
                      "o_totalprice") \
        .agg(agg_sum(col("l_quantity")).alias("sum_qty")) \
        .order_by(col("o_totalprice").desc(), col("o_orderdate").asc()) \
        .limit(100)

def q21(session, tables: dict):
    """Suppliers who kept orders waiting: EXISTS/NOT-EXISTS self joins
    with a different-supplier condition."""
    from spark_rapids_tpu_torch.plan.logical import agg_count, col, lit_col
    nat = _read(session, tables, "nation") \
        .filter(col("n_name") == lit_col("SAUDI ARABIA")) \
        .select("n_nationkey")
    supp = _read(session, tables, "supplier") \
        .join_on(nat, ["s_nationkey"], ["n_nationkey"]) \
        .select("s_suppkey", "s_name")
    o = _read(session, tables, "orders") \
        .filter(col("o_orderstatus") == lit_col("F")).select("o_orderkey")
    l1 = _read(session, tables, "lineitem") \
        .filter(col("l_receiptdate") > col("l_commitdate")) \
        .select("l_orderkey", "l_suppkey") \
        .join_on(o, ["l_orderkey"], ["o_orderkey"], how="semi")
    l2 = _read(session, tables, "lineitem") \
        .select(col("l_orderkey").alias("l2_orderkey"),
                col("l_suppkey").alias("l2_suppkey"))
    l3 = _read(session, tables, "lineitem") \
        .filter(col("l_receiptdate") > col("l_commitdate")) \
        .select(col("l_orderkey").alias("l3_orderkey"),
                col("l_suppkey").alias("l3_suppkey"))
    j = l1.join_on(l2, ["l_orderkey"], ["l2_orderkey"], how="semi",
                   condition=col("l2_suppkey") != col("l_suppkey")) \
        .join_on(l3, ["l_orderkey"], ["l3_orderkey"], how="anti",
                 condition=col("l3_suppkey") != col("l_suppkey")) \
        .join_on(supp, ["l_suppkey"], ["s_suppkey"])
    return j.group_by("s_name").agg(agg_count().alias("numwait")) \
        .order_by(col("numwait").desc(), col("s_name").asc()).limit(100)


QUERIES = {"q1": q1, "q2": q2, "q3": q3, "q4": q4, "q5": q5, "q6": q6,
           "q7": q7, "q8": q8, "q9": q9, "q10": q10, "q12": q12,
           "q13": q13, "q14": q14, "q16": q16, "q17": q17, "q18": q18,
           "q19": q19, "q21": q21}
