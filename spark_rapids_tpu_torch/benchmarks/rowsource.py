"""Queries over the port's numeric, date-time and row-source surface,
through the DataFrame API: a synthetic ``range`` source with task-context
columns, a LINEITEM projection of the math and date-time functions, its
grouping with First/Last, and two unions.

Each function takes the DSL module ``L`` (``plan/logical.py`` of the port,
or any module with the same functions) and a session or a LINEITEM
DataFrame.

    session = TpuSession({"spark.rapids.sql.variableFloatAgg.enabled": True,
                          "spark.rapids.sql.improvedFloatOps.enabled": True})
    rows = range_query(L, session, 1 << 26, 8).collect()
    li = lineitem(session, entry.tpch_columns(1.0))
    rows = lineitem_groups(L, li).collect()

The query text uses only DSL functions both the port and the JAX package
define, so the tests build each query on both and compare.

Under the default conf the transcendentals of ``lineitem_projection``
(``log``, ``exp``, ``pow``) and ``union_dates``' float sum run on the
host engine, as in the reference.
"""

from __future__ import annotations

from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch.columnar import dtypes as dt

# The LINEITEM columns the queries read, in the generator's order.
LINEITEM = (("l_orderkey", dt.INT64), ("l_quantity", dt.FLOAT64),
            ("l_extendedprice", dt.FLOAT64), ("l_discount", dt.FLOAT64),
            ("l_tax", dt.FLOAT64), ("l_shipdate", dt.DATE),
            ("l_commitdate", dt.DATE), ("l_receiptdate", dt.DATE))

# range_query's group count.
RANGE_GROUPS = 4096


def lineitem(session, cols: dict, partitions: int = 1, rows=None):
    """LINEITEM's ``LINEITEM`` columns of ``entry.tpch_columns`` output
    (its first ``rows`` rows, or all) as an in-memory DataFrame in
    ``partitions`` row ranges (one: arrival order is scan order, so first
    / last are exact)."""
    from spark_rapids_tpu_torch.api.dataframe import DataFrame
    from spark_rapids_tpu_torch.plan import logical as L
    li = {n: cols["lineitem"][n][:rows] for n, _ in LINEITEM}
    return DataFrame(session, L.InMemoryScan(LINEITEM, E.table_partitions(
        li, LINEITEM, partitions)))


def range_frame(L, session, n: int, partitions: int):
    """``range(0, n)`` with rand(7), monotonically_increasing_id(),
    spark_partition_id() and the hour, minute and second of
    ``from_unixtime(id * 37)``."""
    df = session.range(0, n, num_partitions=partitions).select(
        L.col("id"), L.rand(7).alias("r"),
        L.monotonically_increasing_id().alias("m"),
        L.spark_partition_id().alias("p"),
        L.from_unixtime(L.col("id") * 37).alias("t"))
    return df.select(L.col("id"), L.col("r"), L.col("m"), L.col("p"),
                     L.hour(L.col("t")).alias("h"),
                     L.minute(L.col("t")).alias("mi"),
                     L.second(L.col("t")).alias("s"))


def range_query(L, session, n: int, partitions: int):
    """``range_frame`` grouped by ``pmod(id, 4096)``, ordered by the key."""
    return range_frame(L, session, n, partitions).group_by(
        L.pmod(L.col("id"), RANGE_GROUPS).alias("k")).agg(
        L.agg_count().alias("n"), L.agg_sum(L.col("id")).alias("sum_id"),
        L.agg_min(L.col("r")).alias("min_r"),
        L.agg_max(L.col("r")).alias("max_r"),
        L.agg_min(L.col("m")).alias("min_m"),
        L.agg_max(L.col("m")).alias("max_m"),
        L.agg_sum(L.col("h")).alias("sum_h"),
        L.agg_sum(L.col("s")).alias("sum_s"),
        L.agg_max(L.col("p")).alias("max_p")).order_by("k")


# (name, is a transcendental) of lineitem_projection's columns, in order.
PROJECTION = (
    ("l_orderkey", False), ("datediff", False), ("dow", False),
    ("weekday", False), ("doy", False), ("quarter", False),
    ("last_day", False), ("trunc_mm", False), ("add_months", False),
    ("commit_30", False), ("round2", False), ("bround2", False),
    ("floor7", False), ("ceil7", False), ("log_price", True),
    ("sqrt_price", False), ("exp_tax", True), ("disc_sq", True),
    ("least", False), ("greatest", False), ("abs_qty", False),
    ("signum", False), ("isnan", False), ("nanvl", False),
    ("nn2", False))


def lineitem_projection(L, li):
    """One row a line item: date-time, rounding and math functions over
    LINEITEM's columns."""
    c = L.col
    price = c("l_extendedprice") * (1 - c("l_discount"))
    off = L.sqrt_col(c("l_discount") - 0.05)      # NaN below 0.05
    return li.select(
        c("l_orderkey"),
        L.datediff(c("l_receiptdate"), c("l_shipdate")).alias("datediff"),
        L.dayofweek(c("l_shipdate")).alias("dow"),
        L.weekday(c("l_shipdate")).alias("weekday"),
        L.dayofyear(c("l_shipdate")).alias("doy"),
        L.quarter(c("l_shipdate")).alias("quarter"),
        L.last_day(c("l_shipdate")).alias("last_day"),
        L.trunc(c("l_shipdate"), "MM").alias("trunc_mm"),
        L.add_months(c("l_shipdate"), 1).alias("add_months"),
        L.date_add(c("l_commitdate"), 30).alias("commit_30"),
        L.round_col(price, 2).alias("round2"),
        L.bround_col(price, 2).alias("bround2"),
        L.floor_col(c("l_extendedprice") / 7).alias("floor7"),
        L.ceil_col(c("l_extendedprice") / 7).alias("ceil7"),
        L.log_col(c("l_extendedprice")).alias("log_price"),
        L.sqrt_col(c("l_extendedprice")).alias("sqrt_price"),
        L.exp_col(-c("l_tax")).alias("exp_tax"),
        L.pow_col(c("l_discount"), 2.0).alias("disc_sq"),
        L.least(c("l_tax"), c("l_discount")).alias("least"),
        L.greatest(c("l_tax"), c("l_discount")).alias("greatest"),
        L.abs_col(-c("l_quantity")).alias("abs_qty"),
        L.signum_col(c("l_discount") - 0.05).alias("signum"),
        L.isnan_col(off).alias("isnan"),
        L.nanvl(off, -1.0).alias("nanvl"),
        L.at_least_n_non_nulls(2, L.log_col(c("l_tax")), off,
                               c("l_orderkey")).alias("nn2"))


def lineitem_groups(L, li):
    """``lineitem_projection`` by (month, day of week) of the ship date:
    the row count, integer sums, min and max of the projected columns
    (the transcendentals included) and the first and last order key in
    arrival order. Every sum is of integers, so under the default conf
    the aggregate stays on the card while the projection runs on the
    host engine."""
    c = L.col

    def count_true(name):
        return L.agg_sum(L.when(c(name), 1).otherwise(0))
    return lineitem_projection(L, li).group_by(
        c("trunc_mm").alias("month"), c("dow")).agg(
        L.agg_count().alias("n"),
        L.agg_sum(c("datediff")).alias("sum_datediff"),
        L.agg_sum(c("floor7")).alias("sum_floor7"),
        L.agg_sum(c("ceil7")).alias("sum_ceil7"),
        L.agg_sum(c("weekday")).alias("sum_weekday"),
        L.agg_min(c("doy")).alias("min_doy"),
        L.agg_max(c("quarter")).alias("max_quarter"),
        L.agg_min(c("last_day")).alias("min_last_day"),
        L.agg_max(c("add_months")).alias("max_add_months"),
        L.agg_max(c("commit_30")).alias("max_commit_30"),
        L.agg_min(c("round2")).alias("min_round2"),
        L.agg_max(c("bround2")).alias("max_bround2"),
        L.agg_min(c("log_price")).alias("min_log"),
        L.agg_max(c("sqrt_price")).alias("max_sqrt"),
        L.agg_min(c("exp_tax")).alias("min_exp"),
        L.agg_max(c("disc_sq")).alias("max_disc_sq"),
        L.agg_min(c("least")).alias("min_least"),
        L.agg_max(c("greatest")).alias("max_greatest"),
        L.agg_max(c("abs_qty")).alias("max_abs_qty"),
        L.agg_min(c("signum")).alias("min_signum"),
        L.agg_max(c("nanvl")).alias("max_nanvl"),
        count_true("isnan").alias("n_nan"),
        count_true("nn2").alias("n_nn2"),
        L.agg_first(c("l_orderkey")).alias("first_key"),
        L.agg_last(c("l_orderkey")).alias("last_key")).order_by("month",
                                                                 "dow")


def projection_head(L, li, n: int):
    """The first ``n`` rows of ``lineitem_projection`` in scan order
    (LINEITEM's order keys ascend in scan order; the sort is stable)."""
    return lineitem_projection(L, li).order_by("l_orderkey").limit(n)


def union_dates(L, li):
    """Ship dates and receipt dates as one column ``d`` (UNION ALL) with
    the quantity, by year and quarter."""
    c = L.col
    ship = li.select(c("l_shipdate").alias("d"), c("l_quantity"))
    recv = li.select(c("l_receiptdate").alias("d"), c("l_quantity"))
    return ship.union(recv).group_by(
        L.year(c("d")).alias("y"), L.quarter(c("d")).alias("q")).agg(
        L.agg_count().alias("n"),
        L.agg_sum(c("l_quantity")).alias("sum_qty")).order_by("y", "q")


def range_union(L, session, n: int, partitions: int):
    """range(0, n) UNION ALL range(n, 2n), each in ``partitions``
    partitions: row count and id sum by the union's partition id."""
    a = session.range(0, n, num_partitions=partitions)
    b = session.range(n, 2 * n, num_partitions=partitions)
    return a.union(b).select(
        L.spark_partition_id().alias("p"), L.col("id")).group_by("p").agg(
        L.agg_count().alias("n"),
        L.agg_sum(L.col("id")).alias("sum_id")).order_by("p")
