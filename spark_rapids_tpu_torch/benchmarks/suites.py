"""The TPC-DS-like and TPCxBB-like queries through the port's DataFrame
API (port of the JAX package's ``benchmarks/suites.py``: its generator's
stream and the query bodies of q67, xbb_q5, ds_q3, ds_q42, ds_q89, ds_q55,
ds_q98 and xbb_q12).

``suite_columns(scale, seed)`` replays the reference generator
(``suites.generate``) draw for draw, numpy over one ``default_rng(seed)``
stream: the TPC-DS tables ``item``, ``store``, ``date_dim`` (derived, no
draws) and ``store_sales``, then ``web_clickstreams`` (``wcs_user_sk``
NULL in about 5% of rows, a numpy masked array here), ``customer`` and
``customer_demographics``. So the same scale and seed give the
reference's rows. String columns are codes into a pool (``STRING_POOLS``).

Each query is the reference's body, line for line; only ``_read``
differs: a query reads its tables from a dict of DataFrames, which
``suite_tables`` builds as in-memory scans holding exactly the columns
the reference's scan pruning keeps, each table in the reference's files
(``FILES_PER_TABLE`` above 100,000 rows, else 1).

    session = TpuSession()
    tables = suite_tables(session, suite_columns(1.0))
    rows = q67(session, tables["q67"]).collect()

xbb_q5's sums are integer (Sum of an INT32 CASE) and xbb_q12 counts
distinct users, so both stay on the card under every conf; the TPC-DS
queries sum float prices, so under the default conf their aggregates run
on the host engine. The prices and
quantities are whole numbers, so every sum is exact on both engines.
"""

from __future__ import annotations

import numpy as np

from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch.api.dataframe import DataFrame
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.plan import logical as L

CATEGORIES = ("Books", "Home", "Electronics", "Music", "Sports",
              "Toys", "Jewelry", "Shoes", "Men", "Women")
EDU = ("Advanced Degree", "College", "4 yr Degree", "2 yr Degree",
       "Secondary", "Primary", "Unknown")
GENDERS = ("F", "M")
CLASSES = tuple(f"class{i:02d}" for i in range(40))
BRANDS = tuple(f"brand{i:03d}" for i in range(200))
PRODUCTS = tuple(f"prod{i:05d}" for i in range(5000))
# ``s_store_id`` is "S%04d" of the store's index; the pool covers every
# scale below 833.
STORE_IDS = tuple(f"S{i:04d}" for i in range(10_000))
STRING_POOLS = {"i_category": CATEGORIES, "cd_gender": GENDERS,
                "cd_education_status": EDU, "i_class": CLASSES,
                "i_brand": BRANDS, "i_product_name": PRODUCTS,
                "s_store_id": STORE_IDS}
# The reference generator's rule (at its default of 8 files a table):
# tables above ``SPLIT_ABOVE_ROWS`` rows are split into
# ``FILES_PER_TABLE`` files, the rest written as one.
SPLIT_ABOVE_ROWS = 100_000
FILES_PER_TABLE = 8


def suite_columns(scale: float = 1.0, seed: int = 0) -> dict:
    """Every column of the suites' tables, as numpy arrays per table: the
    JAX package's ``suites.generate`` stream, so ``scale`` and ``seed``
    give its rows."""
    rng = np.random.default_rng(seed)
    # -- TPC-DS-like ------------------------------------------------------
    n_item = max(int(18_000 * scale), 100)
    n_store = max(int(12 * scale), 4)
    n_dates = 731                          # two years of days
    n_ss = max(int(2_880_000 * scale), 1000)
    assert n_store <= len(STORE_IDS), n_store
    i_category = rng.integers(0, len(CATEGORIES), n_item)
    i_category_id = rng.integers(1, 11, n_item, dtype=np.int64)
    i_class = rng.integers(0, len(CLASSES), n_item)
    i_brand = rng.integers(0, len(BRANDS), n_item)
    i_product_name = rng.integers(0, len(PRODUCTS), n_item)
    day = np.arange(n_dates)
    ss_sold_date_sk = rng.integers(1, n_dates + 1, n_ss, dtype=np.int64)
    ss_item_sk = rng.integers(1, n_item + 1, n_ss, dtype=np.int64)
    ss_store_sk = rng.integers(1, n_store + 1, n_ss, dtype=np.int64)
    # Whole numbers, so every sum of them is exact in f64.
    ss_quantity = rng.integers(1, 100, n_ss).astype(np.float64)
    ss_sales_price = rng.integers(1, 200, n_ss).astype(np.float64)
    # -- TPCxBB-like ------------------------------------------------------
    n_cust = max(int(100_000 * scale), 50)
    n_demo = max(int(20_000 * scale), 20)
    n_wcs = max(int(4_000_000 * scale), 1000)
    user = rng.integers(1, n_cust + 1, n_wcs, dtype=np.int64)
    user_null = rng.random(n_wcs) < 0.05   # the query filters IS NOT NULL
    wcs_item_sk = rng.integers(1, n_item + 1, n_wcs, dtype=np.int64)
    c_current_cdemo_sk = rng.integers(1, n_demo + 1, n_cust, dtype=np.int64)
    cd_gender = rng.integers(0, 2, n_demo)
    cd_education_status = rng.integers(0, len(EDU), n_demo)
    return {
        "item": {
            "i_item_sk": np.arange(1, n_item + 1, dtype=np.int64),
            "i_category": i_category, "i_category_id": i_category_id,
            "i_class": i_class, "i_brand": i_brand,
            "i_product_name": i_product_name},
        "store": {
            "s_store_sk": np.arange(1, n_store + 1, dtype=np.int64),
            "s_store_id": np.arange(n_store)},
        "date_dim": {
            "d_date_sk": np.arange(1, n_dates + 1, dtype=np.int64),
            "d_year": (1998 + day // 366).astype(np.int32),
            "d_qoy": ((day % 366) // 92 + 1).astype(np.int32),
            "d_moy": ((day % 366) // 31 + 1).astype(np.int32),
            "d_month_seq": (1176 + day // 30).astype(np.int32)},
        "store_sales": {
            "ss_sold_date_sk": ss_sold_date_sk, "ss_item_sk": ss_item_sk,
            "ss_store_sk": ss_store_sk, "ss_quantity": ss_quantity,
            "ss_sales_price": ss_sales_price},
        "web_clickstreams": {
            "wcs_user_sk": np.ma.array(np.where(user_null, 0, user),
                                       mask=user_null),
            "wcs_item_sk": wcs_item_sk},
        "customer": {
            "c_customer_sk": np.arange(1, n_cust + 1, dtype=np.int64),
            "c_current_cdemo_sk": c_current_cdemo_sk},
        "customer_demographics": {
            "cd_demo_sk": np.arange(1, n_demo + 1, dtype=np.int64),
            "cd_gender": cd_gender,
            "cd_education_status": cd_education_status},
    }


_SS = ("ss_sold_date_sk", dt.INT64), ("ss_item_sk", dt.INT64)
_PRICE = ("ss_sales_price", dt.FLOAT64)
_DATE_SK = ("d_date_sk", dt.INT64)
_ITEM_SK = ("i_item_sk", dt.INT64)

# The scans of each query: table -> schema (the columns it reads, in the
# generator's column order).
SCANS = {
    "q67": {
        "store_sales": _SS + (("ss_store_sk", dt.INT64),
                              ("ss_quantity", dt.FLOAT64), _PRICE),
        "date_dim": (_DATE_SK, ("d_year", dt.INT32), ("d_qoy", dt.INT32),
                     ("d_moy", dt.INT32), ("d_month_seq", dt.INT32)),
        "store": (("s_store_sk", dt.INT64), ("s_store_id", dt.STRING)),
        "item": (_ITEM_SK, ("i_category", dt.STRING),
                 ("i_class", dt.STRING), ("i_brand", dt.STRING),
                 ("i_product_name", dt.STRING)),
    },
    "ds_q3": {
        "store_sales": _SS + (_PRICE,),
        "date_dim": (_DATE_SK, ("d_year", dt.INT32), ("d_moy", dt.INT32)),
        "item": (_ITEM_SK, ("i_category_id", dt.INT64),
                 ("i_brand", dt.STRING)),
    },
    "ds_q42": {
        "store_sales": _SS + (_PRICE,),
        "date_dim": (_DATE_SK, ("d_year", dt.INT32), ("d_qoy", dt.INT32)),
        "item": (_ITEM_SK, ("i_category", dt.STRING)),
    },
    "ds_q89": {
        "store_sales": _SS + (_PRICE,),
        "date_dim": (_DATE_SK, ("d_year", dt.INT32), ("d_moy", dt.INT32)),
        "item": (_ITEM_SK, ("i_category", dt.STRING),
                 ("i_class", dt.STRING)),
    },
    "ds_q55": {
        "store_sales": _SS + (_PRICE,),
        "date_dim": (_DATE_SK, ("d_year", dt.INT32), ("d_moy", dt.INT32)),
        "item": (_ITEM_SK, ("i_brand", dt.STRING)),
    },
    "ds_q98": {
        "store_sales": _SS + (_PRICE,),
        "date_dim": (_DATE_SK, ("d_year", dt.INT32)),
        "item": (_ITEM_SK, ("i_category", dt.STRING),
                 ("i_class", dt.STRING)),
    },
    "xbb_q5": {
        "web_clickstreams": (("wcs_user_sk", dt.INT64),
                             ("wcs_item_sk", dt.INT64)),
        "item": (("i_item_sk", dt.INT64), ("i_category", dt.STRING),
                 ("i_category_id", dt.INT64)),
        "customer": (("c_customer_sk", dt.INT64),
                     ("c_current_cdemo_sk", dt.INT64)),
        "customer_demographics": (("cd_demo_sk", dt.INT64),
                                  ("cd_gender", dt.STRING),
                                  ("cd_education_status", dt.STRING)),
    },
    "xbb_q12": {
        "web_clickstreams": (("wcs_user_sk", dt.INT64),
                             ("wcs_item_sk", dt.INT64)),
        "item": (_ITEM_SK, ("i_category", dt.STRING)),
    },
}


def table_files(n_rows: int) -> int:
    """How many files (partitions) the reference generator writes a table
    of ``n_rows`` in."""
    return FILES_PER_TABLE if n_rows > SPLIT_ABOVE_ROWS else 1


def suite_tables(session, cols: dict, queries=None) -> dict:
    """query -> table -> DataFrame: each query's in-memory scans over
    ``cols`` (``suite_columns`` output), one partition per reference
    file, for ``queries`` (default: every query of ``SCANS``)."""
    out = {}
    for q in (queries or SCANS):
        out[q] = {}
        for t, schema in SCANS[q].items():
            n = len(cols[t][schema[0][0]])
            parts = E.table_partitions(cols[t], schema, table_files(n),
                                       pools=STRING_POOLS)
            out[q][t] = DataFrame(session, L.InMemoryScan(schema, parts))
    return out


def _read(session, tables: dict, table: str):
    return tables[table]


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------

Q67_KEYS = ["i_category", "i_class", "i_brand", "i_product_name",
            "d_year", "d_qoy", "d_moy", "s_store_id"]


def q67(session, tables: dict):
    """TPC-DS q67-like: joins + ROLLUP + rank() window + top-100."""
    from spark_rapids_tpu_torch.plan.logical import (
        Window, agg_sum, coalesce_cols, col, lit_col, rank)
    ss = _read(session, tables, "store_sales")
    dd = _read(session, tables, "date_dim") \
        .filter((col("d_month_seq") >= 1178)
                & (col("d_month_seq") <= 1189))
    st = _read(session, tables, "store")
    it = _read(session, tables, "item")
    j = ss.join_on(dd, ["ss_sold_date_sk"], ["d_date_sk"]) \
        .join_on(st, ["ss_store_sk"], ["s_store_sk"]) \
        .join_on(it, ["ss_item_sk"], ["i_item_sk"]) \
        .with_column("sales",
                     coalesce_cols(col("ss_sales_price")
                                   * col("ss_quantity"), lit_col(0.0)))
    dw1 = j.rollup(*Q67_KEYS).agg(agg_sum(col("sales")).alias("sumsales"))
    w = Window.partition_by("i_category").order_by(col("sumsales").desc())
    dw2 = dw1.with_column("rk", rank().over(w)).filter(col("rk") <= 100)
    return dw2.order_by(*[col(k).asc() for k in Q67_KEYS],
                        col("sumsales").asc(), col("rk").asc()) \
        .limit(100)


def xbb_q5(session, tables: dict):
    """TPCxBB q5-like: per-user conditional-sum pivot + demo joins."""
    from spark_rapids_tpu_torch.plan.logical import (
        agg_sum, col, lit_col, when)
    wcs = _read(session, tables, "web_clickstreams") \
        .filter(col("wcs_user_sk").isNotNull())
    it = _read(session, tables, "item")
    j = wcs.join_on(it, ["wcs_item_sk"], ["i_item_sk"])
    aggs = [agg_sum(when(col("i_category") == lit_col("Books"), 1)
                    .otherwise(0)).alias("clicks_in_category")]
    for i in range(1, 8):
        aggs.append(agg_sum(
            when(col("i_category_id") == lit_col(i), 1).otherwise(0))
            .alias(f"clicks_in_{i}"))
    per_user = j.group_by("wcs_user_sk").agg(*aggs)
    cust = _read(session, tables, "customer")
    demo = _read(session, tables, "customer_demographics")
    out = per_user.join_on(cust, ["wcs_user_sk"], ["c_customer_sk"]) \
        .join_on(demo, ["c_current_cdemo_sk"], ["cd_demo_sk"])
    return out.select(
        col("wcs_user_sk"),
        col("clicks_in_category"),
        when(col("cd_education_status").isin(
            "Advanced Degree", "College", "4 yr Degree", "2 yr Degree"), 1)
        .otherwise(0).alias("college_education"),
        when(col("cd_gender") == lit_col("M"), 1).otherwise(0).alias("male"),
        *[col(f"clicks_in_{i}") for i in range(1, 8)])


def ds_q3(session, tables: dict):
    """TPC-DS q3-like: fact x date x item, November sales by year and
    brand, revenue-ordered."""
    from spark_rapids_tpu_torch.plan.logical import agg_sum, col
    ss = _read(session, tables, "store_sales")
    dd = _read(session, tables, "date_dim").filter(col("d_moy") == 11)
    it = _read(session, tables, "item") \
        .filter(col("i_category_id") == 1)
    return ss.join_on(dd, ["ss_sold_date_sk"], ["d_date_sk"]) \
        .join_on(it, ["ss_item_sk"], ["i_item_sk"]) \
        .group_by("d_year", "i_brand") \
        .agg(agg_sum(col("ss_sales_price")).alias("sum_agg")) \
        .order_by(col("d_year").asc(), col("sum_agg").desc(),
                  col("i_brand").asc()) \
        .limit(100)


def ds_q42(session, tables: dict):
    """TPC-DS q42-like: category revenue for one year by quarter."""
    from spark_rapids_tpu_torch.plan.logical import agg_sum, col
    ss = _read(session, tables, "store_sales")
    dd = _read(session, tables, "date_dim") \
        .filter(col("d_year") == 1999)
    it = _read(session, tables, "item")
    return ss.join_on(dd, ["ss_sold_date_sk"], ["d_date_sk"]) \
        .join_on(it, ["ss_item_sk"], ["i_item_sk"]) \
        .group_by("d_year", "d_qoy", "i_category") \
        .agg(agg_sum(col("ss_sales_price")).alias("revenue")) \
        .order_by(col("revenue").desc(), col("d_year").asc(),
                  col("d_qoy").asc(), col("i_category").asc()) \
        .limit(100)


def ds_q89(session, tables: dict):
    """TPC-DS q89-like: monthly class sales vs the class's yearly monthly
    average (windowed avg + deviation filter)."""
    from spark_rapids_tpu_torch.plan.logical import (
        Window, agg_avg, agg_sum, col)
    ss = _read(session, tables, "store_sales")
    dd = _read(session, tables, "date_dim") \
        .filter(col("d_year") == 1999)
    it = _read(session, tables, "item")
    monthly = ss.join_on(dd, ["ss_sold_date_sk"], ["d_date_sk"]) \
        .join_on(it, ["ss_item_sk"], ["i_item_sk"]) \
        .group_by("i_category", "i_class", "d_moy") \
        .agg(agg_sum(col("ss_sales_price")).alias("sum_sales"))
    w = Window.partition_by("i_category", "i_class")
    out = monthly.with_column("avg_monthly_sales",
                              agg_avg(col("sum_sales")).over(w))
    return out.filter(
        (col("sum_sales") - col("avg_monthly_sales"))
        / col("avg_monthly_sales") > 0.1) \
        .order_by(col("i_category").asc(), col("i_class").asc(),
                  col("d_moy").asc())


def ds_q55(session, tables: dict):
    """TPC-DS q55-like: one month's brand revenue, top-100."""
    from spark_rapids_tpu_torch.plan.logical import agg_sum, col
    ss = _read(session, tables, "store_sales")
    dd = _read(session, tables, "date_dim") \
        .filter((col("d_moy") == 12) & (col("d_year") == 1998))
    it = _read(session, tables, "item")
    return ss.join_on(dd, ["ss_sold_date_sk"], ["d_date_sk"]) \
        .join_on(it, ["ss_item_sk"], ["i_item_sk"]) \
        .group_by("i_brand") \
        .agg(agg_sum(col("ss_sales_price")).alias("ext_price")) \
        .order_by(col("ext_price").desc(), col("i_brand").asc()) \
        .limit(100)


def ds_q98(session, tables: dict):
    """TPC-DS q98-like: class revenue with its share of the category
    total (window SUM ratio)."""
    from spark_rapids_tpu_torch.plan.logical import Window, agg_sum, col
    ss = _read(session, tables, "store_sales")
    dd = _read(session, tables, "date_dim") \
        .filter(col("d_year") == 1999)
    it = _read(session, tables, "item") \
        .filter(col("i_category").isin("Books", "Home", "Sports"))
    per_class = ss.join_on(dd, ["ss_sold_date_sk"], ["d_date_sk"]) \
        .join_on(it, ["ss_item_sk"], ["i_item_sk"]) \
        .group_by("i_category", "i_class") \
        .agg(agg_sum(col("ss_sales_price")).alias("itemrevenue"))
    w = Window.partition_by("i_category")
    return per_class \
        .with_column("cat_total", agg_sum(col("itemrevenue")).over(w)) \
        .select(col("i_category"), col("i_class"), col("itemrevenue"),
                (col("itemrevenue") * 100.0 / col("cat_total"))
                .alias("revenueratio")) \
        .order_by(col("i_category").asc(), col("i_class").asc())


def xbb_q12(session, tables: dict):
    """TPCxBB q12-like: distinct browsing users per category (COUNT
    DISTINCT through the partial/merge distinct pipeline)."""
    from spark_rapids_tpu_torch.plan.logical import agg_count_distinct, col
    wcs = _read(session, tables, "web_clickstreams") \
        .filter(col("wcs_user_sk").isNotNull())
    it = _read(session, tables, "item")
    return wcs.join_on(it, ["wcs_item_sk"], ["i_item_sk"]) \
        .group_by("i_category") \
        .agg(agg_count_distinct(col("wcs_user_sk")).alias("users")) \
        .order_by(col("i_category").asc())


# The reference's suite minus ``repart`` (the exchange), which is not
# ported.
QUERIES = {"q67": q67, "xbb_q5": xbb_q5, "ds_q3": ds_q3, "ds_q42": ds_q42,
           "ds_q89": ds_q89, "ds_q55": ds_q55, "ds_q98": ds_q98,
           "xbb_q12": xbb_q12}
