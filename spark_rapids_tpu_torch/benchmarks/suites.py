"""TPCxBB q5 through the port's DataFrame API (port of the JAX package's
``benchmarks/suites.py``: its generator's stream and the ``xbb_q5`` query
body).

``suite_columns(scale, seed)`` replays the reference generator
(``suites.generate``) draw for draw, numpy over one ``default_rng(seed)``
stream: the TPC-DS tables are drawn first, in the same order, and all but
``item`` discarded; then ``web_clickstreams`` (``wcs_user_sk`` NULL in
about 5% of rows, a numpy masked array here), ``customer`` and
``customer_demographics``. So the same scale and seed give the
reference's rows. String columns are codes into a pool (``STRING_POOLS``).

``xbb_q5`` is the reference's body, line for line; only ``_read``
differs: a query reads its tables from a dict of DataFrames, which
``suite_tables`` builds as in-memory scans holding exactly the columns
the reference's scan pruning keeps, each table in the reference's files
(``FILES_PER_TABLE`` above 100,000 rows, else 1).

    session = TpuSession()
    tables = suite_tables(session, suite_columns(1.0))
    rows = xbb_q5(session, tables["xbb_q5"]).collect()

The query's sums are integer (Sum of an INT32 CASE), so it stays on the
card under every conf.
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
STRING_POOLS = {"i_category": CATEGORIES, "cd_gender": GENDERS,
                "cd_education_status": EDU}
# The reference generator's rule (at its default of 8 files a table):
# tables above ``SPLIT_ABOVE_ROWS`` rows are split into
# ``FILES_PER_TABLE`` files, the rest written as one.
SPLIT_ABOVE_ROWS = 100_000
FILES_PER_TABLE = 8


def suite_columns(scale: float = 1.0, seed: int = 0) -> dict:
    """The columns TPCxBB q5 reads, as numpy arrays per table: the JAX
    package's ``suites.generate`` stream (its TPC-DS draws made and
    dropped), so ``scale`` and ``seed`` give its rows."""
    rng = np.random.default_rng(seed)
    # -- TPC-DS-like: item kept, the rest drawn and dropped ---------------
    n_item = max(int(18_000 * scale), 100)
    n_dates = 731
    n_ss = max(int(2_880_000 * scale), 1000)
    n_store = max(int(12 * scale), 4)
    i_category = rng.integers(0, len(CATEGORIES), n_item)
    i_category_id = rng.integers(1, 11, n_item, dtype=np.int64)
    rng.integers(0, 40, n_item)                    # i_class
    rng.integers(0, 200, n_item)                   # i_brand
    rng.integers(0, 5000, n_item)                  # i_product_name
    rng.integers(1, n_dates + 1, n_ss, dtype=np.int64)
    rng.integers(1, n_item + 1, n_ss, dtype=np.int64)
    rng.integers(1, n_store + 1, n_ss, dtype=np.int64)
    rng.integers(1, 100, n_ss)                     # ss_quantity
    rng.integers(1, 200, n_ss)                     # ss_sales_price
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
            "i_category": i_category, "i_category_id": i_category_id},
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


# The scans of each query: table -> schema (the columns it reads, in the
# generator's column order).
SCANS = {
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
}


def table_files(n_rows: int) -> int:
    """How many files (partitions) the reference generator writes a table
    of ``n_rows`` in."""
    return FILES_PER_TABLE if n_rows > SPLIT_ABOVE_ROWS else 1


def suite_tables(session, cols: dict) -> dict:
    """query -> table -> DataFrame: each query's in-memory scans over
    ``cols`` (``suite_columns`` output), one partition per reference
    file."""
    out = {}
    for q, scans in SCANS.items():
        out[q] = {}
        for t, schema in scans.items():
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


QUERIES = {"xbb_q5": xbb_q5}
