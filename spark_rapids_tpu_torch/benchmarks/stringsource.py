"""Queries over the port's string surface and generate, through the
DataFrame API, on the TPC-H generator's tables:

- (a) ORDERS string ETL: ``orders_etl`` projects case maps, length,
  reverse, repeat, trims, substring_index, split, locate / instr, concat,
  concat_ws (NULL on a seventh of the rows), md5 and casts of the order
  key, date and price to strings and back; ``comment_groups`` groups by
  the comment's first word and the priority with string Min/Max.
- (b) CUSTOMER and PART through the host-roundtrip kinds
  (``customer_keys``: regexp_replace, regexp_extract, replace, lpad and a
  key parsed from the name; ``part_labels``: translate, rpad) and
  ``country_revenue``: ORDERS joined to CUSTOMER on that parsed key,
  grouped by the extracted country code.
- (c) explode over LINEITEM: ``date_positions`` (posexplode of the three
  dates by position and year), ``ship_labels`` (explode of two labels)
  and ``outer_labels`` (explode_outer of two conditional labels, the
  NULL group included).

Each function takes the DSL module ``L`` (``plan/logical.py`` of the port,
or any module with the same functions), so the tests build each query on
both packages and compare.

    session = TpuSession({"spark.rapids.sql.variableFloatAgg.enabled": True,
                          "spark.rapids.sql.incompatibleOps.enabled": True,
                          "spark.rapids.sql.castFloatToString.enabled": True,
                          "spark.rapids.sql.castStringToFloat.enabled": True})
    t = tables(session, entry.tpch_columns(1.0))
    rows = orders_etl(L, t["orders"]).collect()

``orders_etl`` is three projections: the case maps and the float format,
the float parse, then the rest; the default conf places the first two on
the host engine (the reference's case-mapping and float-cast gates) and
the third on the card. ``country_revenue``'s float sum runs on the host
engine under the default conf.
"""

from __future__ import annotations

from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch.columnar import dtypes as dt

ORDERS = (("o_orderkey", dt.INT64), ("o_custkey", dt.INT64),
          ("o_orderstatus", dt.STRING), ("o_totalprice", dt.FLOAT64),
          ("o_orderdate", dt.DATE), ("o_orderpriority", dt.STRING),
          ("o_comment", dt.STRING))
CUSTOMER = (("c_custkey", dt.INT64), ("c_name", dt.STRING),
            ("c_phone", dt.STRING), ("c_mktsegment", dt.STRING))
PART = (("p_partkey", dt.INT64), ("p_name", dt.STRING),
        ("p_brand", dt.STRING))
LINEITEM = (("l_quantity", dt.FLOAT64), ("l_discount", dt.FLOAT64),
            ("l_shipdate", dt.DATE), ("l_commitdate", dt.DATE),
            ("l_receiptdate", dt.DATE), ("l_shipmode", dt.STRING),
            ("l_shipinstruct", dt.STRING))
SCHEMAS = {"orders": ORDERS, "customer": CUSTOMER, "part": PART,
           "lineitem": LINEITEM}

# The conf that puts every node of these queries on the card.
ALL_DEVICE = {"spark.rapids.sql.variableFloatAgg.enabled": True,
              "spark.rapids.sql.incompatibleOps.enabled": True,
              "spark.rapids.sql.castFloatToString.enabled": True,
              "spark.rapids.sql.castStringToFloat.enabled": True}

# orders_etl's columns, in order.
ETL_COLUMNS = (
    "o_orderkey", "upper", "lower", "initcap", "length", "reverse",
    "repeat", "trim", "ltrim", "rtrim", "before2", "after1", "word1",
    "locate_the", "instr_ly", "prio_status", "dashed", "md5", "key_s",
    "date_s", "price_s", "key_back", "date_back", "price_back")


def tables(session, cols: dict, partitions=None, rows=None) -> dict:
    """ORDERS, CUSTOMER, PART and LINEITEM (``SCHEMAS``' columns of
    ``entry.tpch_columns`` output, the first ``rows`` rows of each or
    all) as in-memory DataFrames in ``partitions`` row ranges (default:
    the generator's split, 8 / 4 / 4 / 8)."""
    from spark_rapids_tpu_torch.api.dataframe import DataFrame
    from spark_rapids_tpu_torch.plan import logical as L
    out = {}
    for t, schema in SCHEMAS.items():
        data = {n: cols[t][n][:rows] for n, _ in schema}
        out[t] = DataFrame(session, L.InMemoryScan(schema, E.table_partitions(
            data, schema, partitions or E.TABLE_PARTITIONS[t])))
    return out


def orders_etl(L, orders):
    """(a) One row an order: the string functions over its comment,
    priority and status, and its key, date and price cast to strings and
    back."""
    c = L.col
    comment = c("o_comment")
    cased = orders.select(
        c("o_orderkey"), c("o_orderdate"), c("o_totalprice"),
        c("o_orderstatus"), c("o_orderpriority"), comment,
        L.upper(comment).alias("upper"),
        L.lower(c("o_orderpriority")).alias("lower"),
        L.initcap(comment).alias("initcap"),
        c("o_totalprice").cast("string").alias("price_s"))
    parsed = cased.with_column("price_back",
                               c("price_s").cast("double"))
    padded = L.concat(L.lit_col("  "), comment, L.lit_col("  "))
    etl = parsed.select(
        c("o_orderkey"), c("upper"), c("lower"), c("initcap"),
        L.length(comment).alias("length"),
        L.reverse(comment).alias("reverse"),
        L.repeat(c("o_orderstatus"), 3).alias("repeat"),
        L.trim(padded).alias("trim"), L.ltrim(padded).alias("ltrim"),
        L.rtrim(padded).alias("rtrim"),
        L.substring_index(comment, " ", 2).alias("before2"),
        L.substring_index(comment, " ", -1).alias("after1"),
        L.split(comment, " ", 1).alias("word1"),
        L.locate("the", comment).alias("locate_the"),
        L.instr(comment, "ly").alias("instr_ly"),
        L.concat(c("o_orderpriority"), L.lit_col("|"),
                 c("o_orderstatus")).alias("prio_status"),
        L.concat_ws("-", L.when(c("o_orderkey") % 7 == 0,
                                c("o_orderstatus")),
                    c("o_orderpriority"), comment).alias("dashed"),
        L.md5(comment).alias("md5"),
        c("o_orderkey").cast("string").alias("key_s"),
        c("o_orderdate").cast("string").alias("date_s"),
        c("price_s"), c("price_back"))
    return etl.with_column("key_back", c("key_s").cast("long")).with_column(
        "date_back", c("date_s").cast("date")).select(
        *[c(n) for n in ETL_COLUMNS])


def etl_head(L, orders, n: int):
    """The first ``n`` rows of ``orders_etl`` by order key (the keys
    ascend in scan order)."""
    return orders_etl(L, orders).order_by("o_orderkey").limit(n)


def comment_groups(L, orders):
    """(a) Orders by the comment's first word and the priority: the count,
    the longest comment, the first 'the', the least MD5 and the greatest
    reversed comment."""
    c = L.col
    comment = c("o_comment")
    return orders.group_by(
        L.split(comment, " ", 0).alias("w0"), c("o_orderpriority")).agg(
        L.agg_count().alias("n"),
        L.agg_max(L.length(comment)).alias("max_len"),
        L.agg_min(L.locate("the", comment)).alias("min_the"),
        L.agg_min(L.md5(comment)).alias("min_md5"),
        L.agg_max(L.reverse(comment)).alias("max_rev")).order_by(
        "w0", "o_orderpriority")


def customer_keys(L, customer):
    """(b) CUSTOMER through the host-roundtrip kinds, with its key parsed
    back from the name (``Customer#000000042`` -> 42)."""
    c = L.col
    return customer.select(
        c("c_custkey"),
        c("c_phone").rlike_replace("-", "").alias("phone_digits"),
        L.regexp_extract(c("c_phone"), r"^(\d+)-", 1).alias("country"),
        L.replace_str(c("c_mktsegment"), "AUTO", "auto").alias("segment"),
        L.lpad(c("c_name"), 20, "*").alias("name20"),
        L.lpad(c("c_name"), 8).alias("name8"),
        L.substring_index(c("c_name"), "#", -1).cast("long").alias("ck"))


def part_labels(L, part):
    """(b) PART's name with upper-case vowels and its brand padded to 12."""
    c = L.col
    return part.select(
        c("p_partkey"),
        L.translate(c("p_name"), "aeiou", "AEIOU").alias("name_uc"),
        L.rpad(c("p_brand"), 12, ".").alias("brand12"))


def country_revenue(L, orders, customer):
    """(b) ORDERS joined to CUSTOMER on the key parsed from the name, by
    the country code extracted from the phone: count and revenue."""
    c = L.col
    cust = customer_keys(L, customer).select(c("ck"), c("country"))
    return orders.join_on(cust, ["o_custkey"], ["ck"]).group_by(
        "country").agg(L.agg_count().alias("n"),
                       L.agg_sum(c("o_totalprice")).alias("revenue")) \
        .order_by("country")


def date_positions(L, li):
    """(c) posexplode of the three dates of a line: rows by position and
    year."""
    c = L.col
    return li.select(L.posexplode(
        c("l_shipdate"), c("l_commitdate"), c("l_receiptdate")).alias(
        "d")).group_by(c("d__pos").alias("pos"),
                       L.year(c("d")).alias("y")).agg(
        L.agg_count().alias("n")).order_by("pos", "y")


def ship_labels(L, li):
    """(c) explode of the ship mode and instruction: rows by label."""
    c = L.col
    return li.select(L.explode(c("l_shipmode"), c("l_shipinstruct")).alias(
        "label")).group_by("label").agg(L.agg_count().alias("n")) \
        .order_by("label")


def outer_labels(L, li):
    """(c) explode_outer of the ship mode of large lines and the
    instruction of discounted ones: rows by label, a line with neither
    one NULL row."""
    c = L.col
    return li.select(L.explode_outer(
        L.when(c("l_quantity") > 45, c("l_shipmode")),
        L.when(c("l_discount") > 0.09, c("l_shipinstruct"))).alias(
        "label")).group_by("label").agg(L.agg_count().alias("n")) \
        .order_by("label")
