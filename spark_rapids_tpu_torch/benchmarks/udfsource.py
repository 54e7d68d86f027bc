"""Queries over the port's UDF tier, through the DataFrame API, on the
TPC-H generator's tables:

- (a) ``q1_udf``: TPC-H q1 (``benchmarks/tpch.py``) with its ship-date
  filter and both derived columns written as ``udf`` lambdas, and a
  quantity band (``1 if q > 25.0 else 0``) summed beside q1's aggregates.
  Every UDF compiles, so the plan is q1's with one more sum.
- (b) ``order_ranks``: ORDERS placed before ``RANK_CUTOFF`` (about half of
  them) through two UDFs that do not compile, ``PRIORITY_RANK`` looked up
  in a dict (a captured non-literal) and ``vowels`` (a loop over the
  comment), grouped by the rank: count, sum and max of the price, and
  the vowels' sum. Each runs on the host, row by row, inside the device
  plan.
- (c) the pandas UDFs: ``pandas_map`` (``map_in_pandas``),
  ``pandas_apply`` (``apply_in_pandas`` by priority), ``pandas_agg``
  (``agg_in_pandas`` by status) and ``pandas_cogroup`` (ORDERS by
  priority cogrouped with a five-row weight table, one priority missing
  from it and one only in it). Each selects the columns its function
  reads first: nothing below a pandas node is pruned, so a function is
  handed whatever its child produces. They need pandas where they run.

Each function takes the DSL module ``L`` (``plan/logical.py`` of the port,
or any module with the same functions) and ``udf`` of the same package,
so the tests build each query on both packages and compare.

    session = TpuSession({"spark.rapids.sql.variableFloatAgg.enabled": True})
    t = tpch.tpch_tables(session, entry.tpch_columns(1.0), ("q1",))
    rows = q1_udf(L, udf, t["q1"]["lineitem"]).collect()
"""

from __future__ import annotations

from spark_rapids_tpu_torch.entry import PRIORITIES, days

Q1_CUTOFF = days("1998-09-02")
RANK_CUTOFF = days("1995-04-17")
PRIORITY_RANK = {p: i + 1 for i, p in enumerate(PRIORITIES)}
# (c)'s weight table: four of the five priorities and one of its own.
WEIGHTS = {"w_priority": ["1-URGENT", "2-HIGH", "3-MEDIUM", "5-LOW",
                          "9-NONE"],
           "w": [5.0, 4.0, 3.0, 1.0, 0.5]}


def q1_udfs(udf) -> dict:
    """(a)'s UDFs. Each lambda is a statement of its own: the compiler
    reads a lambda's source line, and cuts one inside a bracketed list at
    its first comma."""
    shipped = udf(lambda d: d <= Q1_CUTOFF)
    disc_price = udf(lambda p, d: p * (1.0 - d))
    charge = udf(lambda p, d, t: p * (1.0 - d) * (1.0 + t))
    band = udf(lambda q: 1 if q > 25.0 else 0)
    return {"shipped": shipped, "disc_price": disc_price, "charge": charge,
            "band": band}


def q1_udf(L, udf, lineitem):
    """(a) q1 with ``udf`` lambdas for its filter and derived columns, and
    ``sum_band``: the lines of more than 25 units in each group."""
    c = L.col
    u = q1_udfs(udf)
    price, disc = c("l_extendedprice"), c("l_discount")
    lines = lineitem.filter(u["shipped"](c("l_shipdate"))) \
        .with_column("disc_price", u["disc_price"](price, disc)) \
        .with_column("charge", u["charge"](price, disc, c("l_tax"))) \
        .with_column("band", u["band"](c("l_quantity")))
    return lines.group_by("l_returnflag", "l_linestatus").agg(
        L.agg_sum(c("l_quantity")).alias("sum_qty"),
        L.agg_sum(c("l_extendedprice")).alias("sum_base_price"),
        L.agg_sum(c("disc_price")).alias("sum_disc_price"),
        L.agg_sum(c("charge")).alias("sum_charge"),
        L.agg_avg(c("l_quantity")).alias("avg_qty"),
        L.agg_avg(c("l_extendedprice")).alias("avg_price"),
        L.agg_avg(c("l_discount")).alias("avg_disc"),
        L.agg_count().alias("count_order"),
        L.agg_sum(c("band")).alias("sum_band"),
    ).order_by("l_returnflag", "l_linestatus")


def vowels(s):
    """Lower-case vowels in ``s`` (a loop: it does not compile)."""
    n = 0
    for ch in s:
        if ch in "aeiou":
            n += 1
    return n


def rank_udfs(udf) -> dict:
    """(b)'s two UDFs: the priority's rank and the comment's vowels."""
    rank = udf(lambda p: PRIORITY_RANK[p], return_type="int")
    count = udf(vowels, return_type="int")
    return {"rank": rank, "vowels": count}


def order_ranks(L, udf, orders):
    """(b) Orders before ``RANK_CUTOFF`` by the rank of their priority:
    count, revenue, the largest price and the comments' vowels."""
    c = L.col
    u = rank_udfs(udf)
    price = c("o_totalprice")
    return orders.filter(c("o_orderdate") < L.lit_col(RANK_CUTOFF)) \
        .with_column("rank", u["rank"](c("o_orderpriority"))) \
        .with_column("vowels", u["vowels"](c("o_comment"))) \
        .group_by("rank").agg(
            L.agg_count().alias("n"), L.agg_sum(price).alias("revenue"),
            L.agg_max(price).alias("top"),
            L.agg_sum(c("vowels")).alias("vowels")).order_by("rank")


def _thousands(frames):
    for f in frames:
        yield f.assign(price_k=f.o_totalprice / 1000.0)[
            ["o_orderkey", "price_k"]]


def pandas_map(L, orders):
    """(c) ``map_in_pandas``: each order's price in thousands."""
    return orders.select("o_orderkey", "o_totalprice").map_in_pandas(
        _thousands, [("o_orderkey", L.dt.INT64), ("price_k", L.dt.FLOAT64)])


def _priority_summary(pdf):
    import pandas as pd
    return pd.DataFrame({"o_orderpriority": [pdf.o_orderpriority.iloc[0]],
                         "n": [len(pdf)],
                         "top": [float(pdf.o_totalprice.max())],
                         "low": [float(pdf.o_totalprice.min())]})


def pandas_apply(L, orders):
    """(c) ``apply_in_pandas`` by priority: count, largest and smallest
    price."""
    return orders.select("o_orderpriority", "o_totalprice").group_by(
        "o_orderpriority").apply_in_pandas(
        _priority_summary, [("o_orderpriority", L.dt.STRING),
                            ("n", L.dt.INT64), ("top", L.dt.FLOAT64),
                            ("low", L.dt.FLOAT64)])


def pandas_agg(L, orders):
    """(c) ``agg_in_pandas`` by status: count, least and largest price."""
    return orders.select("o_orderstatus", "o_totalprice").group_by(
        "o_orderstatus").agg_in_pandas(
        n=("o_totalprice", lambda s: int(len(s)), L.dt.INT64),
        low=("o_totalprice", lambda s: float(s.min()), L.dt.FLOAT64),
        top=("o_totalprice", lambda s: float(s.max()), L.dt.FLOAT64))


def _weighted(lp, rp):
    import pandas as pd
    key = lp.o_orderpriority.iloc[0] if len(lp) else rp.w_priority.iloc[0]
    w = float(rp.w.iloc[0]) if len(rp) else 0.0
    return pd.DataFrame({"priority": [key], "n": [len(lp)],
                         "weighted": [w * len(lp)]})


def weights(session, L):
    """(c)'s weight table as a DataFrame of ``session``."""
    return session.create_dataframe(
        WEIGHTS, [("w_priority", L.dt.STRING), ("w", L.dt.FLOAT64)])


def pandas_cogroup(L, orders, weight_table):
    """(c) ``cogroup(...).apply_in_pandas``: per priority of either side,
    the orders and their count times the priority's weight (0 where it
    has none)."""
    return orders.select("o_orderpriority").group_by(
        "o_orderpriority").cogroup(
        weight_table.group_by("w_priority")).apply_in_pandas(
            _weighted, [("priority", L.dt.STRING), ("n", L.dt.INT64),
                        ("weighted", L.dt.FLOAT64)])
