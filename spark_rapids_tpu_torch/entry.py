"""Entry points of the port: the flagship q1-shaped step, the hand-built
TPC-H q1, q2, q3 and q4 trees, and the TPC-H columns every query of the
front end reads.

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
- ``tpch_q2_plan(tables, device=None)`` (minimum-cost supplier: a min
  aggregate over partsupp joined back to the BRASS parts of size 15,
  top 100) builds the exec tree the JAX package's planner builds for
  ``tpch.q2`` at SF1 with default conf; ``tpch_q2_tables`` makes its
  scans, the column-pruned ones included.
- ``tpch_columns`` holds every column TPC-H q1-q9, q12, q14 and q19
  read; ``Q5_*`` ... ``Q19_*`` name those queries' scans (and q5's and
  q6's constants). The DataFrame front end runs all twelve from the
  reference's query text (``benchmarks/tpch.py``); the hand-built trees
  above are the comparison for q1-q4.

``device=None`` means the CUDA card and raises when there is none; pass
``device="cpu"`` for the plain-PyTorch path.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence

import numpy as np

from spark_rapids_tpu_torch import DeviceLike, resolve_device
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.host import (
    HostBatch, HostColumn, host_to_device)
from spark_rapids_tpu_torch.exprs import (
    Add, And, BoundReference as Ref, EndsWith, EqualTo, GreaterThan,
    GreaterThanOrEqual, LessThan, LessThanOrEqual, Literal, Multiply,
    Subtract, lit)
from spark_rapids_tpu_torch.exprs.base import as_device_column
from spark_rapids_tpu_torch.ops import (
    AggSpec, Average, BroadcastHashJoinExec, CoalescePartitionsExec,
    CountStar, FilterExec, GlobalLimitExec, HashAggregateExec,
    InMemorySourceExec, LocalLimitExec, Min, ProjectExec, SortExec,
    SortOrder, Sum)

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
# (the JAX package's ``benchmarks/tpch.py`` PRIORITIES, SEGMENTS,
# SHIPMODES, SHIPINSTRUCT, P_WORDS, P_TYPE_1..3, P_CONTAINER_1..2,
# O_COMMENTS, S_COMMENTS, NATIONS and REGIONS).
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
SHIPMODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
SHIPINSTRUCT = ("DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN")
P_WORDS = (
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower",
    "cornsilk", "cream", "cyan", "dark", "deep", "dim", "dodger", "drab",
    "firebrick", "floral", "forest", "frosted", "gainsboro", "ghost",
    "goldenrod", "green", "grey", "honeydew", "hot", "indian", "ivory",
    "khaki", "lace", "lavender", "lawn", "lemon", "light", "lime", "linen",
    "magenta", "maroon", "medium", "metallic", "midnight", "mint", "misty",
    "moccasin", "navajo", "navy", "olive", "orange", "orchid", "pale",
    "papaya", "peach", "peru", "pink", "plum", "powder", "puff", "purple",
    "red", "rose", "rosy", "royal", "saddle", "salmon", "sandy", "seashell",
    "sienna", "sky", "slate", "smoke", "snow", "spring", "steel", "tan",
    "thistle", "tomato", "turquoise", "violet", "wheat", "white", "yellow")
P_TYPE_1 = ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO")
P_TYPE_2 = ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
P_TYPE_3 = ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")
P_CONTAINER_1 = ("SM", "LG", "MED", "JUMBO", "WRAP")
P_CONTAINER_2 = ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM")
# A few match q13's NOT LIKE '%special%requests%' and q16's
# '%Customer%Complaints%'.
O_COMMENTS = (
    "carefully final deposits haggle", "quickly ironic packages wake",
    "furiously regular accounts sleep", "pending theodolites nag idly",
    "slyly even instructions boost", "blithely bold pinto beans detect",
    "ironic foxes above the accounts", "express waters cajole carefully",
    "silent requests along the pains", "unusual deposits engage daringly",
    "regular ideas use furiously", "enticing platelets among the ideas",
    "special packages wake slyly requests",
    "special pinto beans use quickly regular requests")
S_COMMENTS = (
    "blithely regular packages boost", "carefully silent foxes detect",
    "quickly final deposits about the ideas", "furiously even pearls wake",
    "pending pains sleep slyly", "express dolphins above the packages",
    "regular warhorses cajole daringly", "ironic courts haggle quietly",
    "Customer recounts wake Complaints",
    "Customer accounts nag slyly Complaints")
NATIONS = (
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1))
REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")


def _pool_matrix(pool) -> tuple:
    w = max(len(v) for v in pool)
    m = np.zeros((len(pool), w), np.uint8)
    for i, v in enumerate(pool):
        m[i, :len(v)] = np.frombuffer(v.encode(), np.uint8)
    return m, np.array([len(v) for v in pool], np.int32)


def _digits(v: np.ndarray, width: int) -> np.ndarray:
    """(n, width) uint8: ``v`` in decimal, zero-padded to ``width``."""
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return (48 + (v.astype(np.int64)[:, None] // p) % 10).astype(np.uint8)


def _concat_strings(*pieces) -> np.ndarray:
    """Row-wise concatenation of string pieces, each a zero-padded (n, w)
    uint8 matrix or a bytes literal, into one zero-padded matrix (a built
    string column such as ``s_phone`` or ``p_type``, which has no pool)."""
    n = next(len(p) for p in pieces if isinstance(p, np.ndarray))
    mats = [np.broadcast_to(np.frombuffer(p, np.uint8), (n, len(p)))
            if isinstance(p, bytes) else p for p in pieces]
    out = np.zeros((n, sum(m.shape[1] for m in mats)), np.uint8)
    off = np.zeros(n, np.int64)
    rows = np.arange(n)
    for m in mats:
        lens = (m != 0).sum(axis=1)
        for j in range(m.shape[1]):
            keep = j < lens
            out[rows[keep], off[keep] + j] = m[keep, j]
        off += lens
    return out[:, :max(int(off.max()), 1)]


def tpch_columns(scale: float, seed: int = 0) -> dict:
    """The columns the 22 TPC-H queries read, as numpy arrays per table
    (``{"lineitem": {...}, "orders": {...}, "customer": {...}, "part":
    {...}, "partsupp": {...}, "supplier": {...}, "nation": {...},
    "region": {...}}``): the JAX package's TPC-H generator
    (``benchmarks/tpch.py`` ``generate``), drawing its whole random stream
    in its order, so ``seed`` and ``scale`` give its rows. String columns
    are one of three forms: ``l_returnflag``, ``l_linestatus`` and
    ``o_orderstatus`` are (n,) uint8 character codes; the columns of
    ``_STRING_POOLS`` are codes into a pool; built strings (``p_name``,
    ``p_mfgr``, ``p_brand``, ``p_type``, ``p_container``, ``s_name``,
    ``s_phone``, ``c_name``, ``c_phone``) are zero-padded (n, w) uint8
    matrices."""
    rng = np.random.default_rng(seed)
    n_ord = max(int(1_500_000 * scale), 10)
    n_cust = max(int(150_000 * scale), 5)
    n_supp = max(int(10_000 * scale), 3)
    n_part = max(int(200_000 * scale), 8)
    # Orders before it are fulfilled ("F"), lines received by it returned
    # or accepted, lines shipped after it open.
    cutoff = days("1995-06-17")
    # ORDERS: custkey, orderdate, status coin, totalprice, priority, comment.
    o_orderkey = np.arange(1, n_ord + 1, dtype=np.int64)
    o_custkey = rng.integers(1, max(n_cust * 2 // 3, 2), n_ord,
                             dtype=np.int64)
    o_orderdate = rng.integers(days("1992-01-01"), days("1998-08-02"),
                               n_ord, dtype=np.int64).astype(np.int32)
    coin = rng.integers(0, 2, n_ord)
    o_orderstatus = np.where(o_orderdate < cutoff, ord("F"),
                             np.where(coin == 0, ord("O"), ord("P")))
    o_totalprice = np.round(rng.uniform(900.0, 500_000.0, n_ord), 2)
    o_orderpriority = rng.integers(0, len(PRIORITIES), n_ord)
    o_comment = rng.integers(0, len(O_COMMENTS), n_ord)
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
    ra = rng.integers(0, 2, n_li)
    returnflag = np.where(l_receiptdate <= cutoff,
                          np.where(ra == 0, ord("A"), ord("R")), ord("N"))
    linestatus = np.where(l_shipdate > cutoff, ord("O"), ord("F"))
    # Each line's supplier is one of its part's 4 (the generator's
    # formula).
    l_partkey = rng.integers(1, n_part + 1, n_li, dtype=np.int64)
    l_suppkey = ((l_partkey + rng.integers(0, 4, n_li) * (n_supp // 4 + 1))
                 % n_supp) + 1
    l_shipmode = rng.integers(0, len(SHIPMODES), n_li)
    l_shipinstruct = rng.integers(0, len(SHIPINSTRUCT), n_li)
    # PART: name words, type, container, brand, size, retail price.
    words = _pool_matrix(P_WORDS)[0]
    w1, w2, w3 = (rng.integers(0, len(P_WORDS), n_part) for _ in range(3))
    p_name = _concat_strings(words[w1], b" ", words[w2], b" ", words[w3])
    t1, t2, t3 = (rng.integers(0, len(pool), n_part)
                  for pool in (P_TYPE_1, P_TYPE_2, P_TYPE_3))
    p_type = _concat_strings(_pool_matrix(P_TYPE_1)[0][t1], b" ",
                             _pool_matrix(P_TYPE_2)[0][t2], b" ",
                             _pool_matrix(P_TYPE_3)[0][t3])
    c1, c2 = (rng.integers(0, len(pool), n_part)
              for pool in (P_CONTAINER_1, P_CONTAINER_2))
    p_container = _concat_strings(_pool_matrix(P_CONTAINER_1)[0][c1], b" ",
                                  _pool_matrix(P_CONTAINER_2)[0][c2])
    brand_m = rng.integers(1, 6, n_part)
    brand_n = rng.integers(1, 6, n_part)
    p_size = rng.integers(1, 51, n_part).astype(np.int32)
    p_retailprice = np.round(rng.uniform(900.0, 2000.0, n_part), 2)
    # PARTSUPP: 4 suppliers a part (the generator's formula); availqty,
    # supplycost.
    p_partkey = np.arange(1, n_part + 1, dtype=np.int64)
    ps_partkey = np.repeat(p_partkey, 4)
    ps_i = np.tile(np.arange(4), n_part)
    ps_suppkey = ((ps_partkey + ps_i * (n_supp // 4 + 1)) % n_supp) + 1
    ps_availqty = rng.integers(1, 10_000, 4 * n_part).astype(np.int32)
    ps_supplycost = np.round(rng.uniform(1.0, 1000.0, 4 * n_part), 2)
    # CUSTOMER: nationkey, phone parts (country code 10 + nationkey),
    # market segment, account balance, address, comment.
    c_nationkey = rng.integers(0, 25, n_cust, dtype=np.int64)
    a, b, c = (rng.integers(lo, hi, n_cust) for lo, hi in
               ((100, 1000), (100, 1000), (1000, 10000)))
    c_phone = _concat_strings(_digits(10 + c_nationkey, 2), b"-",
                              _digits(a, 3), b"-", _digits(b, 3), b"-",
                              _digits(c, 4))
    c_mktsegment = rng.integers(0, len(SEGMENTS), n_cust)
    c_acctbal = np.round(rng.uniform(-999.99, 9999.99, n_cust), 2)
    c_address = rng.integers(0, len(O_COMMENTS), n_cust)
    c_comment = rng.integers(0, len(O_COMMENTS), n_cust)
    c_custkey = np.arange(1, n_cust + 1, dtype=np.int64)
    # SUPPLIER: nationkey, phone parts (country code 10 + nationkey),
    # account balance, address, comment.
    s_nationkey = rng.integers(0, 25, n_supp, dtype=np.int64)
    a, b, c = (rng.integers(lo, hi, n_supp) for lo, hi in
               ((100, 1000), (100, 1000), (1000, 10000)))
    s_phone = _concat_strings(_digits(10 + s_nationkey, 2), b"-",
                              _digits(a, 3), b"-", _digits(b, 3), b"-",
                              _digits(c, 4))
    s_acctbal = np.round(rng.uniform(-999.99, 9999.99, n_supp), 2)
    s_address = rng.integers(0, len(S_COMMENTS), n_supp)
    s_comment = rng.integers(0, len(S_COMMENTS), n_supp)
    s_suppkey = np.arange(1, n_supp + 1, dtype=np.int64)
    return {
        "lineitem": {
            "l_orderkey": l_orderkey, "l_partkey": l_partkey,
            "l_suppkey": l_suppkey, "l_quantity": l_quantity,
            "l_extendedprice": l_extendedprice, "l_discount": l_discount,
            "l_tax": l_tax, "l_returnflag": returnflag.astype(np.uint8),
            "l_linestatus": linestatus.astype(np.uint8),
            "l_shipdate": l_shipdate, "l_commitdate": l_commitdate,
            "l_receiptdate": l_receiptdate, "l_shipmode": l_shipmode,
            "l_shipinstruct": l_shipinstruct},
        "orders": {
            "o_orderkey": o_orderkey, "o_custkey": o_custkey,
            "o_orderdate": o_orderdate,
            "o_shippriority": np.zeros(n_ord, np.int32),
            "o_totalprice": o_totalprice,
            "o_orderstatus": o_orderstatus.astype(np.uint8),
            "o_orderpriority": o_orderpriority, "o_comment": o_comment},
        "customer": {
            "c_custkey": c_custkey,
            "c_name": _concat_strings(b"Customer#", _digits(c_custkey, 9)),
            "c_nationkey": c_nationkey, "c_mktsegment": c_mktsegment,
            "c_phone": c_phone, "c_acctbal": c_acctbal,
            "c_address": c_address, "c_comment": c_comment},
        "part": {
            "p_partkey": p_partkey, "p_name": p_name,
            "p_mfgr": _concat_strings(b"Manufacturer#", _digits(brand_m, 1)),
            "p_brand": _concat_strings(b"Brand#", _digits(brand_m, 1),
                                       _digits(brand_n, 1)),
            "p_type": p_type, "p_size": p_size,
            "p_container": p_container, "p_retailprice": p_retailprice},
        "partsupp": {
            "ps_partkey": ps_partkey, "ps_suppkey": ps_suppkey,
            "ps_availqty": ps_availqty, "ps_supplycost": ps_supplycost},
        "supplier": {
            "s_suppkey": s_suppkey,
            "s_name": _concat_strings(b"Supplier#", _digits(s_suppkey, 9)),
            "s_nationkey": s_nationkey, "s_phone": s_phone,
            "s_acctbal": s_acctbal, "s_address": s_address,
            "s_comment": s_comment},
        "nation": {
            "n_nationkey": np.arange(25, dtype=np.int64),
            "n_name": np.arange(25),
            "n_regionkey": np.array([r for _, r in NATIONS], np.int64)},
        "region": {
            "r_regionkey": np.arange(5, dtype=np.int64),
            "r_name": np.arange(5)},
    }


def tpch_q1_columns(scale: float, seed: int = 0) -> dict:
    """LINEITEM's q1 columns (``tpch_columns``); flags are ``(n,)`` uint8
    character codes."""
    li = tpch_columns(scale, seed)["lineitem"]
    return {name: li[name] for name, _ in Q1_SCHEMA}


# String columns held as codes into a pool; the others are built (n, w)
# matrices or uint8 character codes (one-byte strings).
_STRING_POOLS = {"o_orderpriority": PRIORITIES, "o_comment": O_COMMENTS,
                 "c_address": O_COMMENTS, "c_comment": O_COMMENTS,
                 "c_mktsegment": SEGMENTS,
                 "l_shipmode": SHIPMODES, "l_shipinstruct": SHIPINSTRUCT,
                 "s_address": S_COMMENTS, "s_comment": S_COMMENTS,
                 "n_name": tuple(n for n, _ in NATIONS), "r_name": REGIONS}


def _host_batch(schema, cols: dict, lo: int, hi: int,
                pools: dict) -> HostBatch:
    """Rows ``lo:hi`` of ``cols`` as one host batch. A numpy masked array
    is a nullable column (masked rows are NULL, their data zero)."""
    n = hi - lo
    out = []
    for name, t in schema:
        v = cols[name][lo:hi]
        valid = np.ones(n, np.bool_)
        if isinstance(v, np.ma.MaskedArray):
            valid = ~np.ma.getmaskarray(v)
            v = v.filled(0)
        if t.is_string:
            if name in pools:
                m, lens = _pool_matrix(pools[name])
                out.append(HostColumn(t, None, valid, str_matrix=m[v],
                                      str_lengths=lens[v]))
            elif v.ndim == 2:
                out.append(HostColumn(
                    t, None, valid, str_matrix=v.copy(),
                    str_lengths=(v != 0).sum(axis=1).astype(np.int32)))
            else:
                out.append(HostColumn(t, None, valid,
                                      str_matrix=v.reshape(n, 1).copy(),
                                      str_lengths=np.ones(n, np.int32)))
        else:
            out.append(HostColumn(t, v.copy(), valid))
    return HostBatch(tuple(n for n, _ in schema), out)


def table_partitions(cols: dict, schema, partitions: int,
                     pools: Optional[dict] = None) -> List[List[HostBatch]]:
    """A table's ``schema`` columns split into ``partitions`` row ranges,
    one host batch each (the generator's ``files_per_table`` split).
    ``pools`` names the string columns held as codes into a pool (default:
    the TPC-H ones)."""
    pools = _STRING_POOLS if pools is None else pools
    n = len(cols[schema[0][0]])
    per = max(1, -(-n // partitions))
    parts = []
    for i in range(partitions):
        lo, hi = min(i * per, n), min((i + 1) * per, n)
        if hi == lo and i > 0:
            break
        parts.append([_host_batch(schema, cols, lo, hi, pools)])
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
# CUSTOMER, PART and PARTSUPP; one file each for SUPPLIER, NATION and
# REGION.
TABLE_PARTITIONS = {"lineitem": 8, "orders": 8, "customer": 4, "part": 4,
                    "partsupp": 4, "supplier": 1, "nation": 1, "region": 1}

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

# The scans of TPC-H q5 (local supplier volume) and q6 (forecasting
# revenue change): the columns each query reads.
Q5_REGION = (("r_regionkey", dt.INT64), ("r_name", dt.STRING))
Q5_NATION = (("n_nationkey", dt.INT64), ("n_name", dt.STRING),
             ("n_regionkey", dt.INT64))
Q5_CUSTOMER = (("c_custkey", dt.INT64), ("c_nationkey", dt.INT64))
Q5_ORDERS = (("o_orderkey", dt.INT64), ("o_custkey", dt.INT64),
             ("o_orderdate", dt.DATE))
Q5_LINEITEM = (("l_orderkey", dt.INT64), ("l_suppkey", dt.INT64),
               ("l_extendedprice", dt.FLOAT64), ("l_discount", dt.FLOAT64))
Q5_SUPPLIER = (("s_suppkey", dt.INT64), ("s_nationkey", dt.INT64))
Q5_REGION_NAME = "ASIA"
Q5_DATE_LO = days("1994-01-01")
Q5_DATE_HI = days("1995-01-01")

Q6_LINEITEM = (("l_quantity", dt.FLOAT64), ("l_extendedprice", dt.FLOAT64),
               ("l_discount", dt.FLOAT64), ("l_shipdate", dt.DATE))
Q6_DATE_LO = days("1994-01-01")
Q6_DATE_HI = days("1995-01-01")
Q6_DISCOUNT_LO, Q6_DISCOUNT_HI = 0.05, 0.07
Q6_QUANTITY_BELOW = 24.0

# The scans of q7, q8, q9, q12, q14 and q19: per table the columns the
# reference's scan pruning keeps of its parquet, in the generator's order.
_NATION_NAMES = (("n_nationkey", dt.INT64), ("n_name", dt.STRING))
_SUPPLIER_KEYS = (("s_suppkey", dt.INT64), ("s_nationkey", dt.INT64))
_CUSTOMER_KEYS = (("c_custkey", dt.INT64), ("c_nationkey", dt.INT64))
_PART_TYPE = (("p_partkey", dt.INT64), ("p_type", dt.STRING))
Q7_NATION = _NATION_NAMES
Q7_SUPPLIER = _SUPPLIER_KEYS
Q7_CUSTOMER = _CUSTOMER_KEYS
Q7_ORDERS = (("o_orderkey", dt.INT64), ("o_custkey", dt.INT64))
Q7_LINEITEM = (("l_orderkey", dt.INT64), ("l_suppkey", dt.INT64),
               ("l_extendedprice", dt.FLOAT64), ("l_discount", dt.FLOAT64),
               ("l_shipdate", dt.DATE))
Q8_REGION = Q5_REGION
Q8_NATION = Q5_NATION
Q8_CUSTOMER = _CUSTOMER_KEYS
Q8_SUPPLIER = _SUPPLIER_KEYS
Q8_PART = _PART_TYPE
Q8_ORDERS = (("o_orderkey", dt.INT64), ("o_custkey", dt.INT64),
             ("o_orderdate", dt.DATE))
Q8_LINEITEM = (("l_orderkey", dt.INT64), ("l_partkey", dt.INT64),
               ("l_suppkey", dt.INT64), ("l_extendedprice", dt.FLOAT64),
               ("l_discount", dt.FLOAT64))
Q9_PART = (("p_partkey", dt.INT64), ("p_name", dt.STRING))
Q9_SUPPLIER = _SUPPLIER_KEYS
Q9_NATION = _NATION_NAMES
Q9_PARTSUPP = (("ps_partkey", dt.INT64), ("ps_suppkey", dt.INT64),
               ("ps_supplycost", dt.FLOAT64))
Q9_ORDERS = (("o_orderkey", dt.INT64), ("o_orderdate", dt.DATE))
Q9_LINEITEM = (("l_orderkey", dt.INT64), ("l_partkey", dt.INT64),
               ("l_suppkey", dt.INT64), ("l_quantity", dt.FLOAT64),
               ("l_extendedprice", dt.FLOAT64), ("l_discount", dt.FLOAT64))
Q12_LINEITEM = (("l_orderkey", dt.INT64), ("l_shipdate", dt.DATE),
                ("l_commitdate", dt.DATE), ("l_receiptdate", dt.DATE),
                ("l_shipmode", dt.STRING))
Q12_ORDERS = (("o_orderkey", dt.INT64), ("o_orderpriority", dt.STRING))
Q14_LINEITEM = (("l_partkey", dt.INT64), ("l_extendedprice", dt.FLOAT64),
                ("l_discount", dt.FLOAT64), ("l_shipdate", dt.DATE))
Q14_PART = _PART_TYPE
Q19_LINEITEM = (("l_partkey", dt.INT64), ("l_quantity", dt.FLOAT64),
                ("l_extendedprice", dt.FLOAT64), ("l_discount", dt.FLOAT64),
                ("l_shipmode", dt.STRING), ("l_shipinstruct", dt.STRING))
Q19_PART = (("p_partkey", dt.INT64), ("p_brand", dt.STRING),
            ("p_size", dt.INT32), ("p_container", dt.STRING))

# The scans of q10, q13, q16, q17, q18 and q21, chosen as those above.
Q10_LINEITEM = (("l_orderkey", dt.INT64), ("l_extendedprice", dt.FLOAT64),
                ("l_discount", dt.FLOAT64), ("l_returnflag", dt.STRING))
Q10_ORDERS = (("o_orderkey", dt.INT64), ("o_custkey", dt.INT64),
              ("o_orderdate", dt.DATE))
Q10_CUSTOMER = (("c_custkey", dt.INT64), ("c_name", dt.STRING),
                ("c_nationkey", dt.INT64), ("c_phone", dt.STRING),
                ("c_acctbal", dt.FLOAT64), ("c_address", dt.STRING),
                ("c_comment", dt.STRING))
Q10_NATION = _NATION_NAMES
Q13_CUSTOMER = (("c_custkey", dt.INT64),)
Q13_ORDERS = (("o_orderkey", dt.INT64), ("o_custkey", dt.INT64),
              ("o_comment", dt.STRING))
Q16_PARTSUPP = (("ps_partkey", dt.INT64), ("ps_suppkey", dt.INT64))
Q16_SUPPLIER = (("s_suppkey", dt.INT64), ("s_comment", dt.STRING))
Q16_PART = (("p_partkey", dt.INT64), ("p_brand", dt.STRING),
            ("p_type", dt.STRING), ("p_size", dt.INT32))
Q17_LINEITEM = (("l_partkey", dt.INT64), ("l_quantity", dt.FLOAT64),
                ("l_extendedprice", dt.FLOAT64))
Q17_PART = (("p_partkey", dt.INT64), ("p_brand", dt.STRING),
            ("p_container", dt.STRING))
Q18_LINEITEM = (("l_orderkey", dt.INT64), ("l_quantity", dt.FLOAT64))
Q18_ORDERS = (("o_orderkey", dt.INT64), ("o_custkey", dt.INT64),
              ("o_orderdate", dt.DATE), ("o_totalprice", dt.FLOAT64))
Q18_CUSTOMER = (("c_custkey", dt.INT64), ("c_name", dt.STRING))
Q21_LINEITEM = (("l_orderkey", dt.INT64), ("l_suppkey", dt.INT64),
                ("l_commitdate", dt.DATE), ("l_receiptdate", dt.DATE))
Q21_ORDERS = (("o_orderkey", dt.INT64), ("o_orderstatus", dt.STRING))
Q21_SUPPLIER = (("s_suppkey", dt.INT64), ("s_name", dt.STRING),
                ("s_nationkey", dt.INT64))
Q21_NATION = _NATION_NAMES

# The scans of q11, q15, q20 and q22, chosen as those above.
Q11_NATION = _NATION_NAMES
Q11_SUPPLIER = _SUPPLIER_KEYS
Q11_PARTSUPP = (("ps_partkey", dt.INT64), ("ps_suppkey", dt.INT64),
                ("ps_availqty", dt.INT32), ("ps_supplycost", dt.FLOAT64))
Q15_LINEITEM = (("l_suppkey", dt.INT64), ("l_extendedprice", dt.FLOAT64),
                ("l_discount", dt.FLOAT64), ("l_shipdate", dt.DATE))
Q15_SUPPLIER = (("s_suppkey", dt.INT64), ("s_name", dt.STRING),
                ("s_phone", dt.STRING), ("s_address", dt.STRING))
Q20_PART = (("p_partkey", dt.INT64), ("p_name", dt.STRING))
Q20_LINEITEM = (("l_partkey", dt.INT64), ("l_suppkey", dt.INT64),
                ("l_quantity", dt.FLOAT64), ("l_shipdate", dt.DATE))
Q20_PARTSUPP = (("ps_partkey", dt.INT64), ("ps_suppkey", dt.INT64),
                ("ps_availqty", dt.INT32))
Q20_NATION = _NATION_NAMES
Q20_SUPPLIER = (("s_suppkey", dt.INT64), ("s_name", dt.STRING),
                ("s_nationkey", dt.INT64), ("s_address", dt.STRING))
Q22_CUSTOMER = (("c_custkey", dt.INT64), ("c_phone", dt.STRING),
                ("c_acctbal", dt.FLOAT64))
Q22_ORDERS = (("o_custkey", dt.INT64),)


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


# ---------------------------------------------------------------------------
# TPC-H Q2
# ---------------------------------------------------------------------------

# Q2's scans, with the columns the JAX planner prunes each one to: the
# supplier and nation scans under the min aggregate read their keys only.
Q2_PART = (("p_partkey", dt.INT64), ("p_mfgr", dt.STRING),
           ("p_type", dt.STRING), ("p_size", dt.INT32))
Q2_PARTSUPP = (("ps_partkey", dt.INT64), ("ps_suppkey", dt.INT64),
               ("ps_supplycost", dt.FLOAT64))
Q2_SUPPLIER = (("s_suppkey", dt.INT64), ("s_name", dt.STRING),
               ("s_nationkey", dt.INT64), ("s_phone", dt.STRING),
               ("s_acctbal", dt.FLOAT64), ("s_address", dt.STRING),
               ("s_comment", dt.STRING))
Q2_NATION = (("n_nationkey", dt.INT64), ("n_name", dt.STRING),
             ("n_regionkey", dt.INT64))
Q2_REGION = (("r_regionkey", dt.INT64), ("r_name", dt.STRING))
Q2_SUPPLIER_KEYS = (("s_suppkey", dt.INT64), ("s_nationkey", dt.INT64))
Q2_NATION_KEYS = (("n_nationkey", dt.INT64), ("n_regionkey", dt.INT64))
Q2_SCANS = {"part": ("part", Q2_PART),
            "partsupp": ("partsupp", Q2_PARTSUPP),
            "supplier": ("supplier", Q2_SUPPLIER),
            "nation": ("nation", Q2_NATION),
            "region": ("region", Q2_REGION),
            "supplier_keys": ("supplier", Q2_SUPPLIER_KEYS),
            "nation_keys": ("nation", Q2_NATION_KEYS)}
Q2_SIZE = 15
Q2_TYPE_SUFFIX = "BRASS"
Q2_REGION_NAME = "EUROPE"
Q2_LIMIT = 100
# The output columns, in order.
Q2_COLUMNS = ("s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
              "s_address", "s_phone", "s_comment")


def tpch_q2_tables(cols: dict) -> dict:
    """Q2's scans over ``tpch_columns`` output: scan -> partitions (keys
    of ``Q2_SCANS``)."""
    return {scan: table_partitions(cols[table], schema,
                                   TABLE_PARTITIONS[table])
            for scan, (table, schema) in Q2_SCANS.items()}


def _q2_europe_suppliers(tables: dict, dev, keys_only: bool) -> ProjectExec:
    """Suppliers of the EUROPE nations: region filter, nation join,
    supplier join (both broadcast, the dense table). With ``keys_only``
    the pruned scans of the min branch and just ``s_suppkey`` out; else
    [s_suppkey, s_name, s_address, s_phone, s_acctbal, s_comment,
    n_name]."""
    i64, s = dt.INT64, dt.STRING
    region = FilterExec(InMemorySourceExec(Q2_REGION, tables["region"], dev),
                        EqualTo(Ref(1, s), lit(Q2_REGION_NAME)))
    if keys_only:
        nation = InMemorySourceExec(Q2_NATION_KEYS, tables["nation_keys"],
                                    dev)
        nat = ProjectExec(BroadcastHashJoinExec(
            nation, region, [Ref(1, i64)], [Ref(0, i64)], "inner"),
            [("n_nationkey", Ref(0, i64))])
        supp = InMemorySourceExec(Q2_SUPPLIER_KEYS, tables["supplier_keys"],
                                  dev)
        return ProjectExec(BroadcastHashJoinExec(
            supp, nat, [Ref(1, i64)], [Ref(0, i64)], "inner"),
            [("s_suppkey", Ref(0, i64))])
    nation = InMemorySourceExec(Q2_NATION, tables["nation"], dev)
    nat = ProjectExec(BroadcastHashJoinExec(
        nation, region, [Ref(2, i64)], [Ref(0, i64)], "inner"),
        [("n_nationkey", Ref(0, i64)), ("n_name", Ref(1, s))])
    supp = InMemorySourceExec(Q2_SUPPLIER, tables["supplier"], dev)
    # [s_suppkey, s_name, s_nationkey, s_phone, s_acctbal, s_address,
    #  s_comment, n_nationkey, n_name]
    joined = BroadcastHashJoinExec(supp, nat, [Ref(2, i64)], [Ref(0, i64)],
                                   "inner")
    return ProjectExec(joined, [
        ("s_suppkey", Ref(0, i64)), ("s_name", Ref(1, s)),
        ("s_address", Ref(5, s)), ("s_phone", Ref(3, s)),
        ("s_acctbal", Ref(4, dt.FLOAT64)), ("s_comment", Ref(6, s)),
        ("n_name", Ref(8, s))])


def tpch_q2_plan(tables: dict, device: DeviceLike = None) -> GlobalLimitExec:
    """TPC-H Q2: for the BRASS parts of size 15, the EUROPE suppliers that
    offer them at the minimum EUROPE supply cost, top 100 by s_acctbal
    desc, n_name, s_name, p_partkey. The correlated minimum is a partial
    and final ``min(ps_supplycost)`` by ``ps_partkey`` (kernel K2) joined
    back on the part key; part joins partsupp-with-supplier on the fast
    probe path (kernel K3: up to 4 suppliers a part)."""
    dev = resolve_device(device)
    i64, f, s = dt.INT64, dt.FLOAT64, dt.STRING
    # [ps_partkey, ps_suppkey, ps_supplycost, s_suppkey, s_name, s_address,
    #  s_phone, s_acctbal, s_comment, n_name]
    ps = BroadcastHashJoinExec(
        InMemorySourceExec(Q2_PARTSUPP, tables["partsupp"], dev),
        _q2_europe_suppliers(tables, dev, keys_only=False),
        [Ref(1, i64)], [Ref(0, i64)], "inner")
    # [ps_partkey, ps_suppkey, ps_supplycost, s_suppkey]
    ps_keys = BroadcastHashJoinExec(
        InMemorySourceExec(Q2_PARTSUPP, tables["partsupp"], dev),
        _q2_europe_suppliers(tables, dev, keys_only=True),
        [Ref(1, i64)], [Ref(0, i64)], "inner")
    keys = [("ps_partkey", Ref(0, i64))]
    aggs = [AggSpec("min_cost", Min(Ref(2, f)))]
    partial = HashAggregateExec(ps_keys, keys, aggs, mode="partial")
    final = HashAggregateExec(CoalescePartitionsExec(partial, 1),
                              _final_keys(keys), aggs, mode="final")
    minc = ProjectExec(final, [("m_partkey", Ref(0, i64)),
                               ("min_cost", Ref(1, f))])
    part = ProjectExec(
        FilterExec(InMemorySourceExec(Q2_PART, tables["part"], dev),
                   And(EqualTo(Ref(3, dt.INT32), lit(Q2_SIZE)),
                       EndsWith(Ref(2, s), lit(Q2_TYPE_SUFFIX)))),
        [("p_partkey", Ref(0, i64)), ("p_mfgr", Ref(1, s))])
    # [p_partkey, p_mfgr, ps_partkey, ps_suppkey, ps_supplycost, s_suppkey,
    #  s_name, s_address, s_phone, s_acctbal, s_comment, n_name]
    j = BroadcastHashJoinExec(part, ps, [Ref(0, i64)], [Ref(0, i64)],
                              "inner")
    # ... + [m_partkey, min_cost]
    j = BroadcastHashJoinExec(j, minc, [Ref(0, i64)], [Ref(0, i64)],
                              "inner")
    cheapest = FilterExec(j, EqualTo(Ref(4, f), Ref(13, f)))
    out = ProjectExec(cheapest, [
        ("s_acctbal", Ref(9, f)), ("s_name", Ref(6, s)),
        ("n_name", Ref(11, s)), ("p_partkey", Ref(0, i64)),
        ("p_mfgr", Ref(1, s)), ("s_address", Ref(7, s)),
        ("s_phone", Ref(8, s)), ("s_comment", Ref(10, s))])
    top = SortExec(CoalescePartitionsExec(out, 1), [
        SortOrder(Ref(0, f), ascending=False, nulls_first=False),
        SortOrder(Ref(2, s)), SortOrder(Ref(1, s)), SortOrder(Ref(3, i64))])
    return GlobalLimitExec(LocalLimitExec(top, Q2_LIMIT), Q2_LIMIT)
