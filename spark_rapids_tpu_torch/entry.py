"""Entry points of the port: the flagship q1-shaped step and TPC-H q1.

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
    Add, BoundReference as Ref, LessThanOrEqual, Literal, Multiply,
    Subtract, lit)
from spark_rapids_tpu_torch.exprs.base import as_device_column
from spark_rapids_tpu_torch.ops import (
    AggSpec, Average, CoalescePartitionsExec, CountStar, FilterExec,
    HashAggregateExec, InMemorySourceExec, ProjectExec, SortExec, SortOrder,
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


def tpch_q1_columns(scale: float, seed: int = 0) -> dict:
    """LINEITEM's q1 columns as numpy arrays: the JAX package's TPC-H
    generator, drawing the same random stream (the ORDERS draws that come
    first included), so ``seed`` and ``scale`` give its rows. Flags are
    ``(n,)`` uint8 character codes."""
    rng = np.random.default_rng(seed)
    n_ord = max(int(1_500_000 * scale), 10)
    n_cust = max(int(150_000 * scale), 5)
    # ORDERS: custkey, orderdate, status coin, totalprice, priority, comment.
    rng.integers(1, max(n_cust * 2 // 3, 2), n_ord, dtype=np.int64)
    o_orderdate = rng.integers(days("1992-01-01"), days("1998-08-02"),
                               n_ord, dtype=np.int64).astype(np.int32)
    rng.integers(0, 2, n_ord)
    rng.uniform(900.0, 500_000.0, n_ord)
    rng.integers(0, 5, n_ord)
    rng.integers(0, 14, n_ord)
    # LINEITEM: 1..7 lines per order.
    per_order = rng.integers(1, 8, n_ord)
    l_orderdate = np.repeat(o_orderdate, per_order)
    n_li = len(l_orderdate)
    l_quantity = rng.integers(1, 51, n_li).astype(np.float64)
    l_extendedprice = np.round(rng.uniform(900.0, 105_000.0, n_li), 2)
    l_discount = rng.integers(0, 11, n_li).astype(np.float64) / 100.0
    l_tax = rng.integers(0, 9, n_li).astype(np.float64) / 100.0
    l_shipdate = (l_orderdate.astype(np.int64)
                  + rng.integers(1, 122, n_li)).astype(np.int32)
    rng.integers(30, 91, n_li)                      # commitdate
    l_receiptdate = (l_shipdate.astype(np.int64)
                     + rng.integers(1, 31, n_li)).astype(np.int32)
    cutoff = days("1995-06-17")
    ra = rng.integers(0, 2, n_li)
    returnflag = np.where(l_receiptdate <= cutoff,
                          np.where(ra == 0, ord("A"), ord("R")), ord("N"))
    linestatus = np.where(l_shipdate > cutoff, ord("O"), ord("F"))
    return {"l_quantity": l_quantity, "l_extendedprice": l_extendedprice,
            "l_discount": l_discount, "l_tax": l_tax,
            "l_returnflag": returnflag.astype(np.uint8),
            "l_linestatus": linestatus.astype(np.uint8),
            "l_shipdate": l_shipdate}


def _q1_host_batch(cols: dict, lo: int, hi: int) -> HostBatch:
    n = hi - lo
    out = []
    for name, t in Q1_SCHEMA:
        v = cols[name][lo:hi]
        valid = np.ones(n, np.bool_)
        if t.is_string:
            out.append(HostColumn(t, None, valid,
                                  str_matrix=v.reshape(n, 1).copy(),
                                  str_lengths=np.ones(n, np.int32)))
        else:
            out.append(HostColumn(t, v.copy(), valid))
    return HostBatch(tuple(n for n, _ in Q1_SCHEMA), out)


def tpch_q1_host_batches(scale: float, partitions: int = 8,
                         seed: int = 0) -> List[List[HostBatch]]:
    """LINEITEM's q1 columns split into ``partitions`` row ranges, one
    host batch each (the generator's ``files_per_table`` split)."""
    cols = tpch_q1_columns(scale, seed)
    n = len(cols["l_quantity"])
    per = max(1, -(-n // partitions))
    parts = []
    for i in range(partitions):
        lo, hi = min(i * per, n), min((i + 1) * per, n)
        if hi == lo and i > 0:
            break
        parts.append([_q1_host_batch(cols, lo, hi)])
    return parts


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
