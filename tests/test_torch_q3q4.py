"""Port parity, end to end: TPC-H q3 and q4 of spark_rapids_tpu_torch
against the JAX package, on the CPU.

- ``tpch_columns`` draws the JAX package's generator stream: every column
  it yields equals the generated parquet's.
- ``tpch_q3_plan`` / ``tpch_q4_plan`` against the same exec trees built
  from the JAX package's execs (the trees its planner builds for
  ``tpch.q3`` / ``tpch.q4`` at SF1). Keys, counts and the order of rows
  must match exactly; q3's revenue within rtol 1e-9, because the two
  engines take their prefix sums in different orders.
- chip_smoke.py's numpy oracles for q3 and q4 agree with the port.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import os
import sys

import numpy as np
import pytest

from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu import ops as JO
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.ops import base as jbase
from spark_rapids_tpu.ops import basic as jbasic
from spark_rapids_tpu.ops import join as jjoin
from spark_rapids_tpu.ops import sort as jsort

from spark_rapids_tpu_torch import entry as E

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-9


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def test_columns_match_reference_generator(tmp_path):
    import pyarrow.parquet as pq
    from spark_rapids_tpu.benchmarks import tpch
    tpch.generate(str(tmp_path), scale=0.001, files_per_table=2, seed=3)
    cols = E.tpch_columns(0.001, seed=3)
    assert set(cols) == {"lineitem", "orders", "customer", "part",
                         "partsupp", "supplier", "nation", "region"}
    pools = E._STRING_POOLS
    for table, tcols in cols.items():
        ref = pq.read_table(os.path.join(tmp_path, table)).to_pandas()
        for name, got in tcols.items():
            want = ref[name]
            if name in pools:
                got = np.array([pools[name][i] for i in got], object)
                want = want.to_numpy(object)
            elif got.ndim == 2:         # a built string column
                got = np.array([bytes(r).rstrip(b"\0").decode()
                                for r in got], object)
                want = want.to_numpy(object)
            elif name in ("l_returnflag", "l_linestatus", "o_orderstatus"):
                want = np.array([ord(x) for x in want], np.uint8)
            elif name.endswith("date"):
                want = (want.astype("datetime64[ns]")
                        - np.datetime64("1970-01-01")).dt.days.to_numpy()
            else:
                want = want.to_numpy()
            np.testing.assert_array_equal(want, got, err_msg=name)


# ---------------------------------------------------------------------------
# The plans against the JAX package's exec trees
# ---------------------------------------------------------------------------

def _jax_parts(parts):
    out = []
    for p in parts:
        batches = []
        for hb in p:
            cols = []
            for c in hb.columns:
                t = jdt.type_named(c.dtype.name)
                if t.is_string:
                    cols.append(jhost.HostColumn(
                        t, None, c.validity, str_matrix=c.str_matrix,
                        str_lengths=c.str_lengths))
                else:
                    cols.append(jhost.HostColumn(t, c.data, c.validity))
            batches.append(jhost.HostBatch(hb.names, cols))
        out.append(batches)
    return out


def _jschema(schema):
    return tuple((n, jdt.type_named(t.name)) for n, t in schema)


def _src(schema, parts):
    return jbase.InMemorySourceExec(_jschema(schema), _jax_parts(parts))


def _jax_q3_plan(tables):
    R, f, d = JE.BoundReference, jdt.FLOAT64, jdt.DATE
    cust = jbasic.ProjectExec(jbasic.FilterExec(
        _src(E.Q3_CUSTOMER, tables["customer"]),
        JE.EqualTo(R(1, jdt.STRING), JE.lit(E.Q3_SEGMENT))),
        [("c_custkey", R(0, jdt.INT64))])
    orders = jbasic.ProjectExec(jbasic.FilterExec(
        _src(E.Q3_ORDERS, tables["orders"]),
        JE.LessThan(R(2, d), JE.Literal(d, E.Q3_DATE))),
        [(n, R(i, t)) for i, (n, t) in enumerate(_jschema(E.Q3_ORDERS))])
    co = jjoin.BroadcastHashJoinExec(orders, cust, [R(1, jdt.INT64)],
                                     [R(0, jdt.INT64)], "inner")
    li = jbasic.ProjectExec(jbasic.FilterExec(
        _src(E.Q3_LINEITEM, tables["lineitem"]),
        JE.GreaterThan(R(3, d), JE.Literal(d, E.Q3_DATE))),
        [(n, R(i, t)) for i, (n, t)
         in enumerate(_jschema(E.Q3_LINEITEM[:3]))])
    joined = jjoin.BroadcastHashJoinExec(li, co, [R(0, jdt.INT64)],
                                         [R(0, jdt.INT64)], "inner")
    keys = [("l_orderkey", R(0, jdt.INT64)), ("o_orderdate", R(5, d)),
            ("o_shippriority", R(6, jdt.INT32))]
    aggs = [JO.AggSpec("revenue", JO.Sum(JE.Multiply(
        R(1, f), JE.Subtract(JE.lit(1.0), R(2, f)))))]
    partial = JO.HashAggregateExec(joined, keys, aggs, mode="partial")
    fkeys = [(n, R(i, e.data_type())) for i, (n, e) in enumerate(keys)]
    final = JO.HashAggregateExec(jbasic.CoalescePartitionsExec(partial, 1),
                                 fkeys, aggs, mode="final")
    top = jsort.SortExec(final, [
        jsort.SortOrder(R(3, f), ascending=False, nulls_first=False),
        jsort.SortOrder(R(1, d))])
    return jbasic.GlobalLimitExec(jbasic.LocalLimitExec(top, E.Q3_LIMIT),
                                  E.Q3_LIMIT)


def _jax_q4_plan(tables):
    R, d = JE.BoundReference, jdt.DATE
    orders = jbasic.FilterExec(
        _src(E.Q4_ORDERS, tables["orders"]),
        JE.And(JE.GreaterThanOrEqual(R(1, d), JE.Literal(d, E.Q4_DATE_LO)),
               JE.LessThan(R(1, d), JE.Literal(d, E.Q4_DATE_HI))))
    late = jbasic.ProjectExec(jbasic.FilterExec(
        _src(E.Q4_LINEITEM, tables["lineitem"]),
        JE.LessThan(R(1, d), R(2, d))), [("l_orderkey", R(0, jdt.INT64))])
    semi = jjoin.BroadcastHashJoinExec(orders, late, [R(0, jdt.INT64)],
                                       [R(0, jdt.INT64)], "semi")
    keys = [("o_orderpriority", R(2, jdt.STRING))]
    aggs = [JO.AggSpec("order_count", JO.CountStar(None))]
    partial = JO.HashAggregateExec(semi, keys, aggs, mode="partial")
    final = JO.HashAggregateExec(jbasic.CoalescePartitionsExec(partial, 1),
                                 [("o_orderpriority", R(0, jdt.STRING))],
                                 aggs, mode="final")
    return jsort.SortExec(final, [jsort.SortOrder(R(0, jdt.STRING))])


def _assert_q3_rows(want, got):
    assert len(got) == len(want) == E.Q3_LIMIT
    for w, g in zip(want, got):
        assert g[:3] == w[:3], (w, g)
        assert np.isclose(g[3], w[3], rtol=RTOL, atol=0.0), (w, g)


@pytest.mark.parametrize("seed", [0, 5])
def test_q3_plan_matches_reference_exec_tree(seed):
    tables = E.tpch_q3_tables(E.tpch_columns(0.002, seed))
    want = _jax_q3_plan(tables).collect()
    got = E.tpch_q3_plan(tables, device="cpu").collect()
    _assert_q3_rows(want, got)


@pytest.mark.parametrize("seed", [0, 5])
def test_q4_plan_matches_reference_exec_tree(seed):
    tables = E.tpch_q4_tables(E.tpch_columns(0.002, seed))
    want = _jax_q4_plan(tables).collect()
    got = E.tpch_q4_plan(tables, device="cpu").collect()
    assert [r[0] for r in got] == list(E.PRIORITIES)
    assert got == want


def test_entry_points_raise_without_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    cols = E.tpch_columns(0.0001, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.tpch_q3_plan(E.tpch_q3_tables(cols))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.tpch_q4_plan(E.tpch_q4_tables(cols))


def test_chip_smoke_oracles_agree_with_port():
    """The numpy oracles chip_smoke.py holds the card's q3/q4 runs to
    agree with the port's plans at small scale here."""
    cs = _chip_smoke()
    cols = E.tpch_columns(0.003, seed=1)
    q3 = E.tpch_q3_plan(E.tpch_q3_tables(cols), device="cpu").collect()
    cs.check_q3(q3, cs.q3_oracle(cols, E))
    q4 = E.tpch_q4_plan(E.tpch_q4_tables(cols), device="cpu").collect()
    cs.check_q4(q4, cs.q4_oracle(cols, E))
