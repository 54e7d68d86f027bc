"""Port parity, end to end: TPC-H q2 of spark_rapids_tpu_torch against the
JAX package, on the CPU.

- ``tpch_q2_plan`` against the same exec tree built from the JAX
  package's execs (the tree its planner builds for ``tpch.q2`` at SF1:
  every join broadcast, ``min(ps_supplycost)`` by ``ps_partkey`` as a
  partial and a final aggregate, part joined to partsupp-with-supplier,
  then to the minimum, filter, sort, limit 100). Rows and their order
  must be exact: the output columns are gathered, never summed.
- chip_smoke.py's numpy oracle for q2 agrees with the port.
"""

import os
import sys

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
from spark_rapids_tpu_torch.ops import native as tnative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jschema(schema):
    return tuple((n, jdt.type_named(t.name)) for n, t in schema)


def _src(scan, tables):
    schema = E.Q2_SCANS[scan][1]
    parts = []
    for p in tables[scan]:
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
        parts.append(batches)
    return jbase.InMemorySourceExec(_jschema(schema), parts)


def _bhj(left, right, lk, rk):
    R, i64 = JE.BoundReference, jdt.INT64
    return jjoin.BroadcastHashJoinExec(left, right, [R(lk, i64)],
                                       [R(rk, i64)], "inner")


def _jax_suppliers(tables, keys_only):
    R, i64, s = JE.BoundReference, jdt.INT64, jdt.STRING
    region = jbasic.FilterExec(_src("region", tables), JE.EqualTo(
        R(1, s), JE.lit(E.Q2_REGION_NAME)))
    if keys_only:
        nat = jbasic.ProjectExec(_bhj(_src("nation_keys", tables), region,
                                      1, 0), [("n_nationkey", R(0, i64))])
        return jbasic.ProjectExec(_bhj(_src("supplier_keys", tables), nat,
                                       1, 0), [("s_suppkey", R(0, i64))])
    nat = jbasic.ProjectExec(_bhj(_src("nation", tables), region, 2, 0),
                             [("n_nationkey", R(0, i64)),
                              ("n_name", R(1, s))])
    return jbasic.ProjectExec(_bhj(_src("supplier", tables), nat, 2, 0), [
        ("s_suppkey", R(0, i64)), ("s_name", R(1, s)),
        ("s_address", R(5, s)), ("s_phone", R(3, s)),
        ("s_acctbal", R(4, jdt.FLOAT64)), ("s_comment", R(6, s)),
        ("n_name", R(8, s))])


def _jax_q2_plan(tables):
    """tpch_q2_plan, built from the JAX package's execs."""
    R, i64, f, s = JE.BoundReference, jdt.INT64, jdt.FLOAT64, jdt.STRING
    ps = _bhj(_src("partsupp", tables), _jax_suppliers(tables, False), 1, 0)
    ps_keys = _bhj(_src("partsupp", tables), _jax_suppliers(tables, True),
                   1, 0)
    keys = [("ps_partkey", R(0, i64))]
    aggs = [JO.AggSpec("min_cost", JO.Min(R(2, f)))]
    partial = JO.HashAggregateExec(ps_keys, keys, aggs, mode="partial")
    final = JO.HashAggregateExec(jbasic.CoalescePartitionsExec(partial, 1),
                                 keys, aggs, mode="final")
    minc = jbasic.ProjectExec(final, [("m_partkey", R(0, i64)),
                                      ("min_cost", R(1, f))])
    part = jbasic.ProjectExec(jbasic.FilterExec(
        _src("part", tables),
        JE.And(JE.EqualTo(R(3, jdt.INT32), JE.lit(E.Q2_SIZE)),
               JE.EndsWith(R(2, s), JE.lit(E.Q2_TYPE_SUFFIX)))),
        [("p_partkey", R(0, i64)), ("p_mfgr", R(1, s))])
    j = _bhj(_bhj(part, ps, 0, 0), minc, 0, 0)
    cheapest = jbasic.FilterExec(j, JE.EqualTo(R(4, f), R(13, f)))
    out = jbasic.ProjectExec(cheapest, [
        ("s_acctbal", R(9, f)), ("s_name", R(6, s)), ("n_name", R(11, s)),
        ("p_partkey", R(0, i64)), ("p_mfgr", R(1, s)),
        ("s_address", R(7, s)), ("s_phone", R(8, s)),
        ("s_comment", R(10, s))])
    top = jsort.SortExec(jbasic.CoalescePartitionsExec(out, 1), [
        jsort.SortOrder(R(0, f), ascending=False, nulls_first=False),
        jsort.SortOrder(R(2, s)), jsort.SortOrder(R(1, s)),
        jsort.SortOrder(R(3, i64))])
    return jbasic.GlobalLimitExec(jbasic.LocalLimitExec(top, E.Q2_LIMIT),
                                  E.Q2_LIMIT)


@pytest.mark.parametrize("seed", [0, 3])
def test_q2_plan_matches_reference_exec_tree(seed):
    tables = E.tpch_q2_tables(E.tpch_columns(0.01, seed))
    want = _jax_q2_plan(tables).collect()
    tnative.reset_counters()
    got = E.tpch_q2_plan(tables, device="cpu").collect()
    assert len(got) > 2
    assert got == want
    # CPU tensors take the plain versions: no kernel launch is counted.
    assert set(tnative.counters().values()) == {0}


def test_q2_columns_are_its_scans():
    """Each scan holds exactly its schema's columns, in the generator's
    partition split (4 for PART and PARTSUPP, 1 for the rest)."""
    tables = E.tpch_q2_tables(E.tpch_columns(0.002, 1))
    for scan, (table, schema) in E.Q2_SCANS.items():
        parts = tables[scan]
        assert len(parts) == E.TABLE_PARTITIONS[table], scan
        for p in parts:
            assert p[0].names == tuple(n for n, _ in schema), scan


def test_entry_points_raise_without_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.tpch_q2_plan(E.tpch_q2_tables(E.tpch_columns(0.0001, 0)))


def test_chip_smoke_oracle_agrees_with_port():
    """The numpy oracle chip_smoke.py holds the card's q2 run to agrees
    with the port's plan at small scale here."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    cols = E.tpch_columns(0.02, seed=2)
    rows = E.tpch_q2_plan(E.tpch_q2_tables(cols), device="cpu").collect()
    chip_smoke.check_q2(rows, chip_smoke.q2_oracle(cols, E))
