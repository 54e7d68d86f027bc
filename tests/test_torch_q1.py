"""Port parity, end to end: the flagship ``entry()`` step and TPC-H q1 of
spark_rapids_tpu_torch against the JAX package, on the CPU.

Tolerances: group keys and counts must match exactly. f64 sums and
averages are compared with a relative tolerance because the two engines
take their prefix sums in different orders (JAX's CPU cumsum vs torch's):
1e-12 for the 4096-row ``entry()`` step, 1e-9 across the partial/final
q1 plan, as the ROADMAP's float-sum rule allows.
"""

import os
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as G
from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu import ops as JO
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.config import TpuConf as JConf
from spark_rapids_tpu.ops import base as jbase
from spark_rapids_tpu.ops import basic as jbasic
from spark_rapids_tpu.ops import sort as jsort

from spark_rapids_tpu_torch import config as tconfig
from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch import ops as TO
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_rows_close(want, got, rtol, float_cols):
    assert len(want) == len(got), (want, got)
    for w, g in zip(want, got):
        assert len(w) == len(g)
        for i, (a, b) in enumerate(zip(w, g)):
            if i in float_cols and a is not None and b is not None:
                assert np.isclose(a, b, rtol=rtol, atol=0.0,
                                  equal_nan=True), (i, w, g)
            else:
                assert a == b, (i, w, g)


# ---------------------------------------------------------------------------
# entry()
# ---------------------------------------------------------------------------

def test_entry_matches_reference():
    jfn, (jex,) = G.entry()
    want = jhost.device_to_host(jfn(jex)).to_pylist()
    tfn, (tex,) = E.entry(device="cpu")
    got = thost.device_to_host(tfn(tex)).to_pylist()
    # Same fingerprint sort -> same group order, not just the same set.
    assert_rows_close(want, got, 1e-12, float_cols={3, 4})


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.tpch_q1_plan(E.tpch_q1_host_batches(0.0001, 2, 0))


# ---------------------------------------------------------------------------
# TPC-H q1: the port's plan vs the same exec tree of the JAX package
# ---------------------------------------------------------------------------

def _jax_host_batch(hb):
    cols = []
    for c in hb.columns:
        t = jdt.type_named(c.dtype.name)
        if t.is_string:
            cols.append(jhost.HostColumn(t, None, c.validity,
                                         str_matrix=c.str_matrix,
                                         str_lengths=c.str_lengths))
        else:
            cols.append(jhost.HostColumn(t, c.data, c.validity))
    return jhost.HostBatch(hb.names, cols)


def _jax_q1_plan(parts):
    """tpch_q1_plan, built from the JAX package's execs."""
    schema = tuple((n, jdt.type_named(t.name)) for n, t in E.Q1_SCHEMA)
    src = jbase.InMemorySourceExec(
        schema, [[_jax_host_batch(hb) for hb in p] for p in parts])
    R, f = JE.BoundReference, jdt.FLOAT64
    filt = jbasic.FilterExec(src, JE.LessThanOrEqual(
        R(6, jdt.DATE), JE.Literal(jdt.DATE, E.Q1_SHIPDATE_CUTOFF)))
    one = JE.lit(1.0)
    proj = jbasic.ProjectExec(filt, [
        ("l_returnflag", R(4, jdt.STRING)),
        ("l_linestatus", R(5, jdt.STRING)),
        ("l_quantity", R(0, f)), ("l_extendedprice", R(1, f)),
        ("l_discount", R(2, f)),
        ("disc_price", JE.Multiply(R(1, f), JE.Subtract(one, R(2, f)))),
        ("charge", JE.Multiply(JE.Multiply(R(1, f),
                                           JE.Subtract(one, R(2, f))),
                               JE.Add(one, R(3, f))))])
    keys = [("l_returnflag", R(0, jdt.STRING)),
            ("l_linestatus", R(1, jdt.STRING))]
    aggs = [JO.AggSpec("sum_qty", JO.Sum(R(2, f))),
            JO.AggSpec("sum_base_price", JO.Sum(R(3, f))),
            JO.AggSpec("sum_disc_price", JO.Sum(R(5, f))),
            JO.AggSpec("sum_charge", JO.Sum(R(6, f))),
            JO.AggSpec("avg_qty", JO.Average(R(2, f))),
            JO.AggSpec("avg_price", JO.Average(R(3, f))),
            JO.AggSpec("avg_disc", JO.Average(R(4, f))),
            JO.AggSpec("count_order", JO.CountStar(None))]
    partial = JO.HashAggregateExec(proj, keys, aggs, mode="partial")
    final = JO.HashAggregateExec(jbasic.CoalescePartitionsExec(partial, 1),
                                 keys, aggs, mode="final")
    return jsort.SortExec(final, [jsort.SortOrder(R(0, jdt.STRING)),
                                  jsort.SortOrder(R(1, jdt.STRING))])


Q1_FLOATS = set(range(2, 9))


@pytest.mark.parametrize("seed", [0, 5])
def test_q1_plan_matches_reference_exec_tree(seed):
    parts = E.tpch_q1_host_batches(0.0015, partitions=4, seed=seed)
    assert len(parts) == 4 and all(1_500 < p[0].num_rows < 3_000
                                   for p in parts)
    want = _jax_q1_plan(parts).collect()
    got = E.tpch_q1_plan(parts, device="cpu").collect()
    assert [r[:2] for r in got] == [("A", "F"), ("N", "F"), ("N", "O"),
                                    ("R", "F")]
    assert_rows_close(want, got, 1e-9, Q1_FLOATS)


def test_q1_columns_match_reference_generator(tmp_path):
    """tpch_q1_columns draws the JAX package's generator stream: same
    seed and scale, same LINEITEM rows."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu.benchmarks import tpch
    tpch.generate(str(tmp_path), scale=0.001, files_per_table=2, seed=3)
    li = pq.read_table(os.path.join(tmp_path, "lineitem")).to_pandas()
    cols = E.tpch_q1_columns(0.001, seed=3)
    for name in ("l_quantity", "l_extendedprice", "l_discount", "l_tax"):
        np.testing.assert_array_equal(li[name].to_numpy(), cols[name])
    ship = (li["l_shipdate"].astype("datetime64[ns]")
            - np.datetime64("1970-01-01")).dt.days.to_numpy()
    np.testing.assert_array_equal(ship, cols["l_shipdate"])
    for name in ("l_returnflag", "l_linestatus"):
        np.testing.assert_array_equal(
            np.array([ord(x) for x in li[name]], np.uint8), cols[name])


def test_chip_smoke_oracle_agrees_with_port():
    """The numpy oracle chip_smoke.py holds the card's q1 run to agrees
    with the port's plan at small scale here."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    cols = E.tpch_q1_columns(0.002, seed=1)
    parts = E.tpch_q1_host_batches(0.002, partitions=3, seed=1)
    rows = E.tpch_q1_plan(parts, device="cpu").collect()
    chip_smoke.check_q1(rows, chip_smoke.q1_oracle(
        cols, E.Q1_SHIPDATE_CUTOFF))


# ---------------------------------------------------------------------------
# Aggregate modes beyond q1's (complete, zero-key, hasNans=false)
# ---------------------------------------------------------------------------

def _agg_data(seed):
    rng = np.random.default_rng(seed)
    n = 300
    k = rng.integers(0, 5, n)
    s = [None if i % 13 == 0 else ["x", "yy", "", "zzzz"][v]
         for i, v in enumerate(rng.integers(0, 4, n))]
    i64 = [None if i % 7 == 0 else int(v) for i, v in
           enumerate(rng.integers(-2 ** 62, 2 ** 62, n))]
    f = rng.normal(0, 100, n)
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.03] = np.inf
    f64 = [None if i % 11 == 0 else float(v) for i, v in enumerate(f)]
    return {"k": [int(v) for v in k], "s": s, "i": i64, "f": f64}


def _agg_schema(D):
    return (("k", D.INT32), ("s", D.STRING), ("i", D.INT64),
            ("f", D.FLOAT64))


def _agg_plan(E_, O, D, Src, parts, keyed, mode_chain, **src_kw):
    R = E_.BoundReference
    schema = _agg_schema(D)
    src = Src(schema, [[b] for b in parts], **src_kw)
    keys = [("s", R(1, D.STRING)), ("k", R(0, D.INT32))] if keyed else []
    aggs = [O.AggSpec("si", O.Sum(R(2, D.INT64))),
            O.AggSpec("sf", O.Sum(R(3, D.FLOAT64))),
            O.AggSpec("af", O.Average(R(3, D.FLOAT64))),
            O.AggSpec("ci", O.Count(R(2, D.INT64))),
            O.AggSpec("n", O.CountStar(None))]
    if mode_chain == "complete":
        return O.HashAggregateExec(src, keys, aggs, mode="complete")
    partial = O.HashAggregateExec(src, keys, aggs, mode="partial")
    coal = (jbasic if O is JO else TO).CoalescePartitionsExec(partial, 1)
    fkeys = [(n, R(i, e.data_type())) for i, (n, e) in enumerate(keys)]
    return O.HashAggregateExec(coal, fkeys, aggs, mode="final")


@pytest.mark.parametrize("keyed", [True, False])
@pytest.mark.parametrize("chain", ["complete", "partial_final"])
@pytest.mark.parametrize("has_nans", [True, False])
def test_aggregate_modes_match_reference(keyed, chain, has_nans):
    datas = [_agg_data(s) for s in (1, 2, 3)]
    if not has_nans:     # hasNans=false asserts finite float data
        for d in datas:
            d["f"] = [None if v is None or not np.isfinite(v) else v
                      for v in d["f"]]
    jparts = [jhost.HostBatch.from_pydict(_agg_schema(jdt), d) for d in datas]
    tparts = [thost.HostBatch.from_pydict(_agg_schema(tdt), d) for d in datas]
    jplan = _agg_plan(JE, JO, jdt, jbase.InMemorySourceExec, jparts, keyed,
                      chain)
    tplan = _agg_plan(TE, TO, tdt, TO.InMemorySourceExec, tparts, keyed,
                      chain, device="cpu")
    key = "spark.rapids.sql.hasNans"
    want = jplan.collect(jbase.ExecContext(conf=JConf({key: has_nans})))
    got = tplan.collect(TO.ExecContext(conf=tconfig.TpuConf(
        {key: has_nans})))
    nk = 2 if keyed else 0
    assert_rows_close(want, got, 1e-9, {nk + 1, nk + 2})


def test_zero_key_aggregate_over_no_rows():
    schema = _agg_schema(tdt)
    src = TO.InMemorySourceExec(schema, [[]], device="cpu")
    agg = TO.HashAggregateExec(src, [], [
        TO.AggSpec("n", TO.CountStar(None)),
        TO.AggSpec("s", TO.Sum(TE.BoundReference(2, tdt.INT64)))])
    assert agg.collect() == [(0, None)]
