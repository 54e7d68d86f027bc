"""Port parity of the TPC-DS-like q67, ds_q3, ds_q42, ds_q55, ds_q89 and
ds_q98 on the host engine and across the engines, against the JAX
package over the same in-memory partitions (scale 0.003), on the CPU.

- ``collect_host()`` equals the reference's bit for bit.
- Placement under the default conf (the float Sum aggregate, and q67's
  ROLLUP expand with it, on the host engine), with the kill switch of
  the logical Window node off, and with that of the Aggregate node off:
  the host nodes, the root's engine, the explain lines and the exec tree
  with its bridges equal the reference's, and the rows equal the
  reference's host engine (exactly where every number is a sum of whole
  numbers).
"""

import pytest

from spark_rapids_tpu import config as JC
from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.api.dataframe import DataFrame as JDataFrame
from spark_rapids_tpu.benchmarks import suites as jsuites
from spark_rapids_tpu.plan import planner as JPL

from spark_rapids_tpu_torch.api import DataFrame, TpuSession
from spark_rapids_tpu_torch.benchmarks import suites

from harness import assert_rows_equal
from test_torch_logical import jax_tables
from test_torch_placement import REF_OFF, _shape, _transitions
from test_torch_tpcds import EXACT, QUERIES, SEED, VFA

SMALL = 0.003


@pytest.fixture(scope="module")
def in_memory():
    """(port session, port tables, JAX tables): both packages over the
    same in-memory partitions."""
    session = TpuSession(dict(VFA), device="cpu")
    tables = suites.suite_tables(session, suites.suite_columns(SMALL, SEED),
                                 QUERIES)
    return session, tables, jax_tables(JSession(dict(REF_OFF)), tables)


def _jax_df(monkeypatch, in_memory, q, conf):
    monkeypatch.setattr(jsuites, "_read", lambda s, tables, t: tables[t])
    return jsuites.QUERIES[q](JSession(conf), in_memory[2][q])


@pytest.mark.parametrize("q", QUERIES)
def test_collect_host_matches_reference(q, in_memory, monkeypatch):
    session, tables, _jt = in_memory
    one = dict(REF_OFF, **{"spark.rapids.sql.shuffle.partitions": 1})
    want = JDataFrame(JSession(one), _jax_df(
        monkeypatch, in_memory, q, one)._plan).collect_host()
    got = suites.QUERIES[q](session, tables[q]).collect_host()
    assert got and repr(got) == repr(want)


KILLS = {
    "default_conf": ({}, ["LogicalAggregate"]),
    "window_disabled": (dict(VFA, **{
        "spark.rapids.sql.exec.LogicalWindow": False}), ["LogicalWindow"]),
    "aggregate_disabled": (dict(VFA, **{
        "spark.rapids.sql.exec.LogicalAggregate": False}),
        ["LogicalAggregate"]),
}


@pytest.mark.parametrize("q,kill", [("q67", k) for k in sorted(KILLS)]
                         + [("ds_q98", "window_disabled")])
def test_placement_and_rows_match_reference(q, kill, in_memory,
                                            monkeypatch):
    session, tables, _jt = in_memory
    raw, killed = KILLS[kill]
    df = DataFrame(TpuSession(raw, device="cpu"),
                   suites.QUERIES[q](session, tables[q])._plan)
    jdf = _jax_df(monkeypatch, in_memory, q, dict(REF_OFF))
    want = JPL.Planner(JC.TpuConf({**raw, **REF_OFF})).plan(jdf._plan)
    got = df._physical()
    assert got.host_fallback_nodes() == want.host_fallback_nodes()
    assert got.host_fallback_nodes() == killed
    assert got.root_on_device == want.root_on_device
    assert got.meta.explain_lines() == want.meta.explain_lines()
    shape = _shape(got.root)
    assert shape == _shape(want.root)
    assert _transitions(shape)
    rows = df.collect()
    ref = JDataFrame(JSession(REF_OFF), jdf._plan).collect_host()
    if q in EXACT:
        assert repr(rows) == repr(ref)
    else:
        assert_rows_equal(rows, ref, approx_float=True, msg=q)


def test_grouping_sets_and_windows_are_planned_not_refused(in_memory):
    """The planner lowers q67's ROLLUP to an expand under the two-stage
    aggregate keyed by the grouping id, and its rank() to a window over
    one partition."""
    session, tables, _jt = in_memory
    tree = suites.q67(session, tables["q67"])._physical().tree()
    assert "ExpandExec" in tree and "WindowExec" in tree
    assert "final by ['i_category', 'i_class', 'i_brand', " \
        "'i_product_name', 'd_year', 'd_qoy', 'd_moy', 's_store_id', " \
        "'__grouping_id']" in tree
