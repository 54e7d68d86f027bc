"""Port parity, end to end through the front end: TPCxBB q5 of
spark_rapids_tpu_torch's ``benchmarks/suites.py`` (the reference's query
text, planned by the port's planner) against the JAX package's own
``suites.xbb_q5(session, data_dir)`` over its parquet, on the CPU.

- ``suite_columns(0.01)`` equals the reference generator's parquet
  (``suites.generate`` at scale 0.01, seed 0) column for column, the NULL
  mask of ``wcs_user_sk`` included; ``suite_tables`` splits each table
  into the reference's files (8 above 100,000 rows, else 1).
- xbb_q5 through the port equals the reference's rows as a multiset (the
  query has no order), with ``variableFloatAgg`` on and under the default
  conf: its sums are integer (Sum of an INT32 CASE is INT64), so both
  confs keep it on the device. The NULL users are dropped by the
  ``isNotNull`` filter before the group-by on both engines.
- ``collect_host()`` equals the reference's bit for bit over the same
  in-memory partitions, and with the kill switches of ``when``, ``isin``
  and ``isnotnull`` off the killed nodes run on the host engine (the
  nullable int64 key through the host filter and the host aggregate's
  key encoders), placed and bridged as the reference places them, with
  the reference's rows.
- chip_smoke.py's numpy oracle agrees with the port's rows.
"""

import os
import sys
from collections import Counter

import numpy as np
import pyarrow.parquet as papq
import pytest

from spark_rapids_tpu import config as JC
from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.api.dataframe import DataFrame as JDataFrame
from spark_rapids_tpu.benchmarks import suites as jsuites
from spark_rapids_tpu.plan import planner as JPL
from spark_rapids_tpu.plan import pruning as JP

from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch.api import DataFrame, TpuSession
from spark_rapids_tpu_torch.benchmarks import suites

from test_torch_logical import jax_tables
from test_torch_placement import REF_OFF, _shape, _transitions
from test_torch_tpch_df import _scan_columns

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE, SEED = 0.01, 0
VFA = {"spark.rapids.sql.variableFloatAgg.enabled": True}
CONFS = {"vfa": (VFA, VFA), "default": ({}, REF_OFF)}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("xbb"))
    jsuites.generate(d, scale=SCALE, seed=SEED)
    return d


@pytest.fixture(scope="module")
def cols():
    return suites.suite_columns(SCALE, seed=SEED)


@pytest.fixture(scope="module")
def port_rows(cols):
    """conf -> the port's xbb_q5 rows, computed on first use."""
    out = {}

    def rows(conf):
        if conf not in out:
            session = TpuSession(dict(CONFS[conf][0]), device="cpu")
            tables = suites.suite_tables(session, cols)["xbb_q5"]
            out[conf] = suites.xbb_q5(session, tables).collect()
        return out[conf]
    return rows


@pytest.mark.parametrize("table", sorted(suites.SCANS["xbb_q5"]))
def test_suite_columns_equal_the_reference_parquet(table, data_dir, cols):
    tbl = papq.read_table(jsuites._paths(data_dir, table))
    assert len(jsuites._paths(data_dir, table)) == \
        suites.table_files(tbl.num_rows)
    for name, v in cols[table].items():
        col = tbl.column(name)
        pool = suites.STRING_POOLS.get(name)
        if pool is not None:
            assert [pool[i] for i in v] == col.to_pylist(), name
        elif isinstance(v, np.ma.MaskedArray):
            mask = np.ma.getmaskarray(v)
            assert mask.any(), name          # the generator's NULLs
            assert col.to_pylist() == [None if m else int(x) for x, m in
                                       zip(np.ma.getdata(v), mask)], name
        else:
            assert col.null_count == 0
            np.testing.assert_array_equal(col.to_numpy(), v, name)


def test_tables_hold_the_columns_the_reference_scans_read(data_dir):
    jdf = jsuites.xbb_q5(JSession(dict(VFA)), data_dir)
    read = _scan_columns(JP.prune_columns(jdf._plan), {})
    scans = suites.SCANS["xbb_q5"]
    assert set(read) == set(scans)
    for table, names in read.items():
        full = [n for n, _ in jdf._session.read.parquet(
            *jsuites._paths(data_dir, table)).schema]
        assert [n for n, _ in scans[table]] == \
            [n for n in full if n in names], table


@pytest.mark.parametrize("conf", sorted(CONFS))
def test_xbb_q5_matches_reference(conf, data_dir, port_rows):
    want = jsuites.xbb_q5(JSession(dict(CONFS[conf][1])),
                          data_dir).collect()
    got = port_rows(conf)
    assert len(want) > 100
    assert Counter(got) == Counter(want)
    # IS NOT NULL dropped the NULL users before the group-by.
    assert all(r[0] is not None for r in got)


# ---------------------------------------------------------------------------
# The host engine: collect_host and the kill switches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def in_memory(cols):
    """(port session, port tables, JAX session, JAX tables): both
    packages over the same in-memory partitions."""
    session = TpuSession(dict(VFA), device="cpu")
    tables = suites.suite_tables(session, cols)
    jsession = JSession(dict(REF_OFF))
    return session, tables, jsession, jax_tables(jsession, tables)


def _jax_df(monkeypatch, in_memory, conf):
    _s, _t, _js, jtables = in_memory
    monkeypatch.setattr(jsuites, "_read", lambda s, tables, t: tables[t])
    return jsuites.xbb_q5(JSession(conf), jtables["xbb_q5"])


def test_collect_host_matches_reference(in_memory, monkeypatch):
    """Bit for bit, row order included: the reference plans its
    exchanges into one partition, as the port does on one device (on the
    tests' eight virtual JAX devices it would plan eight, and this query
    has no ORDER BY to fix the order)."""
    session, tables, _js, _jt = in_memory
    one = dict(REF_OFF, **{"spark.rapids.sql.shuffle.partitions": 1})
    want = JDataFrame(JSession(one), _jax_df(
        monkeypatch, in_memory, one)._plan).collect_host()
    got = suites.xbb_q5(session, tables["xbb_q5"]).collect_host()
    assert got and repr(got) == repr(want)


KILLS = {
    "default": {},
    "when_disabled": {"spark.rapids.sql.expression.when": False},
    "isin_disabled": {"spark.rapids.sql.expression.isin": False},
    "isnotnull_disabled": {"spark.rapids.sql.expression.isnotnull": False},
}
KILLED_NODES = {"default": [], "when_disabled": [
    "LogicalProject", "LogicalAggregate"],
    "isin_disabled": ["LogicalProject"],
    "isnotnull_disabled": ["LogicalFilter"]}


@pytest.mark.parametrize("kill", sorted(KILLS))
def test_placement_and_rows_match_reference(kill, in_memory, monkeypatch):
    session, tables, _js, _jt = in_memory
    raw = KILLS[kill]
    df = DataFrame(TpuSession(raw, device="cpu"),
                   suites.xbb_q5(session, tables["xbb_q5"])._plan)
    jdf = _jax_df(monkeypatch, in_memory, dict(REF_OFF))
    want = JPL.Planner(JC.TpuConf({**raw, **REF_OFF})).plan(jdf._plan)
    got = df._physical()
    assert got.host_fallback_nodes() == want.host_fallback_nodes()
    assert got.host_fallback_nodes() == KILLED_NODES[kill]
    assert got.root_on_device == want.root_on_device
    assert got.meta.explain_lines() == want.meta.explain_lines()
    shape = _shape(got.root)
    assert shape == _shape(want.root)
    assert bool(_transitions(shape)) == bool(KILLED_NODES[kill])
    rows = df.collect()
    assert Counter(rows) == Counter(JDataFrame(
        JSession(REF_OFF), jdf._plan).collect_host())
    assert all(r[0] is not None for r in rows)


# ---------------------------------------------------------------------------
# chip_smoke.py's oracle
# ---------------------------------------------------------------------------

def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


@pytest.mark.parametrize("conf", sorted(CONFS))
def test_chip_smoke_oracle_agrees_with_port(conf, cols, port_rows):
    check, want = _chip_smoke().more_oracles(
        E.tpch_columns(0.001), cols, E, suites)["xbb_q5"]
    check(port_rows(conf), want)
    rows = port_rows(conf)
    with pytest.raises(AssertionError):
        check(rows[1:], want)
    with pytest.raises(AssertionError):
        check([(r[0],) + (r[1] + 1,) + tuple(r[2:]) for r in rows], want)
