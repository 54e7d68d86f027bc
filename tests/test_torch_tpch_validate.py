"""Port parity, end to end through the front end: TPC-H q10, q13, q16,
q17, q18 and q21 of spark_rapids_tpu_torch's ``benchmarks/tpch.py`` (the
reference's query text, planned by the port's planner) against the JAX
package's own ``tpch.qN(session, data_dir)`` over its parquet, on the
CPU.

- One small dataset a module (scale 0.005, seed 0, 2 files a table) from
  the reference's ``tpch.generate``. Each query runs once a conf in each
  package: with ``variableFloatAgg`` on (every node on the device) and
  under the default conf (the float Sum/Avg aggregates of q10, q17 and
  q18 on the host engine). The port runs on ``tpch_tables`` of
  ``entry.tpch_columns`` at the same seed and scale with
  ``device="cpu"``. Keys, counts and the order of rows exact; floats
  within rtol 1e-9; q10 as a set of rows, as the reference's
  ``_SET_COMPARE`` checks it. q18 keeps no order at seed 0 (no order
  holds more than 300 units at this scale): ``test_torch_distinct.py``
  also runs it at seed 1, and q21's conditional semi and anti joins on a
  small table.
- ``collect_host()`` equals the reference's bit for bit over the same
  in-memory partitions.
- Placement: the host nodes, the root's engine, the explain lines and
  the exec tree with its bridges equal the reference's under the default
  conf, with ``like`` killed (``spark.rapids.sql.expression.like``) and
  with the aggregate killed (``spark.rapids.sql.exec.LogicalAggregate``),
  where the killed nodes run on the host engine and still give the
  reference's rows.
- Each query's tables hold exactly the columns the reference's scan
  pruning keeps of its parquet; the q7-q19 columns of ``tpch_columns``
  are unchanged by the columns it now keeps (a digest pinned on the
  tree before them).
- chip_smoke.py's numpy oracles agree with the port's rows.
"""

import hashlib
import os
import sys

import numpy as np
import pytest

from spark_rapids_tpu import config as JC
from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.api.dataframe import DataFrame as JDataFrame
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.plan import planner as JPL
from spark_rapids_tpu.plan import pruning as JP

from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch.api import DataFrame, TpuSession
from spark_rapids_tpu_torch.benchmarks import suites
from spark_rapids_tpu_torch.benchmarks import tpch

from harness import assert_rows_equal
from test_torch_logical import (  # noqa: F401  (small_tables: a fixture)
    jax_query, jax_tables, small_tables)
from test_torch_placement import REF_OFF, _shape, _transitions
from test_torch_tpch_df import _assert_rows_close, _scan_columns

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = ("q10", "q13", "q16", "q17", "q18", "q21")
SCALE, SEED = 0.005, 0
VFA = {"spark.rapids.sql.variableFloatAgg.enabled": True}
# conf name -> (the port's conf, the reference's)
CONFS = {"vfa": (VFA, VFA), "default": ({}, REF_OFF)}
# The q7-q19 scan columns of tpch_columns(0.005, seed=0), hashed on the
# tree before it kept the columns of q10-q21: the random stream did not
# move.
Q7_Q19_DIGEST = \
    "5a0fd358abb6b251eb864331fa297782ec24f1e3920204730fbe41e74a72fb5d"
# Queries whose float aggregates the default conf places on the host.
FLOAT_AGGS = ("q10", "q17", "q18")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_validate"))
    jtpch.generate(d, scale=SCALE, files_per_table=2, seed=SEED)
    return d


@pytest.fixture(scope="module")
def reference(data_dir):
    """(query, conf) -> the JAX package's rows, computed on first use."""
    sessions = {c: JSession(dict(j)) for c, (_p, j) in CONFS.items()}
    out = {}

    def rows(q, conf):
        if (q, conf) not in out:
            out[q, conf] = jtpch.QUERIES[q](sessions[conf],
                                            data_dir).collect()
        return out[q, conf]
    return rows


@pytest.fixture(scope="module")
def port():
    """(columns, conf -> (session, tables), rows cache)."""
    cols = E.tpch_columns(SCALE, seed=SEED)
    runs = {}
    for c, (pconf, _j) in CONFS.items():
        session = TpuSession(dict(pconf), device="cpu")
        runs[c] = (session, tpch.tpch_tables(session, cols, QUERIES))
    return cols, runs, {}


def _port_rows(port, q, conf):
    _cols, runs, rows = port
    if (q, conf) not in rows:
        session, tables = runs[conf]
        rows[q, conf] = tpch.QUERIES[q](session, tables[q]).collect()
    return rows[q, conf]


def _as_compared(q, rows):
    return sorted(rows) if q in jtpch._SET_COMPARE else rows


@pytest.mark.parametrize("conf", sorted(CONFS))
@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_reference(q, conf, reference, port):
    want = reference(q, conf)
    if q != "q18":
        assert want, f"{q} returned no rows at scale {SCALE}: nothing " \
            "compared"
    _assert_rows_close(_as_compared(q, _port_rows(port, q, conf)),
                       _as_compared(q, want))


@pytest.mark.parametrize("q", QUERIES)
def test_collect_host_matches_reference(q, small_tables, monkeypatch):
    session, tables, _js, _jt = small_tables
    jsession = JSession(dict(REF_OFF))
    jdf = jax_query(monkeypatch, q, jsession,
                    jax_tables(jsession, {q: tables[q]})[q])
    want = jdf.collect_host()
    got = tpch.QUERIES[q](session, tables[q]).collect_host()
    assert repr(got) == repr(want)


@pytest.mark.parametrize("q", QUERIES)
def test_tables_hold_the_columns_the_reference_scans_read(q, data_dir):
    """Per table, the union of the reference's pruned parquet scans'
    columns is the port's scan schema, in the generator's order."""
    jdf = jtpch.QUERIES[q](JSession(dict(VFA)), data_dir)
    read = _scan_columns(JP.prune_columns(jdf._plan), {})
    assert set(read) == set(tpch.SCANS[q])
    for table, names in read.items():
        full = [n for n, _ in jdf._session.read.parquet(
            *jtpch._paths(data_dir, table)).schema]
        assert [n for n, _ in tpch.SCANS[q][table]] == \
            [n for n in full if n in names], table


def test_q7_q19_columns_unchanged():
    cols = E.tpch_columns(SCALE, seed=SEED)
    h = hashlib.sha256()
    for q in ("q7", "q8", "q9", "q12", "q14", "q19"):
        for t, schema in sorted(tpch.SCANS[q].items()):
            for name, _ in schema:
                a = np.ascontiguousarray(cols[t][name])
                h.update(f"{q}.{t}.{name}:{a.dtype}:{a.shape}".encode())
                h.update(a.tobytes())
    assert h.hexdigest() == Q7_Q19_DIGEST


# ---------------------------------------------------------------------------
# Placement: the default conf and the kill switches
# ---------------------------------------------------------------------------

KILLS = {
    "default": {},
    "like_disabled": {"spark.rapids.sql.expression.like": False},
    "agg_disabled": dict(VFA, **{"spark.rapids.sql.exec.LogicalAggregate":
                                 False}),
}
_REF_HOST_ROWS = {}


def _plans(q, raw, small_tables, monkeypatch):
    session, tables, jsession, jtables = small_tables
    df = DataFrame(TpuSession(raw, device="cpu"),
                   tpch.QUERIES[q](session, tables[q])._plan)
    jplan = jax_query(monkeypatch, q, jsession, jtables[q])._plan
    want = JPL.Planner(JC.TpuConf({**raw, **REF_OFF})).plan(jplan)
    return df._physical(), want, df


@pytest.mark.parametrize("kill", sorted(KILLS))
@pytest.mark.parametrize("q", QUERIES)
def test_placement_matches_reference(q, kill, small_tables, monkeypatch):
    got, want, df = _plans(q, KILLS[kill], small_tables, monkeypatch)
    assert got.host_fallback_nodes() == want.host_fallback_nodes()
    assert got.root_on_device == want.root_on_device
    assert got.meta.explain_lines() == want.meta.explain_lines()
    shape = _shape(got.root)
    assert shape == _shape(want.root)
    if kill == "default":
        assert bool(got.host_fallback_nodes()) == (q in FLOAT_AGGS)
        return
    if not got.host_fallback_nodes():
        return      # the killed kind is not in this query
    assert _transitions(shape)
    if q not in _REF_HOST_ROWS:
        _s, _t, jsession, jtables = small_tables
        _REF_HOST_ROWS[q] = JDataFrame(JSession(REF_OFF), jax_query(
            monkeypatch, q, jsession, jtables[q])._plan).collect_host()
    got_rows, want_rows = df.collect(), _REF_HOST_ROWS[q]
    if q in jtpch._SET_COMPARE:
        got_rows, want_rows = sorted(got_rows), sorted(want_rows)
    assert_rows_equal(got_rows, want_rows, approx_float=True)


def test_distinct_plan_matches_reference(small_tables, monkeypatch):
    """q16's COUNT DISTINCT: partial -> exchange -> merge -> mixed_final,
    keyed as the reference keys each stage."""
    got, want, _df = _plans("q16", {}, small_tables, monkeypatch)

    def aggs(e, out):
        if type(e).__name__ == "HashAggregateExec":
            out.append((e.mode, list(e.group_names)))
        for c in e.children:
            aggs(c, out)
        return out
    stages = aggs(got.root, [])
    assert stages == aggs(want.root, [])
    keys = ["p_brand", "p_type", "p_size"]
    assert stages == [("mixed_final", keys),
                      ("merge", keys + ["__distinct_x"]),
                      ("partial", keys + ["__distinct_x"])]


# ---------------------------------------------------------------------------
# chip_smoke.py's oracles
# ---------------------------------------------------------------------------

def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


@pytest.fixture(scope="module")
def oracles(port):
    cs = _chip_smoke()
    return cs.distinct_oracles(port[0], suites.suite_columns(0.001), E,
                               suites)


@pytest.mark.parametrize("conf", sorted(CONFS))
@pytest.mark.parametrize("q", QUERIES)
def test_chip_smoke_oracles_agree_with_port(q, conf, port, oracles):
    check, want = oracles[q]
    if q == "q18":
        assert want == [] and _port_rows(port, q, conf) == []
        return
    check(_port_rows(port, q, conf), want)


def test_oracles_catch_a_wrong_answer(port, oracles):
    rows13 = _port_rows(port, "q13", "vfa")
    check, want = oracles["q13"]
    with pytest.raises(AssertionError):
        check(rows13[::-1], want)
    with pytest.raises(AssertionError):
        check([(c, n + 1) for c, n in rows13], want)
    rows10 = _port_rows(port, "q10", "default")
    check, want = oracles["q10"]
    with pytest.raises(AssertionError):
        check([r[:2] + (r[2] * (1 + 1e-6),) + r[3:] for r in rows10], want)
    rows16 = _port_rows(port, "q16", "vfa")
    check, want = oracles["q16"]
    with pytest.raises(AssertionError):
        check(rows16[:-1], want)
