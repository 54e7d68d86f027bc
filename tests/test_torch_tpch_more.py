"""Port parity, end to end through the front end: TPC-H q7, q8, q9, q12,
q14 and q19 of spark_rapids_tpu_torch's ``benchmarks/tpch.py`` (the
reference's query text, planned by the port's planner) against the JAX
package's own ``tpch.qN(session, data_dir)`` over its parquet, on the
CPU.

- One small dataset a module (scale 0.005, seed 0, 2 files a table) from
  the reference's ``tpch.generate``. Each query runs once a conf in each
  package: with ``variableFloatAgg`` on (every node on the device) and
  under the default conf (the float Sum aggregates of q7, q8, q9, q14 and
  q19 on the host engine). The port runs on ``tpch_tables`` of
  ``entry.tpch_columns`` at the same seed and scale (the generator's
  rows, draw for draw) with ``device="cpu"``.
- Keys, counts and the order of rows exact; floats within rtol 1e-9 (the
  engines take their sums in different orders).
- ``collect_host()`` equals the reference's bit for bit over the same
  in-memory partitions (the reference's pruned parquet read in other
  files would sum in another order).
- Placement: the host nodes, the root's engine, the explain lines and
  the exec tree with its bridges equal the reference's under the default
  conf and with the new kinds' kill switches off
  (``spark.rapids.sql.expression.when`` / ``isin`` / ``year`` / ``div``),
  where the killed node runs on the host engine and still gives the
  reference's rows.
- Each query's tables hold exactly the columns the reference's scan
  pruning keeps of its parquet; the q1-q6 columns of ``tpch_columns``
  are unchanged by the columns it keeps for q7-q19 (a pinned digest).
- chip_smoke.py's numpy oracles agree with the port's rows.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
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
QUERIES = ("q7", "q8", "q9", "q12", "q14", "q19")
SCALE, SEED = 0.005, 0
VFA = {"spark.rapids.sql.variableFloatAgg.enabled": True}
# conf name -> (the port's conf, the reference's)
CONFS = {"vfa": (VFA, VFA), "default": ({}, REF_OFF)}
# The q1-q6 scan columns of tpch_columns(0.005, seed=0), hashed before it
# kept the columns of q7-q19: the random stream did not move.
Q1_Q6_DIGEST = \
    "e7a6c251c7128d7d58c654d37fffb6efc57ef649afcbe3ec44a9403b618b582a"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_more"))
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


@pytest.mark.parametrize("conf", sorted(CONFS))
@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_reference(q, conf, reference, port):
    want = reference(q, conf)
    assert want, f"{q} returned no rows at scale {SCALE}: nothing compared"
    _assert_rows_close(_port_rows(port, q, conf), want)


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


def test_q1_q6_columns_unchanged():
    cols = E.tpch_columns(SCALE, seed=SEED)
    h = hashlib.sha256()
    for q in ("q1", "q6", "q3", "q5", "q2", "q4"):
        for t, schema in sorted(tpch.SCANS[q].items()):
            for name, _ in schema:
                a = np.ascontiguousarray(cols[t][name])
                h.update(f"{q}.{t}.{name}:{a.dtype}:{a.shape}".encode())
                h.update(a.tobytes())
    assert h.hexdigest() == Q1_Q6_DIGEST


# ---------------------------------------------------------------------------
# Placement: the default conf and the new kinds' kill switches
# ---------------------------------------------------------------------------

KILLS = {
    "default": {},
    "when_disabled": {"spark.rapids.sql.expression.when": False},
    "isin_disabled": {"spark.rapids.sql.expression.isin": False},
    "year_disabled": {"spark.rapids.sql.expression.year": False},
    "div_disabled": {"spark.rapids.sql.expression.div": False},
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
        floats = q not in ("q12",)
        assert bool(got.host_fallback_nodes()) == floats
        return
    if not got.host_fallback_nodes():
        return      # the killed kind is not in this query
    assert _transitions(shape)
    if q not in _REF_HOST_ROWS:
        _s, _t, jsession, jtables = small_tables
        _REF_HOST_ROWS[q] = JDataFrame(JSession(REF_OFF), jax_query(
            monkeypatch, q, jsession, jtables[q])._plan).collect_host()
    assert_rows_equal(df.collect(), _REF_HOST_ROWS[q], approx_float=True)


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
    return cs.more_oracles(port[0], suites.suite_columns(0.001), E,
                             suites)


@pytest.mark.parametrize("conf", sorted(CONFS))
@pytest.mark.parametrize("q", QUERIES)
def test_chip_smoke_oracles_agree_with_port(q, conf, port, oracles):
    check, want = oracles[q]
    check(_port_rows(port, q, conf), want)


def test_oracles_catch_a_wrong_answer(port, oracles):
    rows9 = _port_rows(port, "q9", "vfa")
    check, want = oracles["q9"]
    with pytest.raises(AssertionError):
        check(rows9[::-1], want)
    with pytest.raises(AssertionError):
        check([(n, y, v * (1 + 1e-6)) for n, y, v in rows9], want)
    with pytest.raises(AssertionError):
        check([(n, y + 1, v) for n, y, v in rows9], want)
    rows12 = _port_rows(port, "q12", "default")
    check, want = oracles["q12"]
    with pytest.raises(AssertionError):
        check([(m, h + 1, lo) for m, h, lo in rows12], want)
