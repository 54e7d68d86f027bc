"""Port parity, end to end through the front end: TPC-H q1-q6 of
spark_rapids_tpu_torch's ``benchmarks/tpch.py`` (the reference's query
text, planned by the port's planner) against the JAX package's own
``tpch.qN(session, data_dir)`` over its parquet, on the CPU.

- One small dataset a module (scale 0.005, 2 files a table) from the
  reference's ``tpch.generate``; the reference runs each query on it with
  ``variableFloatAgg`` on. The port runs the same query on
  ``tpch_tables`` of ``entry.tpch_columns`` at the same seed and scale
  (the generator's rows, draw for draw) with ``device="cpu"``.
- Keys, counts and the order of rows exact; floats within rtol 1e-9
  (the engines take their sums in different orders).
- Each query's in-memory tables hold exactly the columns the
  reference's scan pruning keeps of its parquet.
- q1-q4 through the front end equal the hand-built trees of ``entry``
  bit for bit; chip_smoke.py's numpy oracles agree with q1-q6.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import os
import sys

import pytest

from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu.plan import pruning as JP

from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch

from test_torch_logical import QUERIES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE, SEED = 0.005, 0
RTOL = 1e-9
VFA = {"spark.rapids.sql.variableFloatAgg.enabled": True}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch"))
    jtpch.generate(d, scale=SCALE, files_per_table=2, seed=SEED)
    return d


@pytest.fixture(scope="module")
def reference(data_dir):
    """query -> the JAX package's rows, computed on first use."""
    session = JSession(dict(VFA))
    out = {}

    def rows(q):
        if q not in out:
            out[q] = jtpch.QUERIES[q](session, data_dir).collect()
        return out[q]
    return rows


@pytest.fixture(scope="module")
def port():
    """(session, columns, tables, rows): ``rows`` keeps each query's rows
    once collected, as ``reference`` does, for the tests that read them."""
    session = TpuSession(dict(VFA), device="cpu")
    cols = E.tpch_columns(SCALE, seed=SEED)
    return session, cols, tpch.tpch_tables(session, cols), {}


def _port_rows(port, q):
    session, _cols, tables, rows = port
    if q not in rows:
        rows[q] = tpch.QUERIES[q](session, tables[q]).collect()
    return rows[q]


def _assert_rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert isinstance(a, float) and a == pytest.approx(
                    b, rel=RTOL, abs=0.0), (g, w)
            else:
                assert a == b, (g, w)


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_reference(q, reference, port):
    want = reference(q)
    assert want, f"{q} returned no rows at scale {SCALE}: nothing compared"
    _assert_rows_close(_port_rows(port, q), want)


def _scan_columns(plan, out):
    if isinstance(plan, JL.FileScan):
        table = os.path.basename(os.path.dirname(plan.paths[0]))
        out.setdefault(table, set()).update(n for n, _ in plan.source_schema)
    for c in plan.children:
        _scan_columns(c, out)
    return out


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


HAND_BUILT = {
    "q1": lambda cols: E.tpch_q1_plan(E.table_partitions(
        cols["lineitem"], E.Q1_SCHEMA, E.TABLE_PARTITIONS["lineitem"]),
        device="cpu"),
    "q3": lambda cols: E.tpch_q3_plan(E.tpch_q3_tables(cols), device="cpu"),
    "q4": lambda cols: E.tpch_q4_plan(E.tpch_q4_tables(cols), device="cpu"),
    "q2": lambda cols: E.tpch_q2_plan(E.tpch_q2_tables(cols), device="cpu"),
}


@pytest.mark.parametrize("q", sorted(HAND_BUILT))
def test_front_end_equals_hand_built_tree(q, port):
    want = HAND_BUILT[q](port[1]).collect()
    assert _port_rows(port, q) == want


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


@pytest.fixture(scope="module")
def oracles(port):
    """chip_smoke.py's (check, expected rows) of each query."""
    return _chip_smoke().df_oracles(port[1], E)


@pytest.mark.parametrize("q", QUERIES)
def test_chip_smoke_oracles_agree_with_port(q, port, oracles):
    check, want = oracles[q]
    check(_port_rows(port, q), want)


def test_q5_and_q6_oracles_catch_a_wrong_answer(port, oracles):
    rows5 = _port_rows(port, "q5")
    with pytest.raises(AssertionError):
        oracles["q5"][0](rows5[::-1], oracles["q5"][1])
    with pytest.raises(AssertionError):
        oracles["q5"][0]([(n, v * (1 + 1e-6)) for n, v in rows5],
                         oracles["q5"][1])
    rows6 = _port_rows(port, "q6")
    with pytest.raises(AssertionError):
        oracles["q6"][0]([(rows6[0][0] * (1 + 1e-6),)], oracles["q6"][1])
