"""Port parity, end to end through the front end: the TPC-DS-like q67,
ds_q3, ds_q42, ds_q55, ds_q89 and ds_q98 of spark_rapids_tpu_torch's
``benchmarks/suites.py`` (the reference's query text, planned by the
port's planner) against the JAX package's own ``suites.<q>(session,
data_dir)`` over its parquet, on the CPU.

- ``suite_columns(0.01)`` equals the reference generator's parquet
  (``suites.generate`` at scale 0.01, seed 0) for ``item``, ``store``,
  ``date_dim`` and ``store_sales``, and each query's tables hold exactly
  the columns the reference's scan pruning keeps.
- Each query equals the reference's rows with ``variableFloatAgg`` on
  and under the default conf (the float Sum aggregate, and q67's ROLLUP
  expand with it, on the host engine; the windows and sorts on the
  device): exactly for q67 (its ranks and sums), ds_q3, ds_q42 and
  ds_q55, whose sums are of whole numbers; ds_q89's averages and ds_q98's
  ratios within the harness tolerance.
- ``collect_host()`` and the kill switches: tests/test_torch_tpcds_host.py.
- chip_smoke.py's numpy oracles agree with the port's rows, and catch a
  wrong answer.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import os
import sys

import numpy as np
import pyarrow.parquet as papq
import pytest

from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.benchmarks import suites as jsuites
from spark_rapids_tpu.plan import pruning as JP

from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import suites

from harness import assert_rows_equal
from test_torch_placement import REF_OFF
from test_torch_tpch_df import _scan_columns

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE, SEED = 0.01, 0
QUERIES = ("q67", "ds_q3", "ds_q42", "ds_q55", "ds_q89", "ds_q98")
# Every number of these is a sum of whole numbers: exact on both engines.
EXACT = ("q67", "ds_q3", "ds_q42", "ds_q55")
TABLES = ("item", "store", "date_dim", "store_sales")
VFA = {"spark.rapids.sql.variableFloatAgg.enabled": True}
# conf name -> (the port's conf, the reference's)
CONFS = {"vfa": (VFA, dict(VFA, **REF_OFF)), "default": ({}, REF_OFF)}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpcds"))
    jsuites.generate(d, scale=SCALE, seed=SEED)
    return d


@pytest.fixture(scope="module")
def cols():
    return suites.suite_columns(SCALE, seed=SEED)


@pytest.fixture(scope="module")
def port_rows(cols):
    """(query, conf) -> the port's rows, computed on first use."""
    out = {}

    def rows(q, conf):
        if (q, conf) not in out:
            session = TpuSession(dict(CONFS[conf][0]), device="cpu")
            tables = suites.suite_tables(session, cols, (q,))[q]
            out[(q, conf)] = suites.QUERIES[q](session, tables).collect()
        return out[(q, conf)]
    return rows


@pytest.mark.parametrize("table", TABLES)
def test_suite_columns_equal_the_reference_parquet(table, data_dir, cols):
    tbl = papq.read_table(jsuites._paths(data_dir, table))
    assert len(jsuites._paths(data_dir, table)) == \
        suites.table_files(tbl.num_rows)
    assert set(cols[table]) == set(tbl.column_names)
    for name, v in cols[table].items():
        col = tbl.column(name)
        assert col.null_count == 0
        pool = suites.STRING_POOLS.get(name)
        if pool is not None:
            assert [pool[i] for i in v] == col.to_pylist(), name
        else:
            got = col.to_numpy()
            assert got.dtype == v.dtype, name
            np.testing.assert_array_equal(got, v, name)


@pytest.mark.parametrize("q", QUERIES)
def test_tables_hold_the_columns_the_reference_scans_read(q, data_dir):
    jdf = jsuites.QUERIES[q](JSession(dict(VFA)), data_dir)
    read = _scan_columns(JP.prune_columns(jdf._plan), {})
    scans = suites.SCANS[q]
    assert set(read) == set(scans)
    for table, names in read.items():
        full = jdf._session.read.parquet(
            *jsuites._paths(data_dir, table)).schema
        want = [(n, t.name) for n, t in full if n in names]
        assert [(n, t.name) for n, t in scans[table]] == want, table


@pytest.mark.parametrize("conf", sorted(CONFS))
@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_reference(q, conf, data_dir, port_rows):
    want = jsuites.QUERIES[q](JSession(dict(CONFS[conf][1])),
                              data_dir).collect()
    got = port_rows(q, conf)
    assert len(want) > 10, f"{q}: too few rows to compare"
    if q in EXACT:
        assert repr(got) == repr(want)
    else:
        assert_rows_equal(got, want, approx_float=True, msg=q)


def test_q67_rollup_levels_and_ranks(port_rows):
    """q67's first rows: the grand total (every key a rolled-up NULL,
    alone in the window's NULL partition, rank 1), then the first
    category's subtotal, ranked first in its partition. Every row is a
    rollup level: once a key is NULL, so is every later key."""
    rows = port_rows("q67", "vfa")
    assert rows[0][:8] == (None,) * 8 and rows[0][9] == 1
    first = sorted(suites.CATEGORIES)[0]
    assert rows[1][:8] == (first,) + (None,) * 7 and rows[1][9] == 1
    assert rows[0][8] > rows[1][8]
    for r in rows:
        level = next((k for k in range(8) if r[k] is None), 8)
        assert r[level:8] == (None,) * (8 - level), r
        assert isinstance(r[9], int) and 1 <= r[9] <= 100


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
def oracles(cols):
    return _chip_smoke().ds_oracles(cols, suites)


@pytest.mark.parametrize("conf", sorted(CONFS))
@pytest.mark.parametrize("q", QUERIES)
def test_chip_smoke_oracles_agree_with_port(q, conf, port_rows, oracles):
    check, want = oracles[q]
    check(port_rows(q, conf), want)


def test_oracles_catch_a_wrong_answer(port_rows, oracles):
    rows = port_rows("q67", "vfa")
    check, want = oracles["q67"]
    with pytest.raises(AssertionError):
        check(rows[:-1], want)
    with pytest.raises(AssertionError):      # one rank off
        check(rows[:5] + [rows[5][:9] + (rows[5][9] + 1,)] + rows[6:], want)
    with pytest.raises(AssertionError):      # exact: no tolerance
        check(rows[:3] + [rows[3][:8] + (rows[3][8] + 1e-3, rows[3][9])]
              + rows[4:], want)
    rows = port_rows("ds_q89", "default")
    check, want = oracles["ds_q89"]
    with pytest.raises(AssertionError):
        check([r[:4] + (r[4] * (1 + 1e-6),) for r in rows], want)
