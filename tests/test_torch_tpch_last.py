"""Port parity, end to end through the front end: ``repart`` and TPC-H
q11, q15, q20 and q22 of spark_rapids_tpu_torch's benchmarks (the
reference's query text, planned by the port's planner) against the JAX
package's own query bodies, on the CPU; and ``Substring`` and the
fixed-width ``Cast`` against the reference's expressions.

- One dataset a module: ``entry.tpch_columns(0.01)`` and
  ``suites.suite_columns(0.01)`` (seed 0), the same in-memory partitions
  in both packages (the reference's ``_read`` looks the table up). Each
  query runs once a conf in each package, with
  ``spark.rapids.sql.shuffle.partitions`` pinned to 1 on both: with
  ``variableFloatAgg`` on and under the default conf. Keys, counts and
  the order of rows exact; floats within rtol 1e-9; q11 as a set of
  rows, as the reference's ``_SET_COMPARE`` checks it. repart, q15 and
  q22 are held to the reference's ``collect``; q11 and q20 to its
  ``collect_host`` under the same conf (the host engine, which its own
  tests hold to its device engine), since compiling their device plans
  takes the reference ~30 s on this CPU.
- At four partitions (pinned on both packages) each query equals the
  reference at four partitions and its own one-partition rows.
- ``collect_host()`` equals the reference's at one partition.
- The exec trees of these queries and of q4, q13 and q21 name the
  reference planner's execs at one and at four partitions, and the
  default conf places the nodes chip_smoke.py expects on the host.
- Each query's tables hold exactly the columns the reference's scan
  pruning keeps of its parquet (scale 0.001).
- chip_smoke.py's phase-16 numpy oracles agree with the port's rows.
- ``Substring`` (1-based, negative and zero positions, lengths past the
  end and negative, multibyte UTF-8, NULLs) and ``Cast`` between the
  fixed-width types (NaN, infinities, -0.0, subnormals, saturation,
  narrowing) evaluate as the reference's on both engines, bit for bit.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import config as JC
from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.benchmarks import suites as jsuites
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.plan import planner as JPL
from spark_rapids_tpu.plan import pruning as JP

from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch.api import DataFrame, TpuSession
from spark_rapids_tpu_torch.benchmarks import suites, tpch
from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost

from harness import assert_rows_equal
from test_torch_logical import jax_tables
from test_torch_placement import REF_OFF, _shape
from test_torch_tpch_df import _scan_columns

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPCH = ("q11", "q15", "q20", "q22")
QUERIES = ("repart",) + TPCH
SCALE, SEED = 0.01, 0
VFA = {"spark.rapids.sql.variableFloatAgg.enabled": True}
# conf name -> (the port's conf, the reference's)
CONFS = {"vfa": (VFA, dict(REF_OFF, **VFA)), "default": ({}, REF_OFF)}


def _parts(n):
    return {"spark.rapids.sql.shuffle.partitions": n}


def _ref_query(q):
    return jsuites.QUERIES[q] if q == "repart" else jtpch.QUERIES[q]


def _port_query(q):
    return suites.QUERIES[q] if q == "repart" else tpch.QUERIES[q]


@pytest.fixture(scope="module")
def data():
    """(TPC-H columns, suite columns, port tables, JAX tables): every
    query's in-memory scans, the same partitions in both packages."""
    cols = E.tpch_columns(SCALE, seed=SEED)
    xcols = suites.suite_columns(SCALE, seed=SEED)
    session = TpuSession(dict(VFA), device="cpu")
    tables = dict(tpch.tpch_tables(session, cols, TPCH),
                  **suites.suite_tables(session, xcols, ("repart",)))
    return cols, xcols, tables, jax_tables(JSession(dict(REF_OFF)), tables)


# The queries held to the reference's device engine; the rest to its host
# engine (see the module docstring).
DEVICE_REF = ("repart", "q15", "q22")


@pytest.fixture(scope="module")
def reference(data):
    """(query, raw conf) -> the JAX package's rows (``collect`` or, with
    ``host``, ``collect_host``), computed on first use."""
    out = {}
    jtables = data[3]

    def rows(q, conf: dict, host: bool = False):
        host = host or q not in DEVICE_REF
        key = (q, tuple(sorted(conf.items())), host)
        if key not in out:
            with pytest.MonkeyPatch.context() as mp:
                for mod in (jtpch, jsuites):
                    mp.setattr(mod, "_read", lambda s, tables, t: tables[t])
                df = _ref_query(q)(JSession(dict(conf)), jtables[q])
                out[key] = df.collect_host() if host else df.collect()
        return out[key]
    return rows


@pytest.fixture(scope="module")
def port(data):
    """(query, raw conf) -> (the port's DataFrame, its rows)."""
    out = {}
    tables = data[2]

    def run(q, conf: dict):
        key = (q, tuple(sorted(conf.items())))
        if key not in out:
            df = DataFrame(TpuSession(dict(conf), device="cpu"),
                           _port_query(q)(None, tables[q])._plan)
            out[key] = (df, df.collect())
        return out[key]
    return run


def _as_compared(q, rows):
    return sorted(rows) if q in jtpch._SET_COMPARE else rows


def _close(got, want):
    """Rows equal, floats to rtol 1e-9, as lists."""
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(y, float):
                assert isinstance(x, float) and np.isclose(
                    x, y, rtol=1e-9, atol=0.0), (a, b)
            else:
                assert x == y, (a, b)


@pytest.mark.parametrize("conf", sorted(CONFS))
@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_reference(q, conf, reference, port):
    pconf, jconf = CONFS[conf]
    want = reference(q, dict(jconf, **_parts(1)))
    assert want, f"{q} returned no rows at scale {SCALE}: nothing compared"
    _df, got = port(q, dict(pconf, **_parts(1)))
    _close(_as_compared(q, got), _as_compared(q, want))


@pytest.mark.parametrize("q", QUERIES)
def test_four_partitions_match_reference_and_one(q, reference, port):
    want = reference(q, dict(CONFS["vfa"][1], **_parts(4)))
    _df, got = port(q, dict(VFA, **_parts(4)))
    _close(_as_compared(q, got), _as_compared(q, want))
    _df, one = port(q, dict(VFA, **_parts(1)))
    _close(_as_compared(q, got), _as_compared(q, one))


@pytest.mark.parametrize("q", QUERIES)
def test_collect_host_matches_reference(q, reference, port):
    want = reference(q, dict(REF_OFF, **_parts(1)), host=True)
    df, _rows = port(q, _parts(1))
    assert_rows_equal(_as_compared(q, df.collect_host()),
                      _as_compared(q, want), approx_float=True)


@pytest.mark.parametrize("n", (1, 4))
@pytest.mark.parametrize("q", QUERIES + ("q4", "q13", "q21"))
def test_exec_tree_names_match_reference(q, n, data):
    """The port's exec tree names the reference planner's execs, node for
    node, under the default conf (bridges included) at n partitions."""
    cols, _x, tables, jtables = data
    if q not in tables:
        session = TpuSession(dict(VFA), device="cpu")
        tables = tpch.tpch_tables(session, cols, (q,))
        jtables = jax_tables(JSession(dict(REF_OFF)), tables)
    raw = _parts(n)
    got = DataFrame(TpuSession(raw, device="cpu"),
                    _port_query(q)(None, tables[q])._plan)._physical()
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jtpch, jsuites):
            mp.setattr(mod, "_read", lambda s, tables, t: tables[t])
        jplan = _ref_query(q)(JSession(dict(REF_OFF)), jtables[q])._plan
    want = JPL.Planner(JC.TpuConf(dict(REF_OFF, **raw))).plan(jplan)
    assert _shape(got.root) == _shape(want.root)
    assert got.host_fallback_nodes() == want.host_fallback_nodes()
    assert got.meta.explain_lines() == want.meta.explain_lines()


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


@pytest.mark.parametrize("q", QUERIES)
def test_default_conf_host_nodes_are_chip_smokes(q, port):
    df, _rows = port(q, _parts(1))
    assert df._physical().host_fallback_nodes() == \
        _chip_smoke().LAST_DEFAULT_HOST[q]


@pytest.fixture(scope="module")
def oracles(data):
    cs = _chip_smoke()
    return cs.last_oracles(data[0], data[1], E, suites)


@pytest.mark.parametrize("conf", sorted(CONFS))
@pytest.mark.parametrize("q", QUERIES)
def test_chip_smoke_oracles_agree_with_port(q, conf, port, oracles):
    check, want = oracles[q]
    _df, got = port(q, dict(CONFS[conf][0], **_parts(1)))
    check(got, want)


def test_oracles_catch_a_wrong_answer(port, oracles):
    _df, rows = port("repart", dict(VFA, **_parts(1)))
    check, want = oracles["repart"]
    with pytest.raises(AssertionError):
        check([(b, n + 1) for b, n in rows], want)
    _df, rows = port("q22", dict(VFA, **_parts(1)))
    check, want = oracles["q22"]
    with pytest.raises(AssertionError):
        check(rows[:-1], want)
    with pytest.raises(AssertionError):
        check([r[:2] + (r[2] * (1 + 1e-6),) for r in rows], want)


def test_full_join_oracle_agrees_with_port(data):
    """chip_smoke.py's full outer join (phase 16 (d)) and its numpy
    counts, at one and four partitions."""
    cs = _chip_smoke()
    from spark_rapids_tpu_torch.plan import logical as L
    want = cs.full_join_oracle(data[0])
    assert len(want) == 3
    for n in (1, 4):
        session = TpuSession(dict(VFA, **_parts(n)), device="cpu")
        df = cs.full_join_frames(session, data[0], E, L)
        assert df.collect() == want
        assert df.collect_host() == want


@pytest.fixture(scope="module")
def parquet_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_last"))
    jtpch.generate(d, scale=0.001, files_per_table=1, seed=SEED)
    return d


@pytest.mark.parametrize("q", TPCH)
def test_tables_hold_the_columns_the_reference_scans_read(q, parquet_dir):
    jdf = jtpch.QUERIES[q](JSession(dict(VFA)), parquet_dir)
    read = _scan_columns(JP.prune_columns(jdf._plan), {})
    assert set(read) == set(tpch.SCANS[q])
    for table, names in read.items():
        full = [n for n, _ in jdf._session.read.parquet(
            *jtpch._paths(parquet_dir, table)).schema]
        assert [n for n, _ in tpch.SCANS[q][table]] == \
            [n for n in full if n in names], table


# ---------------------------------------------------------------------------
# Substring and Cast against the reference's expressions
# ---------------------------------------------------------------------------

def _string_batches(values, pos, lens):
    """(JAX device batch, port device batch, JAX host batch, port host
    batch) of (s STRING, pos INT32, len INT32); None is NULL."""
    cap = len(values)
    hc = jhost.HostColumn.from_values(jdt.STRING, values)
    m, ln = jhost.strings_to_matrix(hc)
    w = max(8, m.shape[1])
    m = np.pad(m, ((0, 0), (0, w - m.shape[1])))
    sv = np.array([v is not None for v in values])
    ints = []
    for arr in (pos, lens):
        v = np.array([x is not None for x in arr])
        ints.append((np.array([0 if x is None else x for x in arr],
                              np.int32), v))
    jb = jbatch.DeviceBatch((
        jbatch.DeviceColumn(jdt.STRING, jnp.asarray(m), jnp.asarray(sv),
                            jnp.asarray(ln)),) + tuple(
        jbatch.DeviceColumn(jdt.INT32, jnp.asarray(d), jnp.asarray(v))
        for d, v in ints), jnp.asarray(cap, jnp.int32))
    tb = tbatch.DeviceBatch((
        tbatch.DeviceColumn(tdt.STRING, torch.from_numpy(m.copy()),
                            torch.from_numpy(sv.copy()),
                            torch.from_numpy(ln.copy())),) + tuple(
        tbatch.DeviceColumn(tdt.INT32, torch.from_numpy(d.copy()),
                            torch.from_numpy(v.copy()))
        for d, v in ints), torch.tensor(cap, dtype=torch.int32))
    names = ("s", "p", "n")
    jh = jhost.HostBatch(names, [jhost.HostColumn.from_values(
        jdt.STRING, values)] + [jhost.HostColumn(jdt.INT32, d, v)
                                for d, v in ints])
    th = thost.HostBatch(names, [thost.HostColumn.from_values(
        tdt.STRING, values)] + [thost.HostColumn(tdt.INT32, d, v)
                                for d, v in ints])
    return jb, tb, jh, th


SUBSTR_VALUES = ["hello", "", "héllo wörld", None, "a", "ab", "日本語テキスト",
                 "xyz", "spark sql", "q22-phone"]
SUBSTR_CASES = [(1, 2), (0, 3), (-3, 2), (-20, 5), (3, 100), (2, -1),
                (7, 0), (-1, 1), (2, 2147483647), (None, 2)]


@pytest.mark.parametrize("case", range(len(SUBSTR_CASES)))
def test_substring_matches_reference_on_both_engines(case):
    p, n = SUBSTR_CASES[case]
    k = len(SUBSTR_VALUES)
    pos = [p] * k
    lens = [n] * k
    # One row a case also takes per-row positions and lengths.
    pos[0], lens[0] = SUBSTR_CASES[(case + 1) % len(SUBSTR_CASES)]
    jb, tb, jh, th = _string_batches(SUBSTR_VALUES, pos, lens)
    jexpr = JE.Substring(JE.BoundReference(0, jdt.STRING),
                         JE.BoundReference(1, jdt.INT32),
                         JE.BoundReference(2, jdt.INT32))
    texpr = TE.Substring(TE.BoundReference(0, tdt.STRING),
                         TE.BoundReference(1, tdt.INT32),
                         TE.BoundReference(2, tdt.INT32))
    want = jbatch.DeviceBatch((jexpr.eval(jb),), jb.num_rows)
    got = tbatch.DeviceBatch((texpr.eval(tb),), tb.num_rows)
    want_rows = jhost.device_to_host(want).to_pylist()
    assert thost.device_to_host(got).to_pylist() == want_rows
    hw = jhost.HostBatch(("x",), [jexpr.eval_host(jh)]).to_pylist()
    hg = thost.HostBatch(("x",), [texpr.eval_host(th)]).to_pylist()
    assert hg == hw == want_rows
    if p is not None and n > 0:
        assert any(r[0] not in (None, "") for r in want_rows)


_F = [0.0, -0.0, 1.5, -1.5, 2.9, -2.9, np.nan, np.inf, -np.inf, 1e-310,
      -1e-310, 3e9, -3e9, 1e19, -1e19, 127.9, 300.7, -129.2, 65536.5,
      2147483647.5]
_I = [0, 1, -1, 127, 128, -129, 255, 32768, -32769, 2 ** 31 - 1, -2 ** 31,
      2 ** 40 + 7, -2 ** 40 - 3, 2 ** 63 - 1, -2 ** 63, 86_400_000_123,
      -86_400_000_123, 42, 7, -7]
_SOURCES = {
    "float64": np.array(_F, np.float64),
    "float32": np.array(_F, np.float32),
    "int64": np.array(_I, np.int64),
    "int32": np.array(_I, np.int64).astype(np.int32),
    "int16": np.array(_I, np.int64).astype(np.int16),
    "int8": np.array(_I, np.int64).astype(np.int8),
    "bool": np.array(_I, np.int64) % 2 == 1,
    "date": np.array(_I, np.int64).astype(np.int32) % 100_000,
    "timestamp": np.array(_I, np.int64) // 1000,
}
_TARGETS = ("float64", "float32", "int64", "int32", "int16", "int8", "bool",
            "date", "timestamp")
CASTS = [(s, t) for s in _SOURCES for t in _TARGETS
         if s != t and not (s in ("date", "timestamp") and t == "bool")]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype != np.bool_ else a


@pytest.mark.parametrize("src,to", CASTS)
def test_cast_matches_reference_on_both_engines(src, to):
    data = _SOURCES[src]
    n = len(data)
    valid = np.ones(n, bool)
    valid[5] = False
    data = np.where(valid, data, np.zeros(1, data.dtype))
    jt, tt = jdt.type_named(src), tdt.type_named(src)
    jb = jbatch.DeviceBatch((jbatch.DeviceColumn(
        jt, jnp.asarray(data), jnp.asarray(valid)),),
        jnp.asarray(n, jnp.int32))
    tb = tbatch.DeviceBatch((tbatch.DeviceColumn(
        tt, torch.from_numpy(data.copy()), torch.from_numpy(valid.copy())),),
        torch.tensor(n, dtype=torch.int32))
    jexpr = JE.Cast(JE.BoundReference(0, jt), jdt.type_named(to))
    texpr = TE.Cast(TE.BoundReference(0, tt), tdt.type_named(to))
    jc, tc = jexpr.eval(jb), texpr.eval(tb)
    np.testing.assert_array_equal(tc.validity.numpy(),
                                  np.asarray(jc.validity))
    np.testing.assert_array_equal(_bits(tc.data.numpy()),
                                  _bits(np.asarray(jc.data)))
    jh = jexpr.eval_host(jhost.HostBatch(("c",), [
        jhost.HostColumn(jt, data, valid)]))
    th = texpr.eval_host(thost.HostBatch(("c",), [
        thost.HostColumn(tt, data, valid)]))
    np.testing.assert_array_equal(th.validity, jh.validity)
    np.testing.assert_array_equal(_bits(th.data), _bits(jh.data))


