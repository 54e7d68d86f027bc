"""Port parity, end to end from parquet files: TPC-H through the port's
``benchmarks/tpch.py`` ``qN(session, data_dir)`` (the reference's query
text reading ``session.read.parquet(*_paths(data_dir, table))``), on the
CPU.

- One dataset a module: the reference's ``tpch.generate`` at scale 0.005,
  2 files a table, seed 0.
- q1, q3, q4 and q6 from the files through the port against the JAX
  package's own ``tpch.qN(session, data_dir)`` on the same files, run on
  the reference's host engine (``collect_host``, no XLA compiles); the
  reference's device path over this dataset is what
  ``tests/test_torch_tpch_df.py`` holds the port's in-memory runs to,
  and the in-memory runs are held to the file runs here.
- All 22 queries from the files against the port's in-memory
  ``tpch_tables`` runs of the same rows (which the other port tests hold
  to the reference).
- Each query's plan over the files against the reference's plan over the
  same files: the tagged tree with its join-strategy notes (the footer
  size estimates, to the byte), and the joins and exchanges the physical
  tree plans, in order.

Keys, counts and the order of rows exact; floats within rtol 1e-9.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import pytest

from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.benchmarks import tpch as jtpch

from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.io.scan import FileScanExec

SCALE, SEED = 0.005, 0
RTOL = 1e-9
VFA = {"spark.rapids.sql.variableFloatAgg.enabled": True}
REFERENCE_QUERIES = ("q1", "q3", "q4", "q6")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_files"))
    jtpch.generate(d, scale=SCALE, files_per_table=2, seed=SEED)
    return d


@pytest.fixture(scope="module")
def port():
    return TpuSession(dict(VFA), device="cpu")


@pytest.fixture(scope="module")
def in_memory(port):
    cols = E.tpch_columns(SCALE, seed=SEED)
    return tpch.tpch_tables(port, cols)


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


@pytest.mark.parametrize("q", REFERENCE_QUERIES)
def test_query_from_files_matches_reference(q, data_dir, port):
    want = jtpch.QUERIES[q](JSession(dict(VFA)), data_dir).collect_host()
    assert want, f"{q} returned no rows: nothing compared"
    df = tpch.QUERIES[q](port, data_dir)
    scans = _scans(df._physical().root, [])
    assert scans and all(s.paths == tpch._paths(data_dir, s.paths[0].split(
        "/")[-2]) for s in scans)
    _assert_rows_close(df.collect(), want)


@pytest.mark.parametrize("q", sorted(tpch.QUERIES))
def test_query_from_files_matches_in_memory(q, data_dir, port, in_memory):
    got = tpch.QUERIES[q](port, data_dir).collect()
    want = tpch.QUERIES[q](port, in_memory[q]).collect()
    _assert_rows_close(got, want)


def _scans(e, out):
    if isinstance(e, FileScanExec):
        out.append(e)
    for c in e.children:
        _scans(c, out)
    return out


def _joins_and_exchanges(e, out):
    name = type(e).__name__
    if "Join" in name:
        out.append(name)
    elif name == "ShuffleExchangeExec":
        out.append(type(e.partitioning).__name__)
    for c in e.children:
        _joins_and_exchanges(c, out)
    return out


@pytest.mark.parametrize("q", sorted(tpch.QUERIES))
def test_plan_over_files_matches_reference(q, data_dir, port):
    """The tagged tree (join strategies with their byte estimates) and
    the joins and exchanges of the physical tree, as the reference plans
    them over the same files (its cost placement off: not ported; its
    exchanges plan one partition a device, the port's one)."""
    jsession = JSession(dict(VFA, **{"spark.rapids.sql.cost.enabled":
                                     False}))
    want = jtpch.QUERIES[q](jsession, data_dir)._physical()
    got = tpch.QUERIES[q](port, data_dir)._physical()
    assert got.meta.explain_lines() == want.meta.explain_lines()
    assert _joins_and_exchanges(got.root, []) == \
        _joins_and_exchanges(want.root, [])
    assert len(_scans(got.root, [])) == sum(
        1 for line in got.meta.explain_lines() if "<FileScan>" in line)


def test_paths_are_the_references(data_dir):
    for t in ("lineitem", "orders", "nation"):
        assert tpch._paths(data_dir, t) == jtpch._paths(data_dir, t)


def test_repartition_prunes_and_estimates_as_reference(data_dir, port):
    """A scan below a repartition narrows to what is read above it, and a
    repartitioned build side has its child's size (the port planned such
    a join ``shuffle`` on an unknown size until file scans came)."""
    from spark_rapids_tpu.plan import logical as JL
    from spark_rapids_tpu.plan import pruning as JP
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu_torch.plan import pruning as P

    def query(M, session):
        orders = session.read.parquet(*tpch._paths(data_dir, "orders")) \
            .repartition(4, "o_custkey").select("o_custkey", "o_orderkey")
        cust = session.read.parquet(*tpch._paths(data_dir, "customer"))
        return cust.join_on(orders, ["c_custkey"], ["o_custkey"]) \
            .group_by("c_mktsegment").agg(M.agg_count().alias("n"))
    jsession = JSession(dict(VFA, **{"spark.rapids.sql.cost.enabled":
                                     False}))
    got, want = query(L, port), query(JL, jsession)
    pruned = P.prune_columns(got._plan)
    jpruned = JP.prune_columns(want._plan)
    build, jbuild = pruned.child.children[1], jpruned.child.children[1]
    assert P.estimate_bytes(build) == JP.estimate_bytes(jbuild) > 0
    assert got._physical().meta.explain_lines() == \
        want._physical().meta.explain_lines()
    assert "auto join strategy -> broadcast" in got._physical().explain()
    scans = _scans(got._physical().root, [])
    assert sorted(tuple(n for n, _ in s.schema) for s in scans) == [
        ("c_custkey", "c_mktsegment"), ("o_custkey",)]
