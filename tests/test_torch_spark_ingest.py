"""Port parity of plan-text ingest (``plan/spark_ingest.py``) on the CPU:
the captured Spark physical plans of ``tests/fixtures/spark_plans``
through both packages' ``ingest_spark_plan`` against the same parquet
files (the reference's ``tpch.generate``, scale 0.005, 2 files a table,
seed 0).

- Each fixture's rows: the port's (``device="cpu"``, and its host
  engine) against the reference's (its host engine: no XLA compiles) and
  against the port's own run of the query text; the logical plans the two
  ingesters build have the same tagged trees.
- The error cases raise the same errors with the same messages.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import os

import pytest

from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.plan import spark_ingest as JI

from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.plan import spark_ingest as I

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures",
                        "spark_plans")
CONF = {"spark.rapids.sql.variableFloatAgg.enabled": True,
        "spark.rapids.sql.hasNans": False}
RTOL = 1e-9


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_ingest"))
    jtpch.generate(d, scale=0.005, files_per_table=2, seed=0)
    return d


def _tables(data_dir):
    return {t: tpch._paths(data_dir, t)
            for t in ("lineitem", "orders", "customer")}


def _text(q):
    with open(os.path.join(FIXTURES, f"{q}.txt")) as f:
        return f.read()


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=RTOL, abs=0.0), (g, w)
            else:
                assert a == b, (g, w)


@pytest.mark.parametrize("q", ["q6", "q3"])
def test_ingested_plan_matches_reference(q, data_dir):
    tables = _tables(data_dir)
    session = TpuSession(dict(CONF), device="cpu")
    df = I.ingest_spark_plan(_text(q), session, tables)
    jsession = JSession(dict(CONF, **{"spark.rapids.sql.cost.enabled":
                                      False}))
    jdf = JI.ingest_spark_plan(_text(q), jsession, tables)
    assert df.columns == jdf.columns
    assert df._physical().meta.explain_lines() == \
        jdf._physical().meta.explain_lines()
    want = jdf.collect_host()
    assert want
    got = df.collect()
    _close(got, want)
    _close(df.collect_host(), want)
    _close(got, tpch.QUERIES[q](session, data_dir).collect())
    assert session.ingest_spark_plan(_text(q), tables)._physical().tree() \
        == df._physical().tree()


BAD = {
    "unknown operator": ("*(1) FancyNewExec [x#1]\n", None),
    "misaligned": ("*(1) Project [x#1]\n"
                   "  +- Filter (x#1 > 2)\n"
                   "      +- FileScan parquet [x#1]\n", None),
    "no operator": ("== Physical Plan ==\n\n", None),
    "missing columns": (
        "*(1) FileScan parquet [l_shipdate#26,no_such_col#99] "
        "Batched: true, Format: Parquet, Location: "
        "InMemoryFileIndex[file:/data/tpch/lineitem], "
        "ReadSchema: struct<l_shipdate:date>\n", "tables"),
    "unknown table": (
        "*(1) FileScan parquet [x#1] Batched: true, Location: "
        "InMemoryFileIndex[file:/data/tpch/widgets]\n", "tables"),
    "trailing text": (
        "*(1) Filter (l_quantity#4 < 24.0) junk\n"
        "+- *(1) FileScan parquet [l_quantity#4] Location: "
        "InMemoryFileIndex[file:/data/tpch/lineitem]\n", "tables"),
    "unsupported function": (
        "*(1) Project [frobnicate(l_quantity#4) AS y#9]\n"
        "+- *(1) FileScan parquet [l_quantity#4] Location: "
        "InMemoryFileIndex[file:/data/tpch/lineitem]\n", "tables"),
    "bad aggregate": (
        "*(2) HashAggregate(keys=[], output=[x#1])\n"
        "+- *(1) FileScan parquet [l_quantity#4] Location: "
        "InMemoryFileIndex[file:/data/tpch/lineitem]\n", "tables"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_errors_match_reference(case, data_dir):
    text, which = BAD[case]
    tables = _tables(data_dir) if which else {}
    with pytest.raises(I.SparkPlanParseError) as got:
        I.ingest_spark_plan(text, TpuSession(dict(CONF), device="cpu"),
                            tables)
    with pytest.raises(JI.SparkPlanParseError) as want:
        JI.ingest_spark_plan(text, JSession(dict(CONF)), tables)
    assert str(got.value) == str(want.value)
    assert issubclass(I.SparkPlanParseError, ValueError)


@pytest.mark.parametrize("expr", [
    "(a#1 + 2) * b#2", "NOT (a#1 = 3) OR isnull(b#2)",
    "CASE WHEN (a#1 > 1) THEN 1 ELSE 0 END", "cast(a#1 as bigint)",
    "a#1 IN (1,2,3)", "substring(s#3, 1, 2)", "s#3 = SM CASE",
    "(s#3 = SM CASE) AND (a#1 > 0)", "d#4 >= 1995-01-01",
    "sum((a#1 * 1.5D))", "count(1)", "-a#1 < -2.5"])
def test_expressions_parse_as_the_reference(expr):
    """The same AST, or the same error: a multi-word bare literal at the
    very end of an expression ("SM CASE") is refused by both, as trailing
    text (ROADMAP queue C)."""
    assert _outcome(I, expr) == _outcome(JI, expr)


def _outcome(mod, expr):
    try:
        return "ok", repr(_shape(mod._parse_expr(expr)))
    except mod.SparkPlanParseError as e:
        return "error", str(e)


def _shape(c):
    """A Column's AST as nested tuples of kinds and literal values."""
    node = getattr(c, "node", c)
    if isinstance(node, tuple):
        return tuple(_shape(x) for x in node)
    if hasattr(node, "name") and not isinstance(node, str):
        return getattr(node, "name")
    return node
