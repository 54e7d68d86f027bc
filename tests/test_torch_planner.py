"""Port parity of the planner: spark_rapids_tpu_torch.plan.planner and
api.dataframe against the JAX package's, on the CPU.

- ``wrap_and_tag`` gives the reference's reasons and notes for the same
  plan and conf: the float-aggregation gate, disabled exec and
  expression keys, ``spark.rapids.sql.enabled``, the sort-merge
  replacement key.
- After planning, the explain lines of TPC-H q1-q6 equal the reference's
  (join strategy notes and build estimates included); where the port
  refuses a plan, its lines equal the reference's once its extra
  "not ported" reasons are set aside.
- ``Planner.plan`` refuses with ``NotImplementedError`` naming every
  node the port cannot run on either engine, with its reasons: kinds it
  has not ported, aggregates it has no class for (under a ROLLUP too),
  window functions it has not ported, join keys that are not columns.
  Exchanges into more than one partition (a partitioned window's too),
  full outer and keyless joins, which it refused before it had the
  exchange and the shuffled and nested-loop joins, run and give the
  reference's rows. A node tagged only for the reference's
  reasons (a float aggregate under the default conf, a float
  sum(DISTINCT) there too, a disabled exec) runs on the host
  engine instead and gives the reference's rows; test mode asserts on it
  unless ``spark.rapids.sql.test.allowedNonTpu`` names it, as the
  reference does.
- The shuffled join: q4 with the broadcast threshold under its build
  estimate plans ``shuffle`` in both planners (the same note), the
  port's ``ShuffledHashJoinExec`` reads both sides through hash
  exchanges, and the rows equal the reference's shuffled hash join's.
- The DataFrame API: builders (python rows, dicts, numpy columns),
  ``with_column``, ``group_by().count()``, ``limit``, re-planning on a
  conf change (a filter disabled by its kill switch moves to the host),
  and a session with no card raising.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import copy

import numpy as np
import pytest
import torch

from spark_rapids_tpu import config as JC
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu.plan import planner as JPL

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.ops import ShuffledHashJoinExec
from spark_rapids_tpu_torch.parallel.exchange import ShuffleExchangeExec
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan import planner as PL

from test_torch_logical import (  # noqa: F401  (small_tables: a fixture)
    QUERIES, jax_query, small_tables)

VFA = "spark.rapids.sql.variableFloatAgg.enabled"


# The reference's layers the port has not ported: cost-based placement,
# and the stage pipeline (which would prematerialize a host-side
# exchange of a mixed plan on the device).
REF_OFF = {"spark.rapids.sql.cost.enabled": False,
           "spark.rapids.sql.pipeline.enabled": False}


def _confs(raw: dict):
    """The same raw conf for both planners; the reference's unported
    layers off."""
    return C.TpuConf(raw), JC.TpuConf({**raw, **REF_OFF})


def _tags(meta):
    out = [(meta.plan.name, list(meta.reasons), list(meta.notes))]
    for ch in meta.children:
        out.extend(_tags(ch))
    return out


def _without_not_ported(meta):
    m = copy.copy(meta)
    m.reasons = [r for r in meta.reasons if "is not ported" not in r]
    m.children = [_without_not_ported(c) for c in meta.children]
    return m


# ---------------------------------------------------------------------------
# Tagging
# ---------------------------------------------------------------------------

TAG_CONFS = {
    "default": {},
    "variable_float_agg": {VFA: True},
    "sql_disabled": {"spark.rapids.sql.enabled": False, VFA: True},
    "exec_disabled": {VFA: True,
                      "spark.rapids.sql.exec.LogicalFilter": False,
                      "spark.rapids.sql.exec.LogicalJoin": "false"},
    "expr_disabled": {VFA: True, "spark.rapids.sql.expression.mul": "false",
                      "spark.rapids.sql.expression.lt": False},
    "string_values": {VFA: "true",
                      "spark.rapids.sql.exec.LogicalSort": "0"},
}


@pytest.mark.parametrize("q", QUERIES)
@pytest.mark.parametrize("conf", sorted(TAG_CONFS))
def test_tags_match_reference(q, conf, small_tables, monkeypatch):
    session, tables, jsession, jtables = small_tables
    pconf, jconf = _confs(TAG_CONFS[conf])
    got = PL.wrap_and_tag(tpch.QUERIES[q](session, tables[q])._plan, pconf)
    want = JPL.wrap_and_tag(
        jax_query(monkeypatch, q, jsession, jtables[q])._plan, jconf)
    assert _tags(got) == _tags(want)


def _scan_df(session, n=6):
    schema = (("a", dt.INT64), ("f", dt.FLOAT64), ("s", dt.STRING))
    return session.create_dataframe(
        {"a": list(range(n)), "f": [0.5 * i for i in range(n)],
         "s": ["x", "y", "z"] * (n // 3)}, schema, num_partitions=2)


def _gated_plans(M, df_scan):
    """Plans built with each package's DSL over a scan DataFrame: float
    and int aggregates, an unported expression under a filter, a
    shuffle-strategy join."""
    c = M.col
    scan = df_scan._plan
    return {
        "float_avg_int_sum": M.LogicalAggregate(
            scan, [("s", c("s"))], [("x", M.agg_avg(c("f"))),
                                    ("y", M.agg_sum(c("a"))),
                                    ("z", M.agg_avg(c("a")))]),
        "unported_under_filter": M.LogicalFilter(M.LogicalProject(
            scan, [("r", M.Column(("md5", c("s")))), ("a", c("a"))]),
            c("a") > 1),
        "shuffle_join": M.LogicalJoin(scan, scan, [c("a")], [c("a")],
                                      "inner", strategy="shuffle"),
    }


@pytest.mark.parametrize("plan", ["float_avg_int_sum",
                                  "unported_under_filter", "shuffle_join"])
@pytest.mark.parametrize("raw", [
    {}, {VFA: True},
    {"spark.rapids.sql.replaceSortMergeJoin.enabled": False, VFA: True},
    {"spark.rapids.sql.expression.md5": False}])
def test_gates_match_reference_apart_from_not_ported(plan, raw):
    from spark_rapids_tpu.api import TpuSession as JSession
    pconf, jconf = _confs(raw)
    got = PL.wrap_and_tag(_gated_plans(L, _scan_df(
        TpuSession(device="cpu")))[plan], pconf)
    want = JPL.wrap_and_tag(_gated_plans(JL, _scan_df(JSession()))[plan],
                            jconf)
    assert _tags(_without_not_ported(got)) == _tags(want)
    extra = [r for _n, reasons, _ in _tags(got) for r in reasons
             if "is not ported" in r]
    assert extra == (["expression md5 is not ported"]
                     if plan == "unported_under_filter" else [])


# ---------------------------------------------------------------------------
# Explain after planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", QUERIES)
def test_explain_matches_reference(q, small_tables, monkeypatch):
    session, tables, jsession, jtables = small_tables
    pconf, jconf = _confs({VFA: True})
    got = PL.Planner(pconf, device="cpu").plan(
        tpch.QUERIES[q](session, tables[q])._plan)
    want = JPL.Planner(jconf).plan(
        jax_query(monkeypatch, q, jsession, jtables[q])._plan)
    assert got.meta.explain_lines() == want.meta.explain_lines()
    assert got.explain("NOT_ON_GPU") == "\n".join(
        want.meta.explain_lines(not_on_device_only=True))
    if q != "q1" and q != "q6":
        assert "auto join strategy -> broadcast" in got.explain()


# ---------------------------------------------------------------------------
# Refusal
# ---------------------------------------------------------------------------

def _host_cases(M, session):
    """The cases tagged only for the reference's reasons, in either
    package's DSL: case -> (DataFrame, conf updates, [(node, reason)])."""
    df = _scan_df(session)
    c = M.col
    return {
        "host_tagged_float_sum": (
            df.group_by("s").agg(M.agg_sum(c("f"))), {VFA: False},
            [("LogicalAggregate", "sum over float64 can vary with "
              "evaluation order")]),
        "disabled_exec": (
            df.filter(c("a") > 1), {"spark.rapids.sql.exec.LogicalFilter":
                                    False},
            [("LogicalFilter", "disabled by spark.rapids.sql.exec."
              "LogicalFilter")]),
        # DISTINCT aggregates are planned (partial / merge / mixed_final);
        # a float sum(DISTINCT) under the default conf takes the float
        # gate to the host engine, as the reference's does.
        "distinct_aggregate": (
            df.group_by("s").agg(M.agg_sum_distinct(c("f")),
                                 M.agg_count_distinct(c("f")),
                                 M.agg_count()),
            {VFA: False},
            [("LogicalAggregate", "sum over float64 can vary with "
              "evaluation order")]),
    }


def _lifted_cases(M, session):
    """Plans the port refused before it had the exchange, the shuffled
    and nested-loop joins, full outer joins and First, in either
    package's DSL: case -> (DataFrame, conf updates)."""
    df = _scan_df(session)
    other = _scan_df(session).select(M.col("a").alias("b"),
                                     M.col("s").alias("t"))
    return {
        "multi_partition_exchange": (
            df.group_by("s").count().order_by("s"),
            {"spark.rapids.sql.shuffle.partitions": 4}),
        "multi_partition_shuffle_join": (
            df.join_on(other, ["a"], ["b"]),
            {"spark.rapids.sql.shuffle.partitions": 2,
             "spark.rapids.sql.autoBroadcastJoinThreshold": -1}),
        "full_outer_join": (
            df.filter(M.col("a") > 1).join_on(
                other.filter(M.col("b") < 4), ["a"], ["b"], how="full"),
            {}),
        "keyless_join": (df.join_on(other, [], []), {}),
        # Grouping sets are planned (ExpandExec); first() under one was
        # refused until the port had First.
        "grouping_sets": (
            df.rollup("s").agg(M.agg_first(M.col("a")).alias("n")), {}),
        "multi_partition_window": (
            df.with_column("r", M.rank().over(
                M.Window.partition_by("s").order_by("a"))),
            {"spark.rapids.sql.shuffle.partitions": 4}),
    }


def _refusals(session):
    df = _scan_df(session)
    other = _scan_df(session).select(L.col("a").alias("b"),
                                     L.col("s").alias("t"))
    c = L.col
    md5 = L.Column(("md5", c("s")))
    return {
        # case -> (DataFrame, conf updates, [(node, reason), ...]); a
        # lifted case refuses nothing and runs.
        **_host_cases(L, session),
        **{k: (d, conf, []) for k, (d, conf) in
           _lifted_cases(L, session).items()},
        "unported_expression": (
            df.select(md5.alias("r"), "a").filter(c("a") > 1),
            {}, [("LogicalProject", "expression md5 is not ported")]),
        "unported_window_function": (
            df.with_column("x", L.Column(("agg", "first", c("a"), True))
                           .over(L.Window.partition_by("s"))), {},
            [("LogicalWindow", "window function agg first is not ported")]),
        "computed_join_key": (
            df.join_on(other, [c("a") + 1], ["b"]), {},
            [("LogicalJoin", "join keys that are not column references are "
              "not ported")]),
        # The disabled filter alone would run on the host; the unported
        # md5 refuses the plan, naming its node only.
        "two_nodes": (
            df.filter(c("a") > 1).select(md5.alias("m"), "s")
            .group_by("s").agg(L.agg_count(c("m"))),
            {"spark.rapids.sql.expression.gt": False},
            [("LogicalProject", "expression md5 is not ported")]),
    }


REFUSALS = sorted(_refusals(TpuSession(device="cpu")))
HOST_CASES = sorted(_host_cases(L, TpuSession(device="cpu")))


def _reference_rows(case, conf):
    """The reference's rows of a host case under ``conf``."""
    from spark_rapids_tpu.api import TpuSession as JSession
    jsession = JSession({**conf, **REF_OFF})
    return _host_cases(JL, jsession)[case][0].collect()


LIFTED = sorted(_lifted_cases(L, TpuSession(device="cpu")))


@pytest.mark.parametrize("case", REFUSALS)
def test_planner_refuses_naming_nodes_and_reasons(case):
    """Port reasons refuse, naming each refused node; the reference's
    reasons alone put the node on the host, whose rows equal the
    reference's; a plan whose refusal the exchange and the new joins
    lifted runs on the device and gives the reference's rows."""
    session = TpuSession(device="cpu")
    df, conf, expected = _refusals(session)[case]
    for k, v in conf.items():
        session.set(k, v)
    if case in LIFTED:
        from spark_rapids_tpu.api import TpuSession as JSession
        jdf, _ = _lifted_cases(JL, JSession({**conf, **REF_OFF}))[case]
        assert not df._physical().host_fallback_nodes()
        want = sorted(jdf.collect(), key=repr)
        assert want and sorted(df.collect(), key=repr) == want
        return
    if case in HOST_CASES:
        phys = df._physical()
        assert phys.host_fallback_nodes() == [n for n, _ in expected]
        for node, reason in expected:
            assert any(line.strip().startswith(f"!Exec <{node}>")
                       and reason in line
                       for line in phys.explain().splitlines())
        assert sorted(df.collect()) == sorted(_reference_rows(case, conf))
        return
    with pytest.raises(NotImplementedError) as err:
        df.collect()
    msg = str(err.value)
    assert msg.startswith("the port cannot plan this query")
    for node, reason in expected:
        assert any(line.strip().startswith(f"{node}:") and reason in line
                   for line in msg.splitlines()), (node, reason, msg)
    refused = {line.strip().split(":")[0] for line in msg.splitlines()[1:]}
    assert refused == {node for node, _ in expected}


def test_test_mode_asserts_as_the_reference_does():
    session = TpuSession({"spark.rapids.sql.test.enabled": True},
                         device="cpu")
    df = _scan_df(session).group_by("s").agg(L.agg_sum(L.col("f")))
    with pytest.raises(AssertionError, match=r"Query would execute on host: "
                       r"\['LogicalAggregate'\]"):
        df.collect()
    session.set("spark.rapids.sql.test.allowedNonTpu", "LogicalAggregate")
    from spark_rapids_tpu.api import TpuSession as JSession
    jsession = JSession({"spark.rapids.sql.test.enabled": True,
                         "spark.rapids.sql.test.allowedNonTpu":
                         "LogicalAggregate", **REF_OFF})
    want = _scan_df(jsession).group_by("s").agg(
        JL.agg_sum(JL.col("f"))).collect()
    assert df.collect() == want and len(want) == 3


# ---------------------------------------------------------------------------
# The shuffled join
# ---------------------------------------------------------------------------

def _join_execs(e, out):
    if isinstance(e, ShuffledHashJoinExec):
        out.append(e)
    for c in e.children:
        _join_execs(c, out)
    return out


def test_q4_shuffle_lowering_matches_reference(small_tables, monkeypatch):
    session, tables, jsession, jtables = small_tables
    raw = {VFA: True, "spark.rapids.sql.autoBroadcastJoinThreshold": 4096}
    pconf, jconf = _confs(raw)
    got = PL.Planner(pconf, device="cpu").plan(
        tpch.q4(session, tables["q4"])._plan)
    jdf = jax_query(monkeypatch, "q4", jsession, jtables["q4"])
    want = JPL.Planner(jconf).plan(jdf._plan)
    assert got.meta.explain_lines() == want.meta.explain_lines()
    assert "auto join strategy -> shuffle" in got.explain()
    (join,) = _join_execs(got.root, [])
    assert join.join_type == "semi" and type(join) is ShuffledHashJoinExec
    assert all(isinstance(c, ShuffleExchangeExec) for c in join.children)
    from spark_rapids_tpu.ops.join import ShuffledHashJoinExec as JSHJ

    def find(e):
        if isinstance(e, JSHJ):
            return e
        return next((f for f in map(find, e.children) if f), None)
    assert find(want.root) is not None
    want_rows = want.collect()
    assert got.collect() == want_rows
    assert [r[0] for r in want_rows] == sorted(r[0] for r in want_rows)


# ---------------------------------------------------------------------------
# The DataFrame API
# ---------------------------------------------------------------------------

def test_create_dataframe_forms_agree():
    schema = (("k", dt.INT32), ("v", dt.FLOAT64))
    session = TpuSession({VFA: True}, device="cpu")
    k = np.array([3, 1, 3, 2, 1, 3], np.int32)
    v = np.arange(6, dtype=np.float64) * 1.5
    forms = {
        "dict": session.create_dataframe(
            {"k": k.tolist(), "v": v.tolist()}, schema, num_partitions=2),
        "rows": session.create_dataframe(
            list(zip(k.tolist(), v.tolist())), schema, num_partitions=3),
        "numpy": session.create_dataframe({"k": k, "v": v}, schema,
                                          num_partitions=4)}
    want = [(1, 2, 7.5), (2, 1, 4.5), (3, 3, 10.5)]
    for name, df in forms.items():
        out = df.group_by("k").agg(L.agg_count().alias("n"),
                                   L.agg_sum(L.col("v")).alias("s")) \
            .order_by("k")
        assert out.collect() == want, name
        assert out.columns == ["k", "n", "s"]
        assert df.count_rows() == 6
    with pytest.raises(TypeError, match="fixed-width"):
        session.create_dataframe({"s": np.array(["a"])},
                                 (("s", dt.STRING),))


def test_dataframe_transformations():
    session = TpuSession(device="cpu")
    df = _scan_df(session, n=9)
    assert df.columns == ["a", "f", "s"]
    replaced = df.with_column("a", L.col("a") * 10)
    assert replaced.columns == ["a", "f", "s"]
    added = replaced.withColumn("b", L.col("a") + 1).where(L.col("b") > 30)
    assert added.schema[-1] == ("b", dt.INT64)
    rows = added.order_by(L.col("a").desc()).limit(2).collect()
    assert rows == [(80, 4.0, "z", 81), (70, 3.5, "y", 71)]
    counts = df.group_by("s").count().order_by("s").collect()
    assert counts == [("x", 3), ("y", 3), ("z", 3)]
    assert df.agg(L.agg_max(L.col("a"))).collect() == [(8,)]
    joined = df.join(df.select("a", L.col("s").alias("t")), "a")
    assert joined.count_rows() == 9
    assert df.filter(L.col("s").endswith("z")).count_rows() == 3


def test_conf_change_replans():
    session = TpuSession(device="cpu")
    df = _scan_df(session).filter(L.col("a") > 2)
    first = df._physical()
    assert df._physical() is first
    session.set("spark.rapids.sql.exec.LogicalFilter", False)
    assert df._physical().host_fallback_nodes() == ["LogicalFilter"]
    assert df.count_rows() == 3
    session.set("spark.rapids.sql.exec.LogicalFilter", True)
    assert df._physical() is not first
    assert df.count_rows() == 3


def test_explain_conf_prints_the_report(capsys):
    session = TpuSession({"spark.rapids.sql.explain": "all"}, device="cpu")
    _scan_df(session).filter(L.col("a") > 2).collect()
    out = capsys.readouterr().out
    assert "*Exec <LogicalFilter>" in out and "*Exec <InMemoryScan>" in out


def test_session_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TpuSession()
