"""Port parity of the logical layer: spark_rapids_tpu_torch.plan.logical
and plan.pruning against the JAX package's, on the CPU.

- ``resolve`` of the same Column ASTs gives the same expression classes,
  ordinals, literals and result types; the same inputs raise the same
  ``ResolutionError``s; a kind the port has no expression for raises a
  ``ResolutionError`` naming it, where the reference resolves it.
- ``prune_columns`` gives the same trees and ``estimate_bytes`` the same
  byte counts on the same in-memory plans (TPC-H q1-q6 built by each
  package's query text over the same tables, and hand-made plans over
  python-value batches).

The helpers here (``jax_parts``, ``jax_tables``, ``jax_query``) are shared
with tests/test_torch_planner.py and tests/test_torch_tpch_df.py.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import numpy as np
import pytest

from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.api.dataframe import DataFrame as JDataFrame
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu.plan import pruning as JP

from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan import pruning as P

QUERIES = ("q1", "q6", "q3", "q5", "q2", "q4")


# ---------------------------------------------------------------------------
# Shared helpers: the same tables and plans in both packages
# ---------------------------------------------------------------------------

def jschema(schema):
    return tuple((n, jdt.type_named(t.name)) for n, t in schema)


def jax_parts(parts):
    """The port's host-batch partitions as the JAX package's (same
    arrays, string matrices kept as matrices)."""
    out = []
    for p in parts:
        batches = []
        for hb in p:
            cols = []
            for c in hb.columns:
                t = jdt.type_named(c.dtype.name)
                if t.is_string and c.str_matrix is not None:
                    cols.append(jhost.HostColumn(
                        t, None, c.validity, str_matrix=c.str_matrix,
                        str_lengths=c.str_lengths))
                else:
                    cols.append(jhost.HostColumn(t, c.data, c.validity))
            batches.append(jhost.HostBatch(hb.names, cols))
        out.append(batches)
    return out


def jax_tables(jsession, tables: dict) -> dict:
    """query -> table -> JAX-package DataFrame over the same partitions
    as the port's ``tpch_tables`` output."""
    return {q: {t: JDataFrame(jsession, JL.InMemoryScan(
        jschema(df.schema), jax_parts(df._plan.partitions)))
        for t, df in ts.items()} for q, ts in tables.items()}


def jax_query(monkeypatch, q: str, jsession, jtables: dict):
    """The JAX package's ``tpch.<q>`` over in-memory tables (its ``_read``
    looks the table up instead of reading parquet)."""
    monkeypatch.setattr(jtpch, "_read", lambda s, tables, t: tables[t])
    return jtpch.QUERIES[q](jsession, jtables)


@pytest.fixture(scope="module")
def small_tables():
    """(port session, port tables, JAX session, JAX tables) at scale
    0.003."""
    session = TpuSession({"spark.rapids.sql.variableFloatAgg.enabled": True},
                         device="cpu")
    tables = tpch.tpch_tables(session, E.tpch_columns(0.003, seed=2))
    jsession = JSession({"spark.rapids.sql.variableFloatAgg.enabled": True,
                         "spark.rapids.sql.cost.enabled": False})
    return session, tables, jsession, jax_tables(jsession, tables)


# ---------------------------------------------------------------------------
# resolve
# ---------------------------------------------------------------------------

SCHEMA = (("i32", dt.INT32), ("i64", dt.INT64), ("f64", dt.FLOAT64),
          ("d", dt.DATE), ("d2", dt.DATE), ("s", dt.STRING),
          ("b", dt.BOOL))

# Column ASTs over SCHEMA, each built by a function of the DSL module.
ASTS = {
    "ref": lambda M: M.col("f64"),
    "lit_int": lambda M: M.lit_col(5),
    "lit_long": lambda M: M.lit_col(2 ** 40),
    "lit_float": lambda M: M.lit_col(1.5),
    "lit_str": lambda M: M.lit_col("BUILDING"),
    "lit_bool": lambda M: M.lit_col(True),
    "alias": lambda M: M.col("i64").alias("k"),
    "add": lambda M: M.col("i32") + 1,
    "radd": lambda M: 2 + M.col("i64"),
    "rsub": lambda M: 1.0 - M.col("f64"),
    "mul_mixed": lambda M: M.col("i64") * M.col("f64"),
    "charge": lambda M: M.col("f64") * (1.0 - M.col("f64"))
    * (1.0 + M.col("f64")),
    "eq": lambda M: M.col("i32") == 5,
    "ne": lambda M: M.col("i64") != 7,
    "lt_float": lambda M: M.col("f64") < 24.0,
    "le_date": lambda M: M.col("d") <= M.lit_col(10_470),
    "ge_dates": lambda M: M.col("d") >= M.col("d2"),
    "gt": lambda M: M.col("i64") > M.col("i32"),
    "str_eq": lambda M: M.col("s") == M.lit_col("ASIA"),
    "and_or_not": lambda M: ((M.col("i32") > 1) & (M.col("f64") < 2.0))
    | ~(M.col("b")),
    "isnull": lambda M: M.col("s").isNull(),
    "isnotnull": lambda M: M.col("f64").isNotNull(),
    "startswith": lambda M: M.col("s").startswith("PROMO"),
    "endswith": lambda M: M.col("s").endswith("BRASS"),
    "contains": lambda M: M.col("s").contains("green"),
    "q6_filter": lambda M: (M.col("d") >= M.lit_col(8766))
    & (M.col("d") < M.lit_col(9131)) & (M.col("f64") >= 0.05)
    & (M.col("f64") <= 0.07) & (M.col("f64") < 24.0),
    "div": lambda M: M.col("f64") / 2.0,
    "isin": lambda M: M.col("s").isin("MAIL", "SHIP"),
    "when": lambda M: M.when(M.col("b"), 1).otherwise(0),
    "coalesce": lambda M: M.coalesce_cols(M.col("f64"), 0.0),
    "year": lambda M: M.year(M.col("d")),
    "month": lambda M: M.month(M.col("d")),
    "dayofmonth": lambda M: M.dayofmonth(M.col("d")),
    "like": lambda M: ~M.col("s").like("%special%requests%"),
    "mod": lambda M: M.col("i64") % 3,
    "pmod": lambda M: M.pmod(M.col("i32"), 7),
    "cast": lambda M: M.col("i32").cast("long"),
    "cast_double": lambda M: M.col("i32").cast("double") > M.col("f64"),
    "substr": lambda M: M.col("s").substr(1, 2),
    "hash": lambda M: M.murmur3_hash(M.col("i64"), M.col("s")),
    # The numeric, date-time and task-context kinds.
    "neg": lambda M: -M.col("i32"),
    "abs": lambda M: M.Column(("abs", M.col("f64"))),
    **{k: (lambda M, k=k: M.Column((k, M.col("f64")))) for k in (
        "sqrt", "isnan", "floor", "ceil", "exp", "log", "log10", "log2",
        "log1p", "expm1", "cbrt", "sin", "cos", "tan", "asin", "acos",
        "atan", "sinh", "cosh", "tanh", "asinh", "acosh", "atanh",
        "degrees", "radians", "rint", "signum")},
    **{k: (lambda M, k=k: M.Column((k, M.col("d")))) for k in (
        "quarter", "dayofweek", "weekday", "dayofyear", "last_day",
        "hour", "minute", "second", "to_unix_timestamp")},
    "from_unixtime": lambda M: M.from_unixtime(M.col("i64")),
    "nanvl": lambda M: M.nanvl(M.col("f64"), 0.0),
    "pow": lambda M: M.pow_col(M.col("f64"), 2),
    "logb": lambda M: M.logb(2.0, M.col("f64")),
    "date_add": lambda M: M.date_add(M.col("d"), 30),
    "date_sub": lambda M: M.date_sub(M.col("d"), M.col("i32")),
    "datediff": lambda M: M.datediff(M.col("d"), M.col("d2")),
    "add_months": lambda M: M.add_months(M.col("d"), -1),
    "round": lambda M: M.round_col(M.col("f64"), 2),
    "bround": lambda M: M.bround_col(M.col("i64"), -2),
    "least": lambda M: M.least(M.col("i32"), M.col("i64")),
    "greatest": lambda M: M.greatest(M.col("f64"), 1.5),
    "at_least_n_non_nulls": lambda M: M.at_least_n_non_nulls(
        1, M.col("f64"), M.col("s")),
    "trunc": lambda M: M.trunc(M.col("d"), "year"),
    "rand": lambda M: M.rand(3),
    "spark_partition_id": lambda M: M.spark_partition_id(),
    "monotonically_increasing_id": lambda M: M.monotonically_increasing_id(),
    "input_file_name": lambda M: M.input_file_name(),
}


def _same_expr(j, p, path="root"):
    assert type(p).__name__ == type(j).__name__, path
    assert p.data_type().name == j.data_type().name, path
    if isinstance(j, JE.BoundReference):
        assert (p.ordinal, p.name) == (j.ordinal, j.name), path
    if isinstance(j, JE.Literal):
        assert type(p.value) is type(j.value) and p.value == j.value, path
    jc, pc = tuple(j.children), tuple(p.children)
    assert len(pc) == len(jc), path
    for i, (a, b) in enumerate(zip(jc, pc)):
        _same_expr(a, b, f"{path}.{i}")


@pytest.mark.parametrize("name", sorted(ASTS))
def test_resolve_matches_reference(name):
    want = JL.resolve(ASTS[name](JL), jschema(SCHEMA))
    got = L.resolve(ASTS[name](L), SCHEMA)
    _same_expr(want, got)


ERRORS = {
    "missing_column": lambda M: M.col("nope"),
    "untyped_null": lambda M: M.lit_col(None),
    "string_vs_int": lambda M: M.col("s") == 5,
    "int_vs_string": lambda M: M.col("i32") < M.lit_col("x"),
    "sort_order": lambda M: M.col("i32").desc(),
    "nested_missing": lambda M: (M.col("i32") + M.col("zz")) > 1,
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_resolution_errors_match_reference(name):
    with pytest.raises(JL.ResolutionError) as want:
        JL.resolve(ERRORS[name](JL), jschema(SCHEMA))
    with pytest.raises(L.ResolutionError) as got:
        L.resolve(ERRORS[name](L), SCHEMA)
    assert str(got.value) == str(want.value)


# kind -> (AST, what the port's refusal names): a cast to a string is
# refused, a fixed-width one resolves (ASTS). ``abs`` and ``neg`` were
# refused until the port had their classes; the string functions still
# are.
UNPORTED = {
    "upper": (lambda M: M.Column(("upper", M.col("s"))),
              "expression upper is not ported"),
    "md5": (lambda M: M.Column(("md5", M.col("s"))),
            "expression md5 is not ported"),
    "cast": (lambda M: M.col("i32").cast("string"),
             "cast to string is not ported"),
}


@pytest.mark.parametrize("kind", sorted(UNPORTED))
def test_unported_kinds_raise_naming_the_kind(kind):
    # The reference resolves them; the port names what it lacks.
    build, why = UNPORTED[kind]
    JL.resolve(build(JL), jschema(SCHEMA))
    with pytest.raises(L.ResolutionError, match=why):
        L.resolve(build(L), SCHEMA)


def test_ported_kinds_are_the_resolvable_ones():
    # Every AST above resolves through PORTED_KINDS alone.
    def kinds(c, out):
        out.add(c.node[0])
        for x in c.node[1:]:
            if isinstance(x, L.Column):
                kinds(x, out)
        return out
    used = set()
    for build in ASTS.values():
        kinds(build(L), used)
    assert used == set(L.PORTED_KINDS)


# ---------------------------------------------------------------------------
# prune_columns and estimate_bytes
# ---------------------------------------------------------------------------

def _shape(plan):
    """A logical tree as nested tuples of (node, its own fields)."""
    own = ()
    if hasattr(plan, "projections"):
        own = tuple(n for n, _ in plan.projections)
    elif hasattr(plan, "group_by"):
        own = (tuple(n for n, _ in plan.group_by),
               tuple(n for n, _ in plan.aggregates))
    elif hasattr(plan, "join_type"):
        own = (plan.join_type, plan.strategy)
    elif hasattr(plan, "n"):
        own = (plan.n,)
    return (plan.name, own, tuple(n for n, _ in plan.schema),
            tuple(_shape(c) for c in plan.children))


def _estimates(plan, out):
    out.append((plan.name, plan))
    for c in plan.children:
        _estimates(c, out)
    return out


@pytest.mark.parametrize("q", QUERIES)
def test_pruning_and_estimates_match_reference_on_tpch(q, small_tables,
                                                       monkeypatch):
    session, tables, jsession, jtables = small_tables
    got = P.pushdown_filters(P.prune_columns(
        tpch.QUERIES[q](session, tables[q])._plan))
    want = JP.pushdown_filters(JP.prune_columns(
        jax_query(monkeypatch, q, jsession, jtables[q])._plan))
    assert _shape(got) == _shape(want)
    pg, pw = _estimates(got, []), _estimates(want, [])
    assert [n for n, _ in pg] == [n for n, _ in pw]
    for (name, g), (_, w) in zip(pg, pw):
        assert P.estimate_bytes(g) == JP.estimate_bytes(w), name
    assert P.estimate_bytes(got) > 0


def _pydict_plans(M, scan):
    """Hand-made plans over one scan: projections dropped or kept by
    pruning, a join of the scan with itself, a sort and a limit."""
    c = M.col
    proj = M.LogicalProject(scan, [("a", c("a")), ("s", c("s")),
                                   ("x", c("a") * 2)])
    filt = M.LogicalFilter(proj, c("x") > 4)
    agg = M.LogicalAggregate(filt, [("s", c("s"))],
                             [("n", M.agg_count()),
                              ("m", M.agg_max(c("a")))])
    join = M.LogicalJoin(scan, M.LogicalProject(scan, [("b", c("a")),
                                                       ("t", c("s"))]),
                         [c("a")], [c("b")], "left")
    top = M.LogicalLimit(M.LogicalSort(join, [c("a").desc()]), 3)
    semi = M.LogicalJoin(agg, scan, [c("s")], [c("s")], "semi")
    return {"agg": agg, "top": top, "semi": semi}


@pytest.mark.parametrize("which", ["agg", "top", "semi"])
def test_pruning_and_estimates_match_reference_on_python_values(which):
    schema = (("a", dt.INT32), ("s", dt.STRING), ("f", dt.FLOAT64))
    data = {"a": [1, None, 3, 4, 5], "s": ["x", "yy", None, "", "zzzz"],
            "f": [0.5, 1.5, None, 2.5, -0.0]}
    parts = [[HostBatch.from_pydict(schema, data)],
             [HostBatch.from_pydict(schema, {k: v[:2]
                                             for k, v in data.items()})]]
    jparts = [[jhost.HostBatch.from_pydict(jschema(schema), data)],
              [jhost.HostBatch.from_pydict(jschema(schema),
                                           {k: v[:2] for k, v in
                                            data.items()})]]
    got = _pydict_plans(L, L.InMemoryScan(schema, parts))[which]
    want = _pydict_plans(JL, JL.InMemoryScan(jschema(schema), jparts))[which]
    assert _shape(P.prune_columns(got)) == _shape(JP.prune_columns(want))
    for (name, g), (_, w) in zip(_estimates(P.prune_columns(got), []),
                                 _estimates(JP.prune_columns(want), [])):
        assert P.estimate_bytes(g) == JP.estimate_bytes(w), name
    # 7 rows: a (8 B) and f (8 B) a row, s its bytes plus 4 a row.
    assert P.estimate_bytes(L.InMemoryScan(schema, parts)) == \
        7 * 8 * 2 + (1 + 2 + 0 + 0 + 4 + 1 + 2) + 4 * 7


def test_in_memory_estimate_counts_matrix_strings():
    # The str_matrix form (tpch_columns' pools) counts lengths, not width.
    cols = E.tpch_columns(0.001, seed=0)
    parts = E.table_partitions(cols["orders"], E.Q4_ORDERS, 2)
    lens = np.concatenate([hb.columns[2].str_lengths for p in parts
                           for hb in p])
    n = len(lens)
    assert P.estimate_bytes(L.InMemoryScan(E.Q4_ORDERS, parts)) == \
        8 * n + 8 * n + int(lens.sum()) + 4 * n
