"""Port parity of the string slice through the DataFrame front end: the
queries of ``benchmarks/stringsource.py`` ((a) ORDERS string ETL and its
grouping, (b) CUSTOMER and PART through the host-roundtrip kinds and the
join on a key parsed from a string, (c) explode / posexplode /
explode_outer over LINEITEM) at TPC-H scale 0.0035 (5,250 orders,
21,323 lines) under the all-device conf and the default conf, at 1 and 4
partitions, against the JAX package's ``TpuSession``: the same placement
and exec tree, the same rows on the device and on the host engine
(strings, integers, dates and the parsed prices exact; revenue sums
within rtol 1e-9).

Also: every new DSL function resolves to the reference's expression
tree; the default conf tags upper / lower / initcap and the float <->
string casts with the reference's reasons, and the six roundtrip kinds
carry its note; chip_smoke.py's phase-20 oracles agree with the port's
rows.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import os
import sys

import pytest

from spark_rapids_tpu.api import DataFrame as JDataFrame
from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.plan import logical as JL

from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch.api import DataFrame, TpuSession
from spark_rapids_tpu_torch.benchmarks import stringsource as S
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.plan import logical as L

from test_torch_logical import jax_parts, jschema
from test_torch_placement import REF_OFF, _shape
from test_torch_rowsource import assert_rows_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.0035
CONFS = {"device": S.ALL_DEVICE, "default": {}}
BATCH = {"spark.rapids.sql.batchSizeRows": 8192}


@pytest.fixture(scope="module")
def cols():
    return E.tpch_columns(SCALE, seed=1)


def _tables(P, session, cols, n):
    out = {}
    for t, schema in S.SCHEMAS.items():
        parts = E.table_partitions({c: cols[t][c] for c, _ in schema},
                                   schema, n)
        if P == "port":
            out[t] = DataFrame(session, L.InMemoryScan(schema, parts))
        else:
            out[t] = JDataFrame(session, JL.InMemoryScan(
                jschema(schema), jax_parts(parts)))
    return out


QUERIES = {
    "etl": lambda M, t: S.orders_etl(M, t["orders"]),
    "etl_head": lambda M, t: S.etl_head(M, t["orders"], 1000),
    "groups": lambda M, t: S.comment_groups(M, t["orders"]),
    "customer_keys": lambda M, t: S.customer_keys(M, t["customer"]),
    "part_labels": lambda M, t: S.part_labels(M, t["part"]),
    "country_revenue": lambda M, t: S.country_revenue(M, t["orders"],
                                                      t["customer"]),
    "date_positions": lambda M, t: S.date_positions(M, t["lineitem"]),
    "ship_labels": lambda M, t: S.ship_labels(M, t["lineitem"]),
    "outer_labels": lambda M, t: S.outer_labels(M, t["lineitem"]),
}
# The queries without ORDER BY compare as multisets.
UNORDERED = {"etl", "customer_keys", "part_labels"}
# The logical nodes the default conf places on the host engine.
DEFAULT_HOST = {"etl": ["LogicalProject", "LogicalProject"],
                "etl_head": ["LogicalProject", "LogicalProject"],
                "country_revenue": ["LogicalAggregate"]}


@pytest.fixture(scope="module")
def frames(cols):
    """(query, conf, partitions) -> (port DataFrame, reference DataFrame,
    reference rows of collect, of collect_host), built on first use."""
    out = {}

    def get(q, conf, n):
        key = (q, conf, n)
        if key not in out:
            pconf = dict(CONFS[conf], **BATCH)
            t = TpuSession(pconf, device="cpu")
            j = JSession(dict(pconf, **REF_OFF, **{
                "spark.rapids.sql.shuffle.partitions": 1}))
            jdf = QUERIES[q](JL, _tables("jax", j, cols, n))
            out[key] = (QUERIES[q](L, _tables("port", t, cols, n)), jdf,
                        jdf.collect(), jdf.collect_host())
        return out[key]
    return get


def _ordered(q, rows):
    return sorted(rows, key=repr) if q in UNORDERED else rows


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("conf", sorted(CONFS))
@pytest.mark.parametrize("q", sorted(QUERIES))
def test_query_matches_reference(q, conf, n, frames):
    tdf, jdf, want, want_host = frames(q, conf, n)
    tphys, jphys = tdf._physical(), jdf._physical()
    assert tphys.host_fallback_nodes() == jphys.host_fallback_nodes()
    assert tphys.host_fallback_nodes() == (
        DEFAULT_HOST.get(q, []) if conf == "default" else [])
    assert _shape(tphys.root) == _shape(jphys.root)
    assert want, f"{q}: nothing compared"
    # Revenue sums through a join, in another order than the reference's:
    # rtol 1e-9 (the TPC-H tests' tolerance); every other float exact.
    rtol = 1e-9 if q == "country_revenue" else 0.0
    assert_rows_close(_ordered(q, tdf.collect()), _ordered(q, want), rtol)
    assert_rows_close(_ordered(q, tdf.collect_host()),
                      _ordered(q, want_host), rtol)


def test_queries_are_not_vacuous(frames):
    """concat_ws has NULL first arguments, the round trips give the
    values back, the outer explode has its NULL group, the join matches
    every order, the host islands counted their rows."""
    tdf, _j, _w, _h = frames("etl", "device", 1)
    rows = tdf.collect()
    names = list(S.ETL_COLUMNS)
    dashed = [r[names.index("dashed")] for r in rows]
    assert any(d.count("-") == 2 for d in dashed)     # status skipped
    assert any(d.count("-") >= 3 for d in dashed)
    key = names.index("o_orderkey")
    assert all(r[names.index("key_back")] == r[key] for r in rows)
    tdf, _j, _w, _h = frames("outer_labels", "device", 1)
    assert tdf.collect()[0][0] is None
    tdf, _j, want, _h = frames("country_revenue", "default", 4)
    assert sum(r[1] for r in want) == 5250
    from spark_rapids_tpu_torch.ops.base import ExecContext
    tdf, _j, _w, _h = frames("customer_keys", "device", 1)
    phys = tdf._physical()
    ctx = ExecContext(phys.conf)
    n = len(phys.collect(ctx))
    counts = {k: v for m in ctx.metrics.values() for k, v in m.values.items()
              if k.endswith(".rows") and k.startswith("island.")}
    assert counts == {f"island.{k}.rows": (2 if k == "lpad" else 1) * n
                      for k in ("regexp_replace", "regexp_extract",
                                "replace", "lpad", "cast")}


def test_default_conf_reasons_and_notes(cols):
    t = _tables("port", TpuSession(device="cpu"), cols, 1)
    text = S.orders_etl(L, t["orders"])._physical().explain()
    assert "expression upper is incompatible (locale-sensitive case " \
        "mapping is ASCII-only on TPU)" in text
    assert "expression initcap is incompatible" in text
    assert "casting floats to string formats differently from Spark" in text
    assert "casting strings to float differs in corner cases" in text
    text = S.customer_keys(L, t["customer"])._physical().explain()
    for k in ("regexp_replace", "regexp_extract", "replace", "lpad"):
        assert f"expression {k} runs via a host roundtrip" in text
    text = S.part_labels(L, t["part"])._physical().explain()
    for k in ("translate", "rpad"):
        assert f"expression {k} runs via a host roundtrip" in text
    assert "is not ported" not in text


SSCHEMA = (("s", "string"), ("t", "string"), ("i", "int32"),
           ("x", "float64"), ("d", "date"))


def _dsl():
    c = {
        "upper": lambda M: M.upper(M.col("s")),
        "lower": lambda M: M.lower(M.col("s")),
        "length": lambda M: M.length(M.col("s")),
        "concat": lambda M: M.concat(M.col("s"), "-", M.col("t")),
        "md5": lambda M: M.md5(M.col("s")),
        "concat_ws": lambda M: M.concat_ws(",", M.col("s"), M.col("t")),
        "regexp_extract": lambda M: M.regexp_extract(M.col("s"), r"(\d+)",
                                                     1),
        "translate": lambda M: M.translate(M.col("s"), "ab", "A"),
        "split": lambda M: M.split(M.col("s"), ",", 2),
        "substring_index": lambda M: M.substring_index(M.col("s"), ".",
                                                       -2),
        "repeat": lambda M: M.repeat(M.col("s"), 3),
        "reverse": lambda M: M.reverse(M.col("s")),
        "initcap": lambda M: M.initcap(M.col("s")),
        "lpad": lambda M: M.lpad(M.col("s"), 7, "*"),
        "rpad": lambda M: M.rpad(M.col("s"), 4),
        "trim": lambda M: M.trim(M.col("s")),
        "ltrim": lambda M: M.ltrim(M.col("s")),
        "rtrim": lambda M: M.rtrim(M.col("s")),
        "locate": lambda M: M.locate("ab", M.col("s"), 3),
        "instr": lambda M: M.instr(M.col("s"), "é"),
        "replace": lambda M: M.replace_str(M.col("s"), "a", "bb"),
        "rlike_replace": lambda M: M.col("s").rlike_replace("[0-9]", "#"),
        "cast_to_string": lambda M: M.col("x").cast("string"),
        "cast_from_string": lambda M: M.col("s").cast("date"),
    }
    return c


DSL = _dsl()


@pytest.mark.parametrize("name", sorted(DSL))
def test_dsl_resolves_as_reference(name):
    from test_torch_rowsource import _same_expr
    want = JL.resolve(DSL[name](JL), tuple(
        (n, jdt.type_named(t)) for n, t in SSCHEMA))
    got = L.resolve(DSL[name](L), tuple(
        (n, tdt.type_named(t)) for n, t in SSCHEMA))
    _same_expr(want, got)
    for attr in ("delim", "index", "count", "n", "sep", "search",
                 "replace", "length", "pad", "left", "idx", "to"):
        if hasattr(want, attr):
            w, g = getattr(want, attr), getattr(got, attr)
            if hasattr(w, "name"):      # a DataType of either package
                w, g = w.name, g.name
            assert g == w, attr
    assert DSL[name](L).node[0] in L.PORTED_KINDS


@pytest.mark.parametrize("fn", ["explode", "explode_outer", "posexplode"])
def test_generate_dsl_matches_reference(fn):
    j = getattr(JL, fn)(JL.col("a"), JL.col("b"))
    t = getattr(L, fn)(L.col("a"), L.col("b"))
    assert t.node[0] == j.node[0] == "explode"
    assert t.node[2:] == j.node[2:]
    assert L.is_generate_column(t.alias("v"))
    assert not L.is_generate_column(L.col("a"))


def test_chip_smoke_oracles_agree(cols):
    """The oracles chip_smoke.py holds phase 20 to give the port's rows
    at this scale (all-device conf, the generator's partitions)."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as C
    finally:
        sys.path.remove(ROOT)
    s = TpuSession(dict(S.ALL_DEVICE, **BATCH), device="cpu")
    t = S.tables(s, cols)
    n = len(cols["orders"]["o_orderkey"])
    C.check_etl(S.etl_head(L, t["orders"], n)._physical().collect_batches(),
                cols, n)
    C.check_rows("groups", S.comment_groups(L, t["orders"]).collect(),
                 C.comment_groups_oracle(cols), exact=True)
    C.check_rows("country_revenue", S.country_revenue(
        L, t["orders"], t["customer"]).collect(), C.revenue_oracle(cols))
    C.check_customer_keys(S.customer_keys(L, t["customer"])
                          ._physical().collect_batches(), cols)
    C.check_part_labels(S.part_labels(L, t["part"])
                        ._physical().collect_batches(), cols)
    li = cols["lineitem"]
    C.check_rows("date_positions", S.date_positions(L, t["lineitem"])
                 .collect(), C.positions_oracle(li), exact=True)
    C.check_rows("ship_labels", S.ship_labels(L, t["lineitem"]).collect(),
                 C.labels_oracle(li), exact=True)
    C.check_rows("outer_labels", S.outer_labels(L, t["lineitem"])
                 .collect(), C.outer_oracle(li), exact=True)
