"""Port parity of the UDF slice through the DataFrame front end: the
queries of ``benchmarks/udfsource.py`` ((a) TPC-H q1 written with
compiled UDFs, (b) ORDERS through two Python UDFs that do not compile,
grouped, (c) the four pandas-UDF flavors over ORDERS) at TPC-H scale
0.0035 (5,250 orders, 21,323 lines) against the JAX package's
``TpuSession``, under the all-device conf and the default conf.

- (a): every UDF compiles in both packages; the plan's exec tree is the
  reference's (q1's text's with the band's projection), its host nodes
  q1's text's, with no host roundtrip in the report; the rows
  equal the reference's (float sums to the harness's ``approx_float``,
  keys and counts exact) and q1's text's in the port, and ``sum_band``
  equals a numpy count.
- (b): neither UDF compiles, with the reference's errors; no host node
  under the all-device conf; rows equal the reference's and a Python
  oracle's (counts, max and the vowels exact, revenue within rtol 1e-9);
  ``island.pyudf.rows`` is twice the filtered rows.
- (c): each flavor at 1 and 4 partitions on the device half and the host
  half equals the reference's rows as a multiset, exactly (pandas
  computes every value).
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import numpy as np
import pytest

from spark_rapids_tpu.api import DataFrame as JDataFrame
from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu.udf import udf as judf

from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch.api import DataFrame, TpuSession
from spark_rapids_tpu_torch.benchmarks import stringsource as S
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.benchmarks import udfsource as U
from spark_rapids_tpu_torch.ops import ExecContext
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.udf import udf

from harness import assert_rows_equal
from test_torch_logical import jax_parts, jschema
from test_torch_placement import REF_OFF, _shape

SCALE = 0.0035
ALL_DEVICE = {"spark.rapids.sql.variableFloatAgg.enabled": True}
CONFS = {"device": ALL_DEVICE, "default": {}}
SCHEMAS = {"lineitem": E.Q1_SCHEMA, "orders": S.ORDERS}


@pytest.fixture(scope="module")
def cols():
    return E.tpch_columns(SCALE, seed=1)


def _tables(P, session, cols, n):
    out = {}
    for t, schema in SCHEMAS.items():
        parts = E.table_partitions({c: cols[t][c] for c, _ in schema},
                                   schema, n)
        if P == "port":
            out[t] = DataFrame(session, L.InMemoryScan(schema, parts))
        else:
            out[t] = JDataFrame(session, JL.InMemoryScan(
                jschema(schema), jax_parts(parts)))
    return out


def _pair(conf: dict, cols, n: int):
    """(port session, its tables, reference session, its tables)."""
    conf = dict(conf, **{"spark.rapids.sql.shuffle.partitions": n})
    ts = TpuSession(conf, device="cpu")
    js = JSession(dict(conf, **REF_OFF))
    return ts, _tables("port", ts, cols, n), js, _tables("jax", js, cols, n)


def _island_rows(ctx) -> int:
    return int(sum(m.values.get("island.pyudf.rows", 0)
                   for m in ctx.metrics.values()))


@pytest.mark.parametrize("conf", sorted(CONFS))
def test_q1_udf_matches_reference_and_q1(conf, cols):
    assert all(u.compiled for u in U.q1_udfs(udf).values())
    assert all(u.compiled for u in U.q1_udfs(judf).values())
    ts, tt, js, jt = _pair(CONFS[conf], cols, 1)
    q = U.q1_udf(L, udf, tt["lineitem"])
    jq = U.q1_udf(JL, judf, jt["lineitem"])
    text = tpch.q1(ts, tt)
    phys, tphys = q._physical(), text._physical()
    assert _shape(phys.root) == _shape(jq._physical().root)
    # q1's tree with the band's projection (``tree()`` names each fused
    # stage's members).
    assert phys.tree().count("ProjectExec") == \
        tphys.tree().count("ProjectExec") + 1
    assert phys.host_fallback_nodes() == tphys.host_fallback_nodes() == (
        ["LogicalAggregate"] if conf == "default" else [])
    assert "roundtrip" not in q.explain()
    want = jq.collect()
    rows = q.collect()
    assert_rows_equal(rows, want, approx_float=True, msg=conf)
    assert_rows_equal(q.collect_host(), want, approx_float=True, msg=conf)
    assert_rows_equal([r[:-1] for r in rows], text.collect(),
                      approx_float=True, msg=conf)
    li = cols["lineitem"]
    keep = li["l_shipdate"] <= U.Q1_CUTOFF
    flags = [bytes([c]).decode() for c in li["l_returnflag"][keep]]
    status = [bytes([c]).decode() for c in li["l_linestatus"][keep]]
    big = li["l_quantity"][keep] > 25.0
    band = {}
    for f, s, b in zip(flags, status, big):
        band[(f, s)] = band.get((f, s), 0) + int(b)
    assert {(r[0], r[1]): r[-1] for r in rows} == band


@pytest.mark.parametrize("conf", sorted(CONFS))
def test_order_ranks_matches_reference_and_python(conf, cols):
    tu, ju = U.rank_udfs(udf), U.rank_udfs(judf)
    for k in tu:
        assert not tu[k].compiled
        assert tu[k].compile_error == ju[k].compile_error
    assert "captured variable 'PRIORITY_RANK'" in tu["rank"].compile_error
    ts, tt, js, jt = _pair(CONFS[conf], cols, 1)
    q = U.order_ranks(L, udf, tt["orders"])
    phys = q._physical()
    assert phys.host_fallback_nodes() == (
        ["LogicalAggregate"] if conf == "default" else [])
    report = q.explain()
    for name, u in (("<lambda>", tu["rank"]), ("vowels", tu["vowels"])):
        assert (f"python UDF {name!r} could not be compiled to native "
                f"expressions ({u.compile_error})") in report
    want = U.order_ranks(JL, judf, jt["orders"]).collect()
    ctx = ExecContext(phys.conf)
    rows = phys.collect(ctx)
    assert_rows_equal(rows, want, approx_float=True, msg=conf)
    assert_rows_equal(q.collect_host(), want, approx_float=True, msg=conf)
    o = cols["orders"]
    keep = o["o_orderdate"] < U.RANK_CUTOFF
    assert _island_rows(ctx) == 2 * int(keep.sum())
    rank = np.array([U.PRIORITY_RANK[p] for p in E.PRIORITIES])[
        o["o_orderpriority"][keep]]
    vowels = np.array([U.vowels(c) for c in E.O_COMMENTS])[
        o["o_comment"][keep]]
    price = o["o_totalprice"][keep]
    oracle = [(int(r), int((rank == r).sum()), float(price[rank == r].sum()),
               float(price[rank == r].max()), int(vowels[rank == r].sum()))
              for r in np.unique(rank)]
    assert [(r[0], r[1], r[3], r[4]) for r in rows] == \
        [(r[0], r[1], r[3], r[4]) for r in oracle]
    np.testing.assert_allclose([r[2] for r in rows], [r[2] for r in oracle],
                               rtol=1e-9, atol=0)


PANDAS = {
    "map": lambda M, s, t: U.pandas_map(M, t["orders"]),
    "apply": lambda M, s, t: U.pandas_apply(M, t["orders"]),
    "agg": lambda M, s, t: U.pandas_agg(M, t["orders"]),
    "cogroup": lambda M, s, t: U.pandas_cogroup(
        M, t["orders"], U.weights(s, M)),
}


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("flavor", sorted(PANDAS))
def test_pandas_flavor_matches_reference(flavor, n, cols):
    ts, tt, js, jt = _pair(ALL_DEVICE, cols, n)
    want = sorted(PANDAS[flavor](JL, js, jt).collect())
    q = PANDAS[flavor](L, ts, tt)
    assert q._physical().host_fallback_nodes() == []
    assert len(want) == {"map": len(cols["orders"]["o_orderkey"]),
                         "apply": 5, "agg": 3, "cogroup": 6}[flavor]
    assert sorted(q.collect()) == want
    assert sorted(q.collect_host()) == want
