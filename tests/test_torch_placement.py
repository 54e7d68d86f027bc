"""Port parity of the mixed device/host plans: spark_rapids_tpu_torch's
planner places and bridges the nodes the reference places on the host,
and the queries return the reference's rows, on the CPU.

- TPC-H q1-q6 over the ``small_tables`` in-memory partitions
  (tests/test_torch_logical.py) under the default conf (float Sum/Avg
  tagged for the host), ``spark.rapids.sql.enabled=false``,
  ``spark.rapids.sql.exec.LogicalJoin=false`` and
  ``spark.rapids.sql.expression.mul=false``:
  - ``host_fallback_nodes()``, the root's engine and the converted tree
    with its transitions (exchanges and shuffled joins included) equal
    the reference's;
  - the rows equal the reference's (its host engine's, the CPU oracle its
    own tests use): floats within ``approx_float``, everything else
    exact; q1's and q6's mixed plans also equal the reference's mixed
    plans' rows.
- ``collect_host()`` of q1-q6 equals the reference's bit for bit, float
  columns included.
- The placement the default conf gives: the Aggregate pair on the host
  in q1, q3, q5 and q6, bridged as the reference bridges; nothing on the
  host in q2 and q4, whose plans never reach a host half.
- No silent fallback: a device exec that raises makes ``collect`` raise,
  and no host half runs.

The reference plans with its cost placement, stage pipeline and stage
fusion off (none is ported). Its pipeline would also prematerialize a
host-side exchange on the device in a mixed plan, which its
``DeviceToHostExec`` refuses.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import math
import struct

import pytest

from spark_rapids_tpu import config as JC
from spark_rapids_tpu.plan import planner as JPL

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import ops as TO
from spark_rapids_tpu_torch.api import DataFrame, TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.plan import planner as PL

from harness import assert_rows_equal
from test_torch_logical import (  # noqa: F401  (small_tables: a fixture)
    QUERIES, jax_query, small_tables)

# Reference layers the port has not ported, off for the comparison.
REF_OFF = {"spark.rapids.sql.cost.enabled": False,
           "spark.rapids.sql.pipeline.enabled": False,
           "spark.rapids.sql.stageFusion.enabled": False}

CONFS = {
    "default": {},
    "sql_disabled": {"spark.rapids.sql.enabled": False},
    "join_disabled": {"spark.rapids.sql.exec.LogicalJoin": False},
    "mul_disabled": {"spark.rapids.sql.expression.mul": False},
}

def _plans(q, raw, small_tables, monkeypatch):
    """(port PhysicalPlan, reference PhysicalPlan, port DataFrame) of
    query ``q`` under the raw conf."""
    session, tables, jsession, jtables = small_tables
    df = DataFrame(TpuSession(raw, device="cpu"),
                   tpch.QUERIES[q](session, tables[q])._plan)
    jplan = jax_query(monkeypatch, q, jsession, jtables[q])._plan
    want = JPL.Planner(JC.TpuConf({**raw, **REF_OFF})).plan(jplan)
    return df._physical(), want, df


def _shape(e):
    """The exec tree as nested (name, children) tuples."""
    return (type(e).__name__, tuple(_shape(c) for c in e.children))


def _transitions(shape, parent=None, out=None):
    """(transition, parent, child) of every bridge in a shape."""
    out = [] if out is None else out
    name, kids = shape
    if name in ("DeviceToHostExec", "HostToDeviceExec"):
        out.append((name, parent, kids[0][0]))
    for k in kids:
        _transitions(k, name, out)
    return out


def _identical(a, b) -> bool:
    """Same value, floats bit for bit (NaN payload and zero sign)."""
    if isinstance(a, float) and isinstance(b, float):
        return struct.pack("<d", a) == struct.pack("<d", b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("q", QUERIES)
@pytest.mark.parametrize("conf", sorted(CONFS))
def test_placement_matches_reference(q, conf, small_tables, monkeypatch):
    got, want, _ = _plans(q, CONFS[conf], small_tables, monkeypatch)
    assert got.host_fallback_nodes() == want.host_fallback_nodes()
    assert got.root_on_device == want.root_on_device
    assert got.meta.explain_lines() == want.meta.explain_lines()
    shape = _shape(got.root)
    assert shape == _shape(want.root)
    if conf == "sql_disabled":
        assert not _transitions(shape) and not got.root_on_device
    if conf == "join_disabled" and q not in ("q1", "q6"):
        assert _transitions(shape)


_ORACLE = {}


def _reference_rows(q, small_tables, monkeypatch):
    """The reference's rows of ``q``: its host engine's ``collect_host``
    (its CPU oracle), once per query."""
    if q not in _ORACLE:
        _ORACLE[q] = _ref_df(q, small_tables, monkeypatch).collect_host()
    return _ORACLE[q]


def _ref_df(q, small_tables, monkeypatch):
    from spark_rapids_tpu.api import TpuSession as JSession
    from spark_rapids_tpu.api.dataframe import DataFrame as JDataFrame
    _s, _t, jsession, jtables = small_tables
    return JDataFrame(JSession(REF_OFF), jax_query(
        monkeypatch, q, jsession, jtables[q])._plan)


@pytest.mark.parametrize("q", QUERIES)
@pytest.mark.parametrize("conf", sorted(CONFS))
def test_rows_match_reference(q, conf, small_tables, monkeypatch):
    _got, _want, df = _plans(q, CONFS[conf], small_tables, monkeypatch)
    rows = df.collect()
    assert rows
    assert_rows_equal(rows, _reference_rows(q, small_tables, monkeypatch),
                      approx_float=True, msg=f"{q} {conf}")


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_mixed_plan_rows_match_the_reference_mixed_plan(q, small_tables,
                                                        monkeypatch):
    """The default conf's mixed plan against the reference's own mixed
    plan (its device engine below and above its host aggregates)."""
    _got, want, df = _plans(q, {}, small_tables, monkeypatch)
    assert_rows_equal(df.collect(), want.collect(), approx_float=True,
                      msg=q)


@pytest.mark.parametrize("q", QUERIES)
def test_collect_host_matches_reference_bit_for_bit(q, small_tables,
                                                    monkeypatch):
    session, tables, _js, _jt = small_tables
    df = DataFrame(TpuSession(device="cpu"),
                   tpch.QUERIES[q](session, tables[q])._plan)
    got = df.collect_host()
    want = _reference_rows(q, small_tables, monkeypatch)
    assert len(got) == len(want) and got
    for r, (a, b) in enumerate(zip(got, want)):
        assert len(a) == len(b)
        assert all(_identical(x, y) for x, y in zip(a, b)), (r, a, b)


# ---------------------------------------------------------------------------
# The default conf's placement
# ---------------------------------------------------------------------------

DEFAULT_HOST = {"q1": ["LogicalAggregate"], "q6": ["LogicalAggregate"],
                "q3": ["LogicalAggregate"], "q5": ["LogicalAggregate"],
                "q2": [], "q4": []}


@pytest.mark.parametrize("q", QUERIES)
def test_default_conf_places_float_aggregates_on_the_host(q, small_tables,
                                                          monkeypatch):
    got, _want, _df = _plans(q, {}, small_tables, monkeypatch)
    assert got.host_fallback_nodes() == DEFAULT_HOST[q]
    trans = _transitions(_shape(got.root))
    if not DEFAULT_HOST[q]:
        assert not trans and got.root_on_device
        return
    # Partial aggregate <- DeviceToHost; HostToDevice <- final aggregate
    # under a device sort (q6 ends on the host).
    assert ("DeviceToHostExec", "HashAggregateExec") in \
        [(t, p) for t, p, _c in trans]
    if q == "q6":
        assert not got.root_on_device and len(trans) == 1
    else:
        assert ("HostToDeviceExec", "ShuffleExchangeExec",
                "HashAggregateExec") in trans
        assert got.root_on_device


def test_q1_tree_under_the_default_conf(small_tables, monkeypatch):
    got, _want, _df = _plans("q1", {}, small_tables, monkeypatch)
    names = [line.strip().split()[0] for line in got.tree().splitlines()]
    assert names[:8] == [
        "SortExec", "ShuffleExchangeExec", "HostToDeviceExec",
        "HashAggregateExec", "ShuffleExchangeExec", "HashAggregateExec",
        "DeviceToHostExec", "ProjectExec"]


def _host_halves():
    return [cls for cls in vars(TO).values()
            if isinstance(cls, type) and issubclass(cls, TO.Exec)
            and "execute_host" in vars(cls)]


@pytest.mark.parametrize("q", ["q2", "q4"])
def test_an_all_device_plan_never_reaches_the_host_engine(q, small_tables,
                                                         monkeypatch):
    session, tables, _js, _jt = small_tables
    df = DataFrame(TpuSession(device="cpu"),
                   tpch.QUERIES[q](session, tables[q])._plan)

    def refuse(self, ctx, partition):
        raise AssertionError(f"{type(self).__name__} ran on the host")
    for cls in _host_halves():
        monkeypatch.setattr(cls, "execute_host", refuse)
    assert df.collect()


def test_a_failing_device_exec_is_not_rerun_on_the_host(small_tables,
                                                        monkeypatch):
    """q1 under the default conf: its filter runs on the device below the
    host aggregate. When the filter raises, ``collect`` raises and no
    host aggregate produces rows."""
    session, tables, _js, _jt = small_tables
    df = DataFrame(TpuSession(device="cpu"),
                   tpch.QUERIES["q1"](session, tables["q1"])._plan)
    ran = []

    def boom(self, ctx, partition):
        raise RuntimeError("device filter failed")
        yield  # pragma: no cover

    def spy(name, orig):
        def wrapped(self, *a, **k):
            ran.append(name)
            return orig(self, *a, **k)
        return wrapped
    monkeypatch.setattr(TO.FilterExec, "execute_device", boom)
    for name in ("_host_exec_vectorized", "_execute_host_rows",
                 "_execute_host_final"):
        monkeypatch.setattr(TO.HashAggregateExec, name,
                            spy(name, getattr(TO.HashAggregateExec, name)))
    with pytest.raises(RuntimeError, match="device filter failed"):
        df.collect()
    assert ran == []
    # The host filter is still there for a host-placed node.
    session2 = TpuSession({"spark.rapids.sql.enabled": False},
                          device="cpu")
    assert DataFrame(session2, df._plan).collect()


def test_root_on_host_collects_on_the_host(small_tables):
    """q6's root (the final aggregate) runs on the host: ``collect``
    returns its rows without a download at the root."""
    session, tables, _js, _jt = small_tables
    df = DataFrame(TpuSession(device="cpu"),
                   tpch.QUERIES["q6"](session, tables["q6"])._plan)
    phys = df._physical()
    assert not phys.root_on_device
    ctx = TO.ExecContext(C.TpuConf())
    rows = phys.collect(ctx)
    assert len(rows) == 1 and not math.isnan(rows[0][0])
    d2h = [m for k, m in ctx.metrics.items()
           if k.startswith("DeviceToHostExec")]
    assert len(d2h) == 1 and d2h[0].values["downloadRows"] > 0
    assert isinstance(phys, PL.PhysicalPlan)
