"""Port parity of ``Like`` (``exprs/strings.py``) and of the COUNT / SUM
/ AVG DISTINCT pipeline (``plan/planner.py``
``_convert_distinct_aggregate`` over ``ops/aggregate.py``'s partial,
merge and mixed_final modes) against the JAX package, on the CPU.

- ``Like``: the device half (literal segments and ``%`` matched on the
  byte matrix; a ``_`` pattern through the host roundtrip) and the host
  half (an anchored regular expression, over both host string layouts)
  equal the reference's ``eval`` / ``eval_host`` on the same column:
  prefix, suffix and middle segments, escaped ``%`` and ``_``, no ``%``,
  empty strings and patterns, NULLs, multibyte UTF-8 and segments wider
  than the byte matrix.
- DISTINCT aggregates through the front end of both packages, on the
  device (``collect``) and on the host engine (``collect_host``), with
  ``variableFloatAgg`` on, under the default conf and with the
  aggregate's kill switch off (``spark.rapids.sql.exec.LogicalAggregate``,
  the aggregate on the host engine between device subtrees): with keys
  and with zero keys, beside non-distinct aggregates, over empty input,
  NULL x, and -0.0 / NaN x (one group each, as ``key_fingerprint``
  groups them), and a string Min beside a DISTINCT count (the host's
  python-row mixed path). min/max DISTINCT are plain min/max; first
  DISTINCT, two distinct inputs and DISTINCT under ROLLUP raise the
  reference's error.
- The plans: partial -> exchange -> merge -> mixed_final, the exec tree
  equal to the reference's (its exchange as the port's one-partition
  coalesce).
- ``mixed_final`` fed more batches than one consolidation chunk holds,
  on both halves of both packages.
- TPC-H q18 at scale 0.005 and seed 1 (two orders of more than 300
  units) against the reference over the same in-memory partitions, under
  both confs; q21's semi and anti joins with ``l2_suppkey != l_suppkey``
  over builds that repeat a key up to 7 times, on a small table of
  orders with equal and unequal suppliers, on both engines of both
  packages, broadcast and shuffled.
- TPCxBB xbb_q12 at scale 0.005 against the reference's
  ``suites.xbb_q12`` over its parquet, under both confs, and
  chip_smoke.py's oracle of it.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu import ops as JO
from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.benchmarks import suites as jsuites
from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.plan import logical as JL

from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch import ops as TO
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch.benchmarks import suites, tpch
from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost
from spark_rapids_tpu_torch.plan import logical as TL

from test_torch_placement import _shape

pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# Like
# ---------------------------------------------------------------------------

CAP, LIVE, WIDTH = 64, 57, 40
WORDS = [b"", b"special requests", b"special packages wake slyly requests",
         b"requests special", b"Customer recounts wake Complaints",
         b"Customer Complaints", b"100%", b"100% off", b"a_b", b"axb",
         b"abc", b"ab", b"b", b"xyz", b"aaa", b"abab", b"\xc3\xa9t\xc3\xa9",
         b"caf\xc3\xa9", b"%", b"_", b"a%b", b"special\nrequests"]
PATTERNS = [
    "%special%requests%", "%Customer%Complaints%", "abc", "", "%", "%%",
    "a%", "%c", "a%c", "%b%", "a%b%", "ab%ab", "%a%a%", "100\\%",
    "100\\%%", "%\\%", "a\\_b", "\\%", "a_b", "_b%", "%_", "___",
    "%é%", "caf_", "special%requests", "x" * (WIDTH + 3),
    "%" + "y" * (WIDTH + 1) + "%", "a%" + "z" * WIDTH, "s%s%s",
]


def _like_column(seed: int):
    """(data (CAP, WIDTH) uint8, validity, lengths) of a string column
    with NULLs and a dead tail."""
    rng = np.random.default_rng(seed)
    picked = [WORDS[i] for i in rng.integers(0, len(WORDS), CAP)]
    picked[:len(WORDS)] = WORDS         # every word at least once
    valid = (rng.random(CAP) < 0.9) & (np.arange(CAP) < LIVE)
    valid[:len(WORDS)] = True
    data = np.zeros((CAP, WIDTH), np.uint8)
    lens = np.zeros(CAP, np.int32)
    for i, w in enumerate(picked):
        if valid[i]:
            data[i, :len(w)] = np.frombuffer(w, np.uint8)
            lens[i] = len(w)
    return data, valid, lens


def _like_device(pattern: str):
    data, valid, lens = _like_column(len(pattern))
    jb = jbatch.DeviceBatch((jbatch.DeviceColumn(
        jdt.STRING, jnp.asarray(data), jnp.asarray(valid),
        jnp.asarray(lens)),), jnp.asarray(LIVE, jnp.int32))
    tb = tbatch.DeviceBatch((tbatch.DeviceColumn(
        tdt.STRING, torch.from_numpy(data.copy()),
        torch.from_numpy(valid.copy()), torch.from_numpy(lens.copy())),),
        torch.tensor(LIVE, dtype=torch.int32))
    jc = JE.Like(JE.BoundReference(0, jdt.STRING), pattern).eval(jb)
    tc = TE.Like(TE.BoundReference(0, tdt.STRING), pattern).eval(tb)
    return jc, tc


@pytest.mark.parametrize("pattern", PATTERNS)
def test_like_device_half_matches_reference(pattern):
    jc, tc = _like_device(pattern)
    want = np.asarray(jc.data)[:LIVE]
    np.testing.assert_array_equal(want, tc.data.numpy()[:LIVE])
    np.testing.assert_array_equal(np.asarray(jc.validity)[:LIVE],
                                  tc.validity.numpy()[:LIVE])
    assert TE.Like(None, pattern)._segments() == \
        JE.Like(None, pattern)._segments()


def test_like_inputs_hit_and_miss():
    """The column makes the checks above bite: the q13 and q16 patterns,
    an escaped ``%``, a ``_`` roundtrip and the exact match each hit some
    rows and miss others."""
    for pattern in ("%special%requests%", "%Customer%Complaints%",
                    "100\\%%", "a_b", "abc", "%b%"):
        _jc, tc = _like_device(pattern)
        hits = tc.data.numpy()[:LIVE] & tc.validity.numpy()[:LIVE]
        assert hits.any() and not hits[tc.validity.numpy()[:LIVE]].all(), \
            pattern


def _host_columns(H, D, layout: str):
    data, valid, lens = _like_column(5)
    data, valid, lens = data[:LIVE], valid[:LIVE], lens[:LIVE]
    if layout == "matrix":
        return H.HostColumn(D.STRING, None, valid, str_matrix=data,
                            str_lengths=lens)
    vals = np.empty(LIVE, dtype=object)
    vals[:] = [bytes(r[:n]) if ok else b""
               for r, n, ok in zip(data, lens, valid)]
    return H.HostColumn(D.STRING, vals, valid)


@pytest.mark.parametrize("layout", ["matrix", "objects"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_like_host_half_matches_reference(pattern, layout):
    jb = jhost.HostBatch(("s",), [_host_columns(jhost, jdt, layout)])
    tb = thost.HostBatch(("s",), [_host_columns(thost, tdt, layout)])
    want = JE.Like(JE.BoundReference(0, jdt.STRING), pattern).eval_host(jb)
    got = TE.Like(TE.BoundReference(0, tdt.STRING), pattern).eval_host(tb)
    np.testing.assert_array_equal(np.asarray(want.data), got.data)
    np.testing.assert_array_equal(np.asarray(want.validity), got.validity)


# ---------------------------------------------------------------------------
# DISTINCT aggregates through the front end
# ---------------------------------------------------------------------------

_REF = {"spark.rapids.sql.cost.enabled": False,
        "spark.rapids.sql.pipeline.enabled": False,
        "spark.rapids.sql.stageFusion.enabled": False,
        "spark.rapids.sql.shuffle.partitions": 1}
VFA = {"spark.rapids.sql.variableFloatAgg.enabled": True}
CONFS = {"vfa": VFA, "default": {},
         "agg_off": dict(VFA, **{"spark.rapids.sql.exec.LogicalAggregate":
                                 False})}

N = 61
F_POOL = [0.0, -0.0, 1.5, np.nan, -2.25, 4.0, None]


def _data():
    """k: int32 key with NULLs; s: string key; x: int64 with NULLs and
    repeats; f: float64 with -0.0, 0.0, NaN and NULLs; y: whole-number
    float payload (every sum exact in any order)."""
    rng = np.random.default_rng(11)
    k = [None if rng.random() < 0.1 else int(v)
         for v in rng.integers(0, 4, N)]
    s = [["aa", "b", "cc"][i] for i in rng.integers(0, 3, N)]
    x = [None if rng.random() < 0.15 else int(v)
         for v in rng.integers(-3, 6, N)]
    f = [F_POOL[i] for i in rng.integers(0, len(F_POOL), N)]
    y = [float(v) for v in rng.integers(0, 50, N)]
    return {"k": k, "s": s, "x": x, "f": f, "y": y}


def _schema(D):
    return [("k", D.INT32), ("s", D.STRING), ("x", D.INT64),
            ("f", D.FLOAT64), ("y", D.FLOAT64)]


def _aggd(L, kind, name):
    return L.Column(("aggd", kind, L.col(name)))


CASES = {
    "keyed_mixed": lambda L, df: df.group_by("k").agg(
        L.agg_count_distinct(L.col("x")).alias("nx"),
        L.agg_count().alias("n"), L.agg_sum(L.col("y")).alias("sy"),
        L.agg_avg(L.col("y")).alias("ay")),
    "zero_key": lambda L, df: df.agg(
        L.agg_count_distinct(L.col("x")).alias("nx"),
        L.agg_sum(L.col("y")).alias("sy")),
    "sum_avg_distinct": lambda L, df: df.group_by("s").agg(
        L.agg_sum_distinct(L.col("x")).alias("sx"),
        L.agg_avg_distinct(L.col("x")).alias("ax"),
        L.agg_count_distinct(L.col("x")).alias("nx")),
    "float_x": lambda L, df: df.group_by("s", "k").agg(
        L.agg_count_distinct(L.col("f")).alias("nf"),
        L.agg_sum_distinct(L.col("f")).alias("sf"),
        L.agg_max(L.col("y")).alias("my")),
    "float_x_zero_key": lambda L, df: df.agg(
        L.agg_count_distinct(L.col("f")).alias("nf"),
        L.agg_avg_distinct(L.col("f")).alias("af")),
    "computed_x": lambda L, df: df.group_by("s").agg(
        L.agg_count_distinct(L.col("x") * 2).alias("n2"),
        L.agg_sum_distinct(L.col("x") * 2).alias("s2")),
    "empty_keyed": lambda L, df: df.filter(L.col("y") > 100.0)
    .group_by("k").agg(L.agg_count_distinct(L.col("x")).alias("nx")),
    "empty_zero_key": lambda L, df: df.filter(L.col("y") > 100.0).agg(
        L.agg_count_distinct(L.col("x")).alias("nx"),
        L.agg_count().alias("n")),
    "minmax_distinct": lambda L, df: df.group_by("k").agg(
        _aggd(L, "min", "x").alias("mn"), _aggd(L, "max", "f").alias("mx")),
    "string_min_beside": lambda L, df: df.group_by("k").agg(
        L.agg_count_distinct(L.col("x")).alias("nx"),
        L.agg_min(L.col("s")).alias("ms")),
}


def _frames(case, conf):
    jdf = CASES[case](JL, JSession(dict(conf, **_REF)).create_dataframe(
        _data(), _schema(jdt), num_partitions=3))
    tdf = CASES[case](TL, TpuSession(dict(conf), device="cpu")
                      .create_dataframe(_data(), _schema(tdt),
                                        num_partitions=3))
    return jdf, tdf


def _sorted(rows):
    return sorted(rows, key=repr)


@pytest.mark.parametrize("conf", sorted(CONFS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_distinct_aggregate_matches_reference(case, conf):
    """Rows on the device and on the host engine equal the reference's
    on each (repr: NaN and -0.0 exact); the plan's placement and exec
    tree equal the reference's."""
    jdf, tdf = _frames(case, CONFS[conf])
    jphys, tphys = jdf._physical(), tdf._physical()
    assert tphys.host_fallback_nodes() == jphys.host_fallback_nodes()
    assert _shape(tphys.root) == _shape(jphys.root)
    assert repr(_sorted(tdf.collect())) == repr(_sorted(jdf.collect()))
    assert repr(_sorted(tdf.collect_host())) == \
        repr(_sorted(jdf.collect_host()))


def test_distinct_cases_are_not_vacuous():
    """NULL x is dropped, -0.0 and 0.0 count once, NaN counts once, and
    the empty zero-key case gives one row of 0 on both engines (as the
    reference's exchange serves the mixed stage no empty batch)."""
    _j, tdf = _frames("float_x_zero_key", VFA)
    d = _data()
    assert tdf.collect()[0][0] == 5       # 0.0 (= -0.0), 1.5, NaN, -2.25, 4
    assert any(v is None for v in d["x"]) and any(
        v is not None and np.isnan(v) for v in d["f"])
    _j, tdf = _frames("empty_zero_key", VFA)
    assert tdf.collect() == [(0, 0)] and tdf.collect_host() == [(0, 0)]
    _j, tdf = _frames("empty_keyed", VFA)
    assert tdf.collect() == [] and tdf.collect_host() == []
    _j, tdf = _frames("keyed_mixed", {})
    assert tdf._physical().tree().splitlines()[:4] == [
        "HashAggregateExec mixed_final by ['k']",
        "  HashAggregateExec merge by ['k', '__distinct_x']",
        "    ShuffleExchangeExec HashPartitioning(1)",
        "      HashAggregateExec partial by ['k', '__distinct_x']"]


ERRORS = {
    "first_distinct": (lambda L, df: df.group_by("k").agg(
        _aggd(L, "first", "x").alias("f")), "not meaningful"),
    "two_inputs": (lambda L, df: df.group_by("k").agg(
        L.agg_count_distinct(L.col("x")).alias("a"),
        L.agg_count_distinct(L.col("f")).alias("b")),
        "must share the same input expression"),
    "rollup": (lambda L, df: df.rollup("k", "s").agg(
        L.agg_count_distinct(L.col("x")).alias("a")),
        "under rollup/cube are unsupported"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_distinct_errors_match_reference(case):
    build, msg = ERRORS[case]
    jdf = build(JL, JSession(dict(VFA, **_REF)).create_dataframe(
        _data(), _schema(jdt)))
    tdf = build(TL, TpuSession(dict(VFA), device="cpu").create_dataframe(
        _data(), _schema(tdt)))
    with pytest.raises(JL.ResolutionError, match=msg):
        jdf.collect()
    with pytest.raises(TL.ResolutionError, match=msg):
        tdf.collect()


# ---------------------------------------------------------------------------
# mixed_final over more batches than one consolidation chunk
# ---------------------------------------------------------------------------

def _mixed_exec(P, D, H, host_parts):
    """mixed_final keyed by k over [k, x, count buffer] batches arriving
    as ``len(host_parts)`` partitions coalesced into one stream."""
    schema = (("k", D.INT32), ("x", D.INT64), ("n#buf0", D.INT64))
    src = P.O.InMemorySourceExec(schema, host_parts, **P.src_kw)
    specs = [P.O.AggSpec("nx", P.O.Count(P.E.BoundReference(1, D.INT64)),
                         distinct=True),
             P.O.AggSpec("n", P.O.CountStar(None))]
    return P.O.HashAggregateExec(
        P.O.CoalescePartitionsExec(src, 1),
        [("k", P.E.BoundReference(0, D.INT32))], specs, mode="mixed_final")


def _mixed_parts(H, D, n_parts: int):
    """Unique (k, x) rows split over ``n_parts`` partitions, a NULL x in
    some, with partial count buffers."""
    rng = np.random.default_rng(3)
    pairs = sorted({(int(a), int(b)) for a, b in
                    zip(rng.integers(0, 5, 400), rng.integers(0, 60, 400))})
    parts = []
    for i in range(n_parts):
        chunk = pairs[i::n_parts]
        k = np.array([a for a, _ in chunk], np.int32)
        x = np.array([b for _, b in chunk], np.int64)
        xv = x % 17 != 0
        cnt = rng.integers(1, 9, len(chunk)).astype(np.int64)
        parts.append([H.HostBatch(("k", "x", "n#buf0"), [
            H.HostColumn(D.INT32, k, np.ones(len(k), np.bool_)),
            H.HostColumn(D.INT64, np.where(xv, x, 0), xv),
            H.HostColumn(D.INT64, cnt, np.ones(len(k), np.bool_))])])
    return parts


def test_mixed_final_over_many_batches_matches_reference():
    import types
    n_parts = TO.HashAggregateExec._CONSOLIDATE_CHUNK + 5
    J = types.SimpleNamespace(O=JO, E=JE, src_kw={})
    T = types.SimpleNamespace(O=TO, E=TE, src_kw={"device": "cpu"})
    jx = _mixed_exec(J, jdt, jhost, _mixed_parts(jhost, jdt, n_parts))
    tx = _mixed_exec(T, tdt, thost, _mixed_parts(thost, tdt, n_parts))
    want = _sorted(jx.collect())
    assert want and all(r[1] <= 60 for r in want)
    assert repr(_sorted(tx.collect())) == repr(want)
    want_h = _sorted(jx.collect(device=False))
    assert repr(_sorted(tx.collect(device=False))) == repr(want_h)
    assert repr(want_h) == repr(want)


# ---------------------------------------------------------------------------
# TPC-H q18 with qualifying orders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("conf", ["vfa", "default"])
def test_q18_with_qualifying_orders_matches_reference(conf, monkeypatch):
    """TPC-H q18 at scale 0.005, seed 1, which holds two orders of more
    than 300 units (seed 0 holds none; tests/test_torch_tpch_validate.py
    compares it there), over the same in-memory partitions in both
    packages."""
    from test_torch_logical import jax_query, jax_tables
    from test_torch_placement import REF_OFF
    from test_torch_tpch_df import _assert_rows_close
    pconf, jconf = (VFA, VFA) if conf == "vfa" else ({}, REF_OFF)
    session = TpuSession(dict(pconf), device="cpu")
    tables = tpch.tpch_tables(session, E.tpch_columns(0.005, seed=1),
                              ("q18",))
    jsession = JSession(dict(jconf))
    want = jax_query(monkeypatch, "q18", jsession,
                     jax_tables(jsession, tables)["q18"]).collect()
    got = tpch.q18(session, tables["q18"]).collect()
    assert len(want) == 2
    _assert_rows_close(got, want)


# ---------------------------------------------------------------------------
# q21's joins: residual conditions over builds with repeated keys
# ---------------------------------------------------------------------------

# (orderkey, suppkey, late): order 1 one supplier on every line, order 2
# two suppliers with one late, order 3 seven lines of three suppliers,
# several late, order 4 a single line, order 5 five lines of one supplier
# and one line of another.
_LINES = [(1, 7, True), (1, 7, False), (1, 7, True),
          (2, 7, True), (2, 8, False),
          (3, 5, True), (3, 6, True), (3, 5, False), (3, 9, False),
          (3, 6, True), (3, 5, True), (3, 9, True),
          (4, 3, True),
          (5, 2, True), (5, 2, True), (5, 2, False), (5, 2, True),
          (5, 2, True), (5, 4, False)]


def _q21_joins(L, session, D, strategy):
    rows = {"k": [r[0] for r in _LINES], "s": [r[1] for r in _LINES],
            "late": [r[2] for r in _LINES]}
    schema = [("k", D.INT64), ("s", D.INT64), ("late", D.BOOL)]
    li = session.create_dataframe(rows, schema, num_partitions=2)
    l1 = li.filter(L.col("late"))
    l2 = li.select(L.col("k").alias("k2"), L.col("s").alias("s2"))
    l3 = li.filter(L.col("late")).select(L.col("k").alias("k3"),
                                         L.col("s").alias("s3"))
    return l1.join_on(l2, ["k"], ["k2"], how="semi",
                      condition=L.col("s2") != L.col("s"),
                      strategy=strategy) \
        .join_on(l3, ["k"], ["k3"], how="anti",
                 condition=L.col("s3") != L.col("s"), strategy=strategy) \
        .order_by(L.col("k").asc(), L.col("s").asc())


@pytest.mark.parametrize("strategy", ["broadcast", "shuffle"])
def test_conditional_semi_anti_over_repeated_keys_match_reference(
        strategy):
    jdf = _q21_joins(JL, JSession(dict(VFA, **_REF)), jdt, strategy)
    want = jdf.collect()
    # Late lines whose order has another supplier and no other late one.
    assert want == [(2, 7, True), (5, 2, True), (5, 2, True), (5, 2, True),
                    (5, 2, True)]
    assert jdf.collect_host() == want
    df = _q21_joins(TL, TpuSession(dict(VFA), device="cpu"), tdt, strategy)
    assert df.collect() == want
    assert df.collect_host() == want


# ---------------------------------------------------------------------------
# TPCxBB xbb_q12
# ---------------------------------------------------------------------------

XBB_SCALE = 0.005


@pytest.fixture(scope="module")
def xbb_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("xbb_q12"))
    jsuites.generate(d, scale=XBB_SCALE, seed=0)
    return d


@pytest.fixture(scope="module")
def xbb_cols():
    return suites.suite_columns(XBB_SCALE, seed=0)


@pytest.mark.parametrize("conf", ["vfa", "default"])
def test_xbb_q12_matches_reference(conf, xbb_dir, xbb_cols):
    raw = CONFS[conf]
    ref_conf = dict(raw, **{k: v for k, v in _REF.items()
                            if k != "spark.rapids.sql.shuffle.partitions"})
    want = jsuites.xbb_q12(JSession(ref_conf), xbb_dir).collect()
    session = TpuSession(dict(raw), device="cpu")
    df = suites.xbb_q12(session, suites.suite_tables(
        session, xbb_cols, ("xbb_q12",))["xbb_q12"])
    assert df._physical().host_fallback_nodes() == []
    got = df.collect()
    assert len(want) == 10 and got == want
    # Distinct users per category: fewer than the rows that reach it.
    assert all(0 < n < 2000 for _c, n in got)


def test_xbb_q12_tables_hold_the_columns_the_reference_scans_read(xbb_dir):
    from spark_rapids_tpu.plan import pruning as JP
    from test_torch_tpch_df import _scan_columns
    jdf = jsuites.xbb_q12(JSession(dict(VFA)), xbb_dir)
    read = _scan_columns(JP.prune_columns(jdf._plan), {})
    scans = suites.SCANS["xbb_q12"]
    assert set(read) == set(scans)
    for table, names in read.items():
        full = [n for n, _ in jdf._session.read.parquet(
            *jsuites._paths(xbb_dir, table)).schema]
        assert [n for n, _ in scans[table]] == \
            [n for n in full if n in names], table


def test_chip_smoke_xbb_q12_oracle_agrees_with_port(xbb_cols):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    session = TpuSession(dict(VFA), device="cpu")
    rows = suites.xbb_q12(session, suites.suite_tables(
        session, xbb_cols, ("xbb_q12",))["xbb_q12"]).collect()
    want = chip_smoke.xbb_q12_oracle(xbb_cols, suites)
    chip_smoke.check_rows("xbb_q12", rows, want)
    with pytest.raises(AssertionError):
        chip_smoke.check_rows("xbb_q12", [(c, n + 1) for c, n in rows],
                              want)
