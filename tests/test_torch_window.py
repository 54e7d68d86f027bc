"""Port parity of the window functions and the grouping-set expand:
``ops/window.py`` ``compute_window`` (the device half, here on the CPU)
and ``_host_window`` (the host engine) against the JAX package's, on the
same seeded numpy batches, bit for bit; ``ExpandExec``'s two halves; and
``merge_windows``.

- Inputs: a 64-row batch with a dead tail, a string and an int partition
  key with NULLs, a float order key with ties, NaN, -0.0, 0.0 and NULLs,
  int and float values with NULLs, NaN and -0.0, a string payload, and
  an ascending date for the RANGE frames.
- Functions: row_number, rank, dense_rank, lead/lag of ints, floats and
  strings, and sum/avg/count/min/max (string min/max too) over the whole
  partition, the running frame with peers (Spark's default with an ORDER
  BY), ROWS frames (bounded, and unbounded preceding to the current row)
  and RANGE frames of value offsets.
- ``ExpandExec``: a ROLLUP's projections (typed NULL string and int
  literals, the grouping id) on both engines of both packages.
- ``merge_windows``: adjacent windows of one spec merge; another spec, or
  an outer window reading the inner one's output, stays apart.
- ROLLUP NULLs through the front end on both engines: rolled-up string
  and int keys are typed NULLs, a data NULL never merges with a subtotal
  NULL (the grouping id keeps them apart), the grand total ranks in the
  window's NULL partition, and the sort puts NULLs first.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import config as JC
from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu import ops as JO
from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.exprs.base import eval_exprs as jeval_exprs
from spark_rapids_tpu.ops import basic as jbasic
from spark_rapids_tpu.ops import sort as jsort
from spark_rapids_tpu.ops import window as jwin
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu.plan import planner as JPL

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch import ops as TO
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost
from spark_rapids_tpu_torch.ops import basic as tbasic
from spark_rapids_tpu_torch.ops import sort as tsort
from spark_rapids_tpu_torch.ops import window as twin
from spark_rapids_tpu_torch.plan import logical as TL
from spark_rapids_tpu_torch.plan import planner as TPL

pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")

CAP = 64
LIVE = 53
# (name, type) of the generated columns.
SCHEMA = (("g", "string"), ("k", "int32"), ("o", "float64"), ("v", "int64"),
          ("f", "float64"), ("s", "string"), ("d", "date"))
STR_G = [b"a", b"bb", b"c"]
STR_S = [b"", b"x", b"xy", b"xyz", b"y", b"yx"]
# Sums of these are exact in any order, so both engines agree bit for bit.
F_POOL = np.array([0.0, -0.0, 1.5, -2.25, 3.0, 0.5, np.nan])
O_POOL = np.array([0.0, -0.0, 1.0, 2.0, np.nan, -1.0])


def _columns(seed: int):
    """(type, data, validity, lengths) per SCHEMA column over CAP rows,
    rows past LIVE dead; a string's data is a zero-padded byte matrix."""
    rng = np.random.default_rng(seed)
    live = np.arange(CAP) < LIVE
    out = []
    for name, t in SCHEMA:
        lens = None
        if t == "string":
            pool = STR_G if name == "g" else STR_S
            pick = [pool[i] for i in rng.integers(0, len(pool), CAP)]
            data = np.zeros((CAP, 4), np.uint8)
            for i, b in enumerate(pick):
                data[i, :len(b)] = np.frombuffer(b, np.uint8)
            lens = np.array([len(b) for b in pick], np.int32)
        elif name == "k":
            data = rng.integers(0, 3, CAP).astype(np.int32)
        elif name == "o":
            data = rng.choice(O_POOL, CAP)
        elif name == "v":
            data = rng.integers(-20, 20, CAP).astype(np.int64)
        elif name == "f":
            data = rng.choice(F_POOL, CAP)
        else:
            data = np.sort(rng.integers(100, 140, CAP)).astype(np.int32)
        valid = (rng.random(CAP) < 0.85) if name != "d" else \
            np.ones(CAP, np.bool_)
        valid &= live
        data = np.where(valid[:, None] if data.ndim == 2 else valid, data,
                        np.zeros(1, data.dtype))
        if lens is not None:
            lens = np.where(valid, lens, 0).astype(np.int32)
        out.append((t, data, valid, lens))
    return out


def _device_batches(seed: int):
    cols = _columns(seed)
    jb = jbatch.DeviceBatch(tuple(
        jbatch.DeviceColumn(jdt.type_named(t), jnp.asarray(d),
                            jnp.asarray(v),
                            None if l is None else jnp.asarray(l))
        for t, d, v, l in cols), jnp.asarray(LIVE, jnp.int32))
    tb = tbatch.DeviceBatch(tuple(
        tbatch.DeviceColumn(tdt.type_named(t), torch.from_numpy(d.copy()),
                            torch.from_numpy(v.copy()),
                            None if l is None else torch.from_numpy(l.copy()))
        for t, d, v, l in cols), torch.tensor(LIVE, dtype=torch.int32))
    return jb, tb


def _host_batches(seed: int):
    """The live rows as host batches of both packages (strings as the
    byte matrix of a download)."""
    out = []
    for H, D in ((jhost, jdt), (thost, tdt)):
        hcols = []
        for t, d, v, l in _columns(seed):
            dtype = D.type_named(t)
            if dtype.is_string:
                hcols.append(H.HostColumn(dtype, None, v[:LIVE].copy(),
                                          str_matrix=d[:LIVE].copy(),
                                          str_lengths=l[:LIVE].copy()))
            else:
                hcols.append(H.HostColumn(dtype, d[:LIVE].copy(),
                                          v[:LIVE].copy()))
        out.append(H.HostBatch(tuple(n for n, _ in SCHEMA), hcols))
    return out


class _Pkg:
    def __init__(self, E, D, W, S):
        self.E, self.D, self.W, self.S = E, D, W, S

    def ref(self, name):
        i = [n for n, _ in SCHEMA].index(name)
        return self.E.BoundReference(i, self.D.type_named(SCHEMA[i][1]))


JAX = _Pkg(JE, jdt, jwin, jsort)
PORT = _Pkg(TE, tdt, twin, tsort)

# Window specs: (partition keys, [(order key, ascending, nulls first)]).
SPECS = {
    "g_by_o": (["g"], [("o", True, True)]),
    "gk_by_o_desc_v": (["g", "k"], [("o", False, False), ("v", True, True)]),
    "all_by_o": ([], [("o", True, True)]),
    "g": (["g"], []),
    "gk": (["g", "k"], []),
    "k_by_d": (["k"], [("d", True, True)]),
}


def _spec(P, name):
    parts, orders = SPECS[name]
    return P.W.WindowSpec([P.ref(n) for n in parts],
                          [P.S.SortOrder(P.ref(n), a, nf)
                           for n, a, nf in orders])


WHOLE = (None, None, False, False)
RUNNING = (None, 0, True, False)
# (function, child column, frame (preceding, following, with peers,
# range interval) or None, spec) of every case.
CASES = {
    "row_number": ("row_number", None, None, "g_by_o"),
    "rank": ("rank", None, None, "g_by_o"),
    "dense_rank": ("dense_rank", None, None, "g_by_o"),
    "rank_two_keys_desc": ("rank", None, None, "gk_by_o_desc_v"),
    "dense_rank_two_keys": ("dense_rank", None, None, "gk_by_o_desc_v"),
    "row_number_unpartitioned": ("row_number", None, None, "all_by_o"),
    "rank_unpartitioned": ("rank", None, None, "all_by_o"),
    "lead_int": ("lead", "v", 1, "g_by_o"),
    "lag_int_2": ("lag", "v", 2, "gk_by_o_desc_v"),
    "lead_float_3": ("lead", "f", 3, "all_by_o"),
    "lead_string": ("lead", "s", 1, "g_by_o"),
    "lag_string": ("lag", "s", 1, "gk_by_o_desc_v"),
    "sum_int_whole": ("sum", "v", WHOLE, "g"),
    "sum_float_whole": ("sum", "f", WHOLE, "gk"),
    "avg_int_whole": ("avg", "v", WHOLE, "gk"),
    "avg_float_whole": ("avg", "f", WHOLE, "g"),
    "count_whole": ("count", "v", WHOLE, "g"),
    "count_star_whole": ("count", None, WHOLE, "gk"),
    "min_int_whole": ("min", "v", WHOLE, "gk"),
    "max_int_whole": ("max", "v", WHOLE, "g"),
    "min_float_whole": ("min", "f", WHOLE, "g"),
    "max_float_whole": ("max", "f", WHOLE, "gk"),
    "min_string_whole": ("min", "s", WHOLE, "g"),
    "max_string_whole": ("max", "s", WHOLE, "gk"),
    "sum_int_running": ("sum", "v", RUNNING, "g_by_o"),
    "avg_float_running": ("avg", "f", RUNNING, "gk_by_o_desc_v"),
    "count_running": ("count", "v", RUNNING, "g_by_o"),
    "min_int_running": ("min", "v", RUNNING, "g_by_o"),
    "max_float_running": ("max", "f", RUNNING, "gk_by_o_desc_v"),
    "min_float_running": ("min", "f", RUNNING, "all_by_o"),
    "sum_int_rows": ("sum", "v", (2, 1, False, False), "g_by_o"),
    "avg_float_rows": ("avg", "f", (1, 2, False, False), "gk_by_o_desc_v"),
    "count_star_rows": ("count", None, (3, 0, False, False), "all_by_o"),
    "sum_float_rows_to_end": ("sum", "f", (1, None, False, False),
                              "g_by_o"),
    "min_int_rows_unbounded": ("min", "v", (None, 0, False, False),
                               "g_by_o"),
    "max_int_rows_unbounded": ("max", "v", (None, 0, False, False),
                               "gk_by_o_desc_v"),
    "sum_int_range": ("sum", "v", (3, 2, False, True), "k_by_d"),
    "count_range": ("count", "v", (None, 4, False, True), "k_by_d"),
    "avg_float_range": ("avg", "f", (5, None, False, True), "k_by_d"),
}


def _window_fn(P, case):
    fn, child, arg, _spec_name = CASES[case]
    W = P.W
    if fn == "row_number":
        return W.RowNumber()
    if fn == "rank":
        return W.Rank()
    if fn == "dense_rank":
        return W.DenseRank()
    if fn in ("lead", "lag"):
        return (W.Lead if fn == "lead" else W.Lag)(P.ref(child), arg)
    pre, fol, peers, rng = arg
    return W.WindowAgg(fn, None if child is None else P.ref(child),
                       W.WindowFrame(pre, fol, peers, rng))


def _exprs(P, cases):
    return [P.W.WindowExprSpec(c, _window_fn(P, c), _spec(P, CASES[c][3]))
            for c in cases]


def _same_device_col(jc, tc, what):
    assert jc.dtype.name == tc.dtype.name, what
    jv, tv = np.asarray(jc.validity), tc.validity.numpy()
    np.testing.assert_array_equal(jv, tv, what)
    jd, td = np.asarray(jc.data), tc.data.numpy()
    assert jd.dtype == td.dtype and jd.shape == td.shape, what
    # Bit for bit: NaN payloads and the sign of zero included.
    assert jd.tobytes() == td.tobytes(), (what, jd, td)
    if jc.dtype.is_string:
        np.testing.assert_array_equal(np.asarray(jc.lengths),
                                      tc.lengths.numpy(), what)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_compute_window_matches_reference(case, seed):
    jb, tb = _device_batches(seed)
    jout = jwin.compute_window(jb, _exprs(JAX, [case]))
    tout = twin.compute_window(tb, _exprs(PORT, [case]))
    assert len(tout.columns) == len(jout.columns) == len(SCHEMA) + 1
    _same_device_col(jout.columns[-1], tout.columns[-1], case)
    assert int(tout.num_rows) == LIVE


def _same_host_col(jc, tc, what):
    assert jc.dtype.name == tc.dtype.name, what
    np.testing.assert_array_equal(np.asarray(jc.validity, np.bool_),
                                  np.asarray(tc.validity, np.bool_), what)
    if jc.dtype.is_string:
        assert jc.to_list() == tc.to_list(), what
        return
    jd, td = np.asarray(jc.data), np.asarray(tc.data)
    assert jd.dtype == td.dtype, what
    assert jd.tobytes() == td.tobytes(), (what, jd, td)


def _schema(P, cases):
    return tuple((n, P.D.type_named(t)) for n, t in SCHEMA) + tuple(
        (c, _window_fn(P, c).result_type()) for c in cases)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_host_window_matches_reference(case, seed):
    """The vectorized host path, or the python oracle for the shapes it
    does not take (bounded min/max frames, string min/max, NaN sums)."""
    jhb, thb = _host_batches(seed)
    jout = jwin._host_window(jhb, _exprs(JAX, [case]), _schema(JAX, [case]))
    tout = twin._host_window(thb, _exprs(PORT, [case]),
                             _schema(PORT, [case]))
    assert tuple(tout.names) == tuple(jout.names)
    _same_host_col(jout.columns[-1], tout.columns[-1], case)


def test_window_exec_several_exprs_on_both_engines():
    """One ``WindowExec`` of several expressions over a partition of two
    batches: the device half coalesces them into one, the host half
    concatenates them; both packages, both engines."""
    cases = ["rank", "lead_string", "sum_float_whole", "count_running",
             "avg_float_rows", "max_string_whole"]
    rows = {}
    for name, P, H, O, ctx, src in (
            ("jax", JAX, jhost, JO, JO.ExecContext(JC.TpuConf()),
             lambda s, p: JO.InMemorySourceExec(s, p)),
            ("port", PORT, thost, TO, TO.ExecContext(C.TpuConf()),
             lambda s, p: TO.InMemorySourceExec(s, p, device="cpu"))):
        hb = _host_batches(3)[0 if name == "jax" else 1]
        half = LIVE // 2
        parts = [[hb.take(np.arange(half)), hb.take(np.arange(half, LIVE))]]
        schema = tuple((n, P.D.type_named(t)) for n, t in SCHEMA)
        exec_ = P.W.WindowExec(src(schema, parts), _exprs(P, cases))
        dev = exec_.collect(ctx)
        host = exec_.collect(ctx, device=False)
        rows[name] = (dev, host)
    assert repr(rows["port"][0]) == repr(rows["jax"][0])
    assert repr(rows["port"][1]) == repr(rows["jax"][1])
    assert len(rows["port"][0]) == LIVE


# ---------------------------------------------------------------------------
# ExpandExec
# ---------------------------------------------------------------------------

def _rollup_projections(P):
    """A ROLLUP over (g, k) of sum(v)'s input, as the planner builds it:
    keys kept or NULLed, the aggregate input, the grouping id."""
    g, k, v = P.ref("g"), P.ref("k"), P.ref("v")
    D, Lit = P.D, P.E.Literal
    return [[g, k, v, Lit(D.INT64, 0)],
            [g, Lit(D.INT32, None), v, Lit(D.INT64, 1)],
            [Lit(D.STRING, None), Lit(D.INT32, None), v, Lit(D.INT64, 3)]]


EXPAND_NAMES = ("g", "k", "__agg_in0", "__grouping_id")


def test_expand_exec_device_half_matches_reference():
    jb, tb = _device_batches(4)
    jouts = [jeval_exprs(p, jb) for p in _rollup_projections(JAX)]
    tex = tbasic.ExpandExec(_Once(tb), _rollup_projections(PORT),
                            EXPAND_NAMES)
    touts = list(tex.execute_device(TO.ExecContext(C.TpuConf()), 0))
    assert len(touts) == len(jouts) == 3
    for i, (jo, to) in enumerate(zip(jouts, touts)):
        assert len(to.columns) == 4
        for ci, (jc, tc) in enumerate(zip(jo.columns, to.columns)):
            if jc.dtype.is_string and jc.data.shape != tc.data.shape:
                # An all-NULL string column: both zero-filled, only the
                # width bucket of the empty literal may differ.
                assert not np.asarray(jc.validity).any()
                assert not tc.validity.numpy().any()
                assert not tc.data.numpy().any()
                continue
            _same_device_col(jc, tc, f"projection {i} column {ci}")


class _Once(TO.Exec):
    """A leaf yielding one given device batch."""

    def __init__(self, batch):
        super().__init__()
        self.batch = batch

    def num_partitions(self, ctx):
        return 1

    def execute_device(self, ctx, partition):
        yield self.batch


def test_expand_exec_host_half_matches_reference():
    jhb, thb = _host_batches(5)
    schema_j = tuple((n, jdt.type_named(t)) for n, t in SCHEMA)
    schema_t = tuple((n, tdt.type_named(t)) for n, t in SCHEMA)
    jex = jbasic.ExpandExec(JO.InMemorySourceExec(schema_j, [[jhb]]),
                            _rollup_projections(JAX), EXPAND_NAMES)
    tex = tbasic.ExpandExec(TO.InMemorySourceExec(schema_t, [[thb]],
                                                  device="cpu"),
                            _rollup_projections(PORT), EXPAND_NAMES)
    jouts = list(jex.execute_host(JO.ExecContext(JC.TpuConf()), 0))
    touts = list(tex.execute_host(TO.ExecContext(C.TpuConf()), 0))
    assert tex.schema == tuple((n, tdt.type_named(t.name))
                               for n, t in jex.schema)
    assert len(touts) == len(jouts) == 3
    for jo, to in zip(jouts, touts):
        assert tuple(to.names) == tuple(jo.names) == EXPAND_NAMES
        assert to.to_pylist() == jo.to_pylist()
        for jc, tc in zip(jo.columns, to.columns):
            _same_host_col(jc, tc, "expand")
    # The subtotal rows' NULL keys are NULL, and the data NULLs stay
    # beside a grouping id of 0.
    assert all(r[0] is None and r[1] is None and r[3] == 3
               for r in touts[2].to_pylist())


# ---------------------------------------------------------------------------
# merge_windows
# ---------------------------------------------------------------------------

def _window_chain(L, outer_spec_same: bool, outer_reads_inner: bool):
    scan = L.InMemoryScan(tuple((n, (jdt if L is JL else tdt)
                                 .type_named(t)) for n, t in SCHEMA), [[]])
    w = L.Window.partition_by("g").order_by(L.col("o").desc())
    inner = L.LogicalWindow(scan, [("rk", L.rank())], w)
    w2 = w if outer_spec_same else L.Window.partition_by("k")
    arg = L.col("rk") if outer_reads_inner else L.col("v")
    return L.LogicalWindow(inner, [("s", L.agg_sum(arg))], w2)


@pytest.mark.parametrize("same_spec,reads_inner,merged", [
    (True, False, True), (False, False, False), (True, True, False)])
def test_merge_windows_matches_reference(same_spec, reads_inner, merged):
    got = TPL.merge_windows(_window_chain(TL, same_spec, reads_inner))
    want = JPL.merge_windows(_window_chain(JL, same_spec, reads_inner))

    def shape(p):
        out = []
        while isinstance(p, (TL.LogicalWindow, JL.LogicalWindow)):
            out.append([n for n, _ in p.exprs])
            p = p.child
        return out
    assert shape(got) == shape(want)
    assert shape(got) == ([["rk", "s"]] if merged else [["s"], ["rk"]])
    assert [n for n, _ in got.schema] == [n for n, _ in want.schema]


# ---------------------------------------------------------------------------
# ROLLUP NULLs through the front end, both engines
# ---------------------------------------------------------------------------

ROLLUP_DATA = {
    "a": ["x", "x", None, "y", None, "x", "y", None, "x", "y"],
    "b": ["p", None, "p", "q", None, "p", None, "q", "q", "q"],
    "c": [1, 2, None, 1, 2, None, 3, 1, 1, None],
    "v": [1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0],
}


def _rollup_query(L, session, D):
    schema = [("a", D.STRING), ("b", D.STRING), ("c", D.INT32),
              ("v", D.FLOAT64)]
    df = session.create_dataframe(ROLLUP_DATA, schema, num_partitions=2)
    r = df.rollup("a", "b", "c").agg(L.agg_sum(L.col("v")).alias("s"),
                                     L.agg_count().alias("n"))
    w = L.Window.partition_by("a").order_by(L.col("s").desc())
    return r.with_column("rk", L.rank().over(w)).order_by(
        *[L.col(k).asc() for k in ("a", "b", "c", "s", "rk")])


def test_rollup_nulls_match_reference_on_both_engines():
    ref_conf = {"spark.rapids.sql.variableFloatAgg.enabled": True,
                "spark.rapids.sql.cost.enabled": False,
                "spark.rapids.sql.pipeline.enabled": False,
                "spark.rapids.sql.stageFusion.enabled": False}
    jdf = _rollup_query(JL, JSession(ref_conf), jdt)
    want = jdf.collect()
    assert repr(jdf.collect_host()) == repr(want)
    vfa = {"spark.rapids.sql.variableFloatAgg.enabled": True}
    for conf in (vfa, {}):
        df = _rollup_query(TL, TpuSession(conf, device="cpu"), tdt)
        assert repr(df.collect()) == repr(want), conf
        assert repr(df.collect_host()) == repr(want), conf
    # Every key NULL: the grand total, the a-NULL group's subtotal and
    # the (a NULL, b NULL) group's subtotal stay three rows.
    all_null = [r for r in want if r[:3] == (None, None, None)]
    assert sorted(r[3] for r in all_null) == [16.0, 148.0, 1023.0]
    # The grand total ranks first in the NULL partition of ``a``; NULLs
    # sort first.
    assert max(all_null, key=lambda r: r[3])[5] == 1
    assert want[0][:3] == (None, None, None)
    # Under a=x, the data-NULL ``b`` group's subtotal (2.0) and the a=x
    # subtotal (291.0) are two rows.
    assert sorted(r[3] for r in want if r[:3] == ("x", None, None)) == \
        [2.0, 291.0]


# ---------------------------------------------------------------------------
# Windowed float sums over NaN and +inf: the port keeps the reference's
# prefix-difference behaviour on each engine
# ---------------------------------------------------------------------------

# One shuffle partition: on the tests' eight virtual devices the
# reference would hash k=1 and k=2 into different partitions.
_REF_WINDOW_CONF = {"spark.rapids.sql.variableFloatAgg.enabled": True,
                    "spark.rapids.sql.cost.enabled": False,
                    "spark.rapids.sql.pipeline.enabled": False,
                    "spark.rapids.sql.stageFusion.enabled": False,
                    "spark.rapids.sql.shuffle.partitions": 1}


def _nonfinite_window_query(L, session, D, bad: float):
    """Partition k=1 holds (o=0, v=bad) and (o=1, v=1.0), partition k=2
    holds v = 2.0, 3.0, 4.0: the running sum and the current-row sum."""
    data = {"k": [1, 1, 2, 2, 2], "o": [0, 1, 0, 1, 2],
            "v": [bad, 1.0, 2.0, 3.0, 4.0]}
    df = session.create_dataframe(
        data, [("k", D.INT32), ("o", D.INT32), ("v", D.FLOAT64)],
        num_partitions=1)
    w = L.Window.partition_by("k").order_by("o")
    return df.with_column("run", L.agg_sum(L.col("v")).over(w)) \
        .with_column("cur",
                     L.agg_sum(L.col("v")).over(w.rows_between(0, 0))) \
        .order_by(L.col("k").asc(), L.col("o").asc())


@pytest.mark.parametrize("bad", ["inf", "nan"])
def test_nonfinite_window_sums_match_reference_on_both_engines(bad):
    """Both window halves take a frame's float sum as a difference of one
    prefix sum over the sorted batch, so a NaN or +inf reaches frames
    that do not hold it. Each engine of the port gives its reference
    engine's rows, bit for bit (repr). Spark gives the current-row sum
    1.0 at (k=1, o=1) and 2, 5, 9 / 2, 3, 4 in partition k=2."""
    value = float(bad)
    jdf = _nonfinite_window_query(JL, JSession(_REF_WINDOW_CONF), jdt,
                                  value)
    want_dev, want_host = jdf.collect(), jdf.collect_host()
    df = _nonfinite_window_query(TL, TpuSession(
        {"spark.rapids.sql.variableFloatAgg.enabled": True}, device="cpu"),
        tdt, value)
    assert repr(df.collect()) == repr(want_dev)
    assert repr(df.collect_host()) == repr(want_host)
    spark_k2 = [(2, 0, 2.0, 2.0, 2.0), (2, 1, 3.0, 5.0, 3.0),
                (2, 2, 4.0, 9.0, 4.0)]
    # The device halves scan the batch in partition-fingerprint order, in
    # which k=2 comes before k=1: its frames stay clean.
    assert want_dev[2:] == spark_k2
    # The row after the bad value: its current-row frame holds only 1.0.
    assert np.isnan(want_dev[1][4])
    if bad == "inf":
        # The host halves scan k=1 first: +inf - +inf poisons the next
        # row's frame and every frame of k=2.
        assert np.isnan(want_host[1][4])
        assert all(np.isnan(r[3]) and np.isnan(r[4])
                   for r in want_host[2:])
    else:
        # With a NaN the host halves drop to their per-frame oracle and
        # give Spark's answer.
        assert want_host[1][4] == 1.0 and want_host[2:] == spark_k2
