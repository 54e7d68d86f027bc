"""Port parity of the pandas-UDF execs (``ops/pandas_exec.py``:
``MapInPandasExec``, ``FlatMapGroupsInPandasExec``,
``CoGroupedMapInPandasExec``, ``AggregateInPandasExec``), their front end
(``map_in_pandas``, ``group_by(...).apply_in_pandas`` / ``agg_in_pandas``,
``cogroup(...).apply_in_pandas``) and ``to_pandas`` against the JAX
package's, on the CPU (pandas is installed here, and on the card's
machine, where ``chip_smoke.py`` phase 21 runs the four execs).

- Each flavor at ``shuffle.partitions`` 1 and 4, under the all-device conf
  and the default conf (which puts a float Sum below the map flavor on
  the host engine, bridged): the port's device half and host half give
  the reference's rows as a multiset, exactly (the float sums to the
  harness's ``approx_float``).
- The bounded worker pool, NULL keys colliding in a cogroup, the
  missing-declared-column error text, the conversions (pandas 3's ``str``
  dtype with missing values, dates as day numbers, integers with NULLs
  as object Series), the device the results upload to, and the two conf
  keys of the slice.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import threading
import time

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu import config as JC
from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.ops import pandas_exec as JP
from spark_rapids_tpu.plan import logical as JL

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost
from spark_rapids_tpu_torch.ops import (
    ExecContext, InMemorySourceExec, MapInPandasExec)
from spark_rapids_tpu_torch.ops import pandas_exec as TP
from spark_rapids_tpu_torch.ops.base import Exec
from spark_rapids_tpu_torch.plan import logical as L

from harness import assert_rows_equal
from test_torch_placement import REF_OFF

SCHEMA = (("g", "int64"), ("v", "double"), ("s", "string"), ("d", "date"))
ALL_DEVICE = {"spark.rapids.sql.variableFloatAgg.enabled": True}
CONFS = {"device": ALL_DEVICE, "default": {}}
WORDS = ["a", "bb", "ccc", "é"]


def _data(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"g": [None if k % 17 == 0 else int(x) for k, x in
                  enumerate(rng.integers(0, 9, n))],
            "v": np.round(rng.normal(size=n), 6).tolist(),
            "s": [None if k % 11 == 0 else WORDS[int(x)] for k, x in
                  enumerate(rng.integers(0, len(WORDS), n))],
            "d": [int(x) for x in rng.integers(9_000, 9_100, n)]}


def _sessions(conf: dict, partitions: int):
    conf = dict(conf, **{"spark.rapids.sql.shuffle.partitions": partitions})
    return JSession(dict(conf, **REF_OFF)), TpuSession(conf, device="cpu")


def _df(session, P, data, schema=SCHEMA, parts=3):
    return session.create_dataframe(
        data, [(n, P.type_named(t)) for n, t in schema],
        num_partitions=parts)


# ---------------------------------------------------------------------------
# The flavors. Each builder takes (session, dtypes module, logical module).
# ---------------------------------------------------------------------------

def doubler(frames):
    for pdf in frames:
        out = pdf.copy()
        out["v2"] = out.v * 2.0
        yield out[["g", "v2", "s"]]


def center(pdf):
    out = pdf.copy()
    out["v"] = out.v - out.v.mean()
    return out[["g", "v", "d"]]


def describe(pdf):
    return pd.DataFrame({"g": [pdf.g.iloc[0]], "s": [pdf.s.iloc[0]],
                         "n": [len(pdf)],
                         "label": [f"{pdf.s.iloc[0]}:{len(pdf)}"]})


def merge(lp, rp):
    g = lp.g.iloc[0] if len(lp) else rp.k.iloc[0]
    w = float(rp.w.iloc[0]) if len(rp) else -1.0
    return pd.DataFrame({"g": [g], "n": [len(lp)], "w": [w]})


def flavor_map(s, P, M, data):
    return _df(s, P, data).filter(M.col("v") > -1.5).map_in_pandas(
        doubler, [("g", P.INT64), ("v2", P.FLOAT64), ("s", P.STRING)])


def flavor_map_over_agg(s, P, M, data):
    agg = _df(s, P, data).group_by("g").agg(
        M.agg_sum(M.col("v")).alias("total"), M.agg_count().alias("n"))
    return agg.map_in_pandas(
        lambda frames: (f.assign(mean=f.total / f.n) for f in frames),
        [("g", P.INT64), ("total", P.FLOAT64), ("mean", P.FLOAT64)])


def flavor_apply(s, P, M, data):
    return _df(s, P, data).group_by("g").apply_in_pandas(
        center, [("g", P.INT64), ("v", P.FLOAT64), ("d", P.DATE)])


def flavor_apply_two_keys(s, P, M, data):
    return _df(s, P, data).group_by("g", "s").apply_in_pandas(
        describe, [("g", P.INT64), ("s", P.STRING), ("n", P.INT64),
                   ("label", P.STRING)])


def flavor_agg(s, P, M, data):
    return _df(s, P, data).group_by("g").agg_in_pandas(
        med=("v", lambda x: float(x.median()), P.FLOAT64),
        cnt=("v", lambda x: int(len(x)), P.INT64),
        first=("s", lambda x: x.dropna().min() if x.notna().any()
               else None, P.STRING))


def flavor_cogroup(s, P, M, data):
    right = _df(s, P, {"k": [0, 1, 2, 3, 42, None],
                       "w": [10.0, 20.0, 30.0, 40.0, 99.0, 5.0]},
                schema=(("k", "int64"), ("w", "double")), parts=2)
    return _df(s, P, data).group_by("g").cogroup(right.group_by("k")) \
        .apply_in_pandas(merge, [("g", P.INT64), ("n", P.INT64),
                                 ("w", P.FLOAT64)])


FLAVORS = {"map": flavor_map, "map_over_agg": flavor_map_over_agg,
           "apply": flavor_apply, "apply_two_keys": flavor_apply_two_keys,
           "agg": flavor_agg, "cogroup": flavor_cogroup}


def _key(r):
    return tuple((v is None, v if v is not None else 0) for v in r)


@pytest.mark.parametrize("conf", sorted(CONFS))
@pytest.mark.parametrize("partitions", [1, 4])
@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_flavor_matches_reference(flavor, partitions, conf):
    data = _data(150, 3)
    js, ts = _sessions(CONFS[conf], partitions)
    want = sorted(FLAVORS[flavor](js, jdt, JL, data).collect(), key=_key)
    q = FLAVORS[flavor](ts, tdt, L, data)
    phys = q._physical()
    hosted = ["LogicalAggregate"] if (flavor, conf) == (
        "map_over_agg", "default") else []
    assert phys.host_fallback_nodes() == hosted
    tree = phys.tree()
    assert ("ShuffleExchangeExec HashPartitioning" in tree) == \
        (flavor not in ("map",))
    assert len(want) > 0
    for rows in (q.collect(), q.collect_host()):
        assert_rows_equal(sorted(rows, key=_key), want,
                          approx_float=flavor == "map_over_agg",
                          msg=f"{flavor}/{partitions}/{conf}")


def test_worker_pool_is_bounded():
    s = TpuSession({"spark.rapids.python.concurrentPythonWorkers": 2},
                   device="cpu")
    active, peak, threads = [], [], set()
    lock = threading.Lock()

    def slow(pdf):
        with lock:
            active.append(1)
            peak.append(len(active))
            threads.add(threading.current_thread().name)
        time.sleep(0.02)
        with lock:
            active.pop()
        return pdf

    _df(s, tdt, _data(400, 1), parts=1).group_by("g").apply_in_pandas(
        slow, list((n, tdt.type_named(t)) for n, t in SCHEMA)).collect()
    assert max(peak) == 2
    assert all(t.startswith("pandas-udf") for t in threads)
    s.set("spark.rapids.python.concurrentPythonWorkers", 0)
    peak.clear()
    _df(s, tdt, _data(100, 1), parts=1).group_by("g").apply_in_pandas(
        slow, list((n, tdt.type_named(t)) for n, t in SCHEMA)).collect()
    assert max(peak) == 1


def test_cogroup_null_keys_collide():
    """Float-NaN group keys from the two cogrouped sides land in ONE
    cogrouped call (Spark null-key grouping): the reference's regression
    case, through both packages' device and host halves."""
    def frames(s, P):
        left = s.create_dataframe(
            {"k": [1.0, None, None, 2.0], "v": [10.0, 20.0, 30.0, 40.0]},
            [("k", P.FLOAT64), ("v", P.FLOAT64)])
        right = s.create_dataframe(
            {"k": [None, 3.0], "w": [100.0, 200.0]},
            [("k", P.FLOAT64), ("w", P.FLOAT64)])

        def counts(lpdf, rpdf):
            return pd.DataFrame({"nl": [float(len(lpdf))],
                                 "nr": [float(len(rpdf))]})
        return left.group_by("k").cogroup(right.group_by("k")) \
            .apply_in_pandas(counts, [("nl", P.FLOAT64), ("nr", P.FLOAT64)])
    js, ts = _sessions({}, 1)
    want = sorted(frames(js, jdt).collect())
    assert want == [(0.0, 1.0), (1.0, 0.0), (1.0, 0.0), (2.0, 1.0)]
    q = frames(ts, tdt)
    assert sorted(q.collect()) == want
    assert sorted(q.collect_host()) == want


def test_missing_declared_column_error_matches_reference():
    def build(s, P):
        return _df(s, P, _data(30, 2)).group_by("g").apply_in_pandas(
            lambda pdf: pdf[["g"]], [("g", P.INT64), ("nope", P.FLOAT64)])
    js, ts = _sessions({}, 1)
    with pytest.raises(ValueError) as want:
        build(js, jdt).collect()
    for run in ("collect", "collect_host"):
        with pytest.raises(ValueError) as got:
            getattr(build(ts, tdt), run)()
        assert str(got.value) == str(want.value)
        assert "missing declared column 'nope'" in str(got.value)


def test_pandas_to_batch_matches_reference():
    """User frames holding pandas 3's ``str`` dtype (missing values are
    NaN), NaN in integer and string columns, None in object columns, and
    numpy scalars: the same host batch through both packages."""
    pdf = pd.DataFrame({
        "s": pd.Series(["a", None, "é"], dtype="str"),
        "o": pd.Series(["x", None, float("nan")], dtype=object),
        "i": pd.Series([1.0, float("nan"), 3.0]),
        "f": pd.Series([0.5, float("nan"), None], dtype="float64"),
        "d": pd.Series([9000, 9001, 9002], dtype="int32")})
    schema = (("s", "string"), ("o", "string"), ("i", "int64"),
              ("f", "double"), ("d", "date"))
    want = JP.pandas_to_batch(pdf, tuple(
        (n, jdt.type_named(t)) for n, t in schema)).to_pylist()
    got = TP.pandas_to_batch(pdf, tuple(
        (n, tdt.type_named(t)) for n, t in schema)).to_pylist()
    assert repr(got) == repr(want)
    assert [r[0] for r in got] == ["a", None, "é"]
    assert [r[1] for r in got] == ["x", None, None]
    assert [r[2] for r in got] == [1, None, 3]


def test_batches_to_pandas_matches_reference():
    """Dates stay day numbers, integers with NULLs become object Series,
    float NULLs NaN, strings str; several batches concatenate."""
    schema = (("i", "int64"), ("j", "int32"), ("f", "double"),
              ("s", "string"), ("d", "date"))
    parts = [{"i": [1, None, 3], "j": [4, 5, 6], "f": [0.5, None, 2.0],
              "s": ["a", None, "é"], "d": [9000, None, 9002]},
             {"i": [7], "j": [8], "f": [1.0], "s": ["z"], "d": [1]}]
    names = [n for n, _ in schema]
    jh = [jhost.HostBatch.from_pydict(
        [(n, jdt.type_named(t)) for n, t in schema], p) for p in parts]
    th = [thost.HostBatch.from_pydict(
        [(n, tdt.type_named(t)) for n, t in schema], p) for p in parts]
    want = JP.batches_to_pandas(jh, names)
    got = TP.batches_to_pandas(th, names)
    pd.testing.assert_frame_equal(got, want)
    assert got["i"].dtype == object and got["d"].dtype == object
    assert got["j"].tolist() == [4, 5, 6, 8]
    empty = TP.batches_to_pandas([], names)
    pd.testing.assert_frame_equal(empty, JP.batches_to_pandas([], names))


def test_to_pandas_matches_reference():
    js, ts = _sessions(ALL_DEVICE, 1)
    data = _data(40, 9)
    want = _df(js, jdt, data).filter(JL.col("v") > 0.0).to_pandas()
    got = _df(ts, tdt, data).filter(L.col("v") > 0.0).to_pandas()
    pd.testing.assert_frame_equal(
        got.sort_values(list(got.columns), ignore_index=True),
        want.sort_values(list(want.columns), ignore_index=True))
    assert list(got.columns) == [n for n, _ in SCHEMA]


class _Deviceless(Exec):
    """A child that names no device."""

    @property
    def schema(self):
        return (("g", tdt.INT64),)


def test_results_upload_to_the_plan_device():
    """The device halves upload onto the device the plan's source names
    (here the CPU the test asked for); a plan naming none raises rather
    than picking one."""
    hb = thost.HostBatch.from_pydict([("g", tdt.INT64)], {"g": [1, 2, 3]})
    src = InMemorySourceExec((("g", tdt.INT64),), [[hb]], device="cpu")
    x = MapInPandasExec(src, lambda frames: frames, (("g", tdt.INT64),))
    out = list(x.execute_device(ExecContext(), 0))
    assert len(out) == 1 and out[0].columns[0].data.device.type == "cpu"
    assert out[0].device == src.device
    bare = MapInPandasExec(_Deviceless(), lambda f: f, (("g", tdt.INT64),))
    with pytest.raises(RuntimeError, match="names no device"):
        bare._upload(hb)


def test_conf_keys_match_reference():
    for ours, ref in ((C.CONCURRENT_PYTHON_WORKERS,
                       JC.CONCURRENT_PYTHON_WORKERS),
                      (C.UDF_COMPILER_ENABLED, JC.UDF_COMPILER_ENABLED)):
        assert (ours.key, ours.default) == (ref.key, ref.default)
