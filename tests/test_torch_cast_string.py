"""Port parity of casts to and from strings (``exprs/cast.py``: the
reference's host format and parse, a counted roundtrip on the device
half) against the JAX package on the CPU, bit for bit on both engines,
and the planner's float <-> string gates.

Each source type's column holds its edge values (``INT64_MIN``, ``-0.0``,
NaN, +-Inf, 1e7, 1e16, float32, pre-1970 dates and timestamps, NULLs, a
dead tail on the device); each string column holds parsable and
unparsable text. The reference's parse is Python's ``int`` / ``float``,
so it accepts ``"1_000"``, ``"1_0.5"`` and non-ASCII digits (``"١٢"``)
where Spark gives NULL, and its float format switches to an exponent at
1e16 where Java's does at 1e7: ``test_reference_quirks_pinned`` pins
each (ROADMAP queue C: noted, not a fault of the port).
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import numpy as np
import pytest

import jax.numpy as jnp

from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost

from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost
from spark_rapids_tpu_torch.plan import logical as L

CAP = 48

VALUES = {
    "int8": [0, -1, 127, -128, 42],
    "int16": [0, -32768, 32767, 7],
    "int32": [0, -42, 2147483647, -2147483648, 10],
    "int64": [0, -1, 2 ** 63 - 1, -2 ** 63, 123456789012],
    "float64": [0.0, -0.0, float("nan"), float("inf"), float("-inf"), 1e7,
                9999999.0, 1e16, 1e15, 1.5, 1 / 3, 5e-324, 1e300, -2.5e-7,
                123456.78, 100.0],
    "float32": [0.1, 1e7, float("nan"), -0.0, 3.4e38, 1.5, 1e-45, 16.25],
    "date": [0, -1, -719162, 18321, 2932896, -25567, 11016],
    "timestamp": [0, -1, 1, 1_500_000, -86_400_000_001, 1_600_000_000_123_456,
                  -2_208_988_800_000_000],
    "boolean": [True, False],
}

STRINGS = [
    "42", " 7 ", "-0", "+5", "007", "abc", "", "   ", "99999999999",
    "9223372036854775807", "9223372036854775808", "-9223372036854775808",
    "127", "128", "-129", "32768", "1.5", "NaN", "nan", "-Infinity", "inf",
    "+Infinity", "1e5", "1E-5", ".5", "1.2.3", "-", "+", "1e999", "1_000",
    "1_0.5", "١٢", " 5 ", "1970-01-01", "1969-12-31", "2020-02-29",
    "2021-02-29", "2021-02-30", "2021-13-01", "2021-1-5", "2021", "0000-01-01",
    "99999-01-01", "1970-01-01 00:00:01", "2021-06-01T12:30:00.5", "t",
    "true", "Yes", "N", "0", "1", "bad", "2020-02-29x",
]

TARGETS = ["int8", "int16", "int32", "int64", "float32", "float64", "date",
           "timestamp", "boolean"]


def _fixed(t: str, seed: int = 0):
    """(data, validity) of CAP rows of type ``t``: its edge values, then
    random draws, with NULLs."""
    rng = np.random.default_rng(seed)
    vals = VALUES[t]
    npt = tdt.type_named(t).np_dtype
    data = np.array(vals + [vals[i] for i in rng.integers(
        0, len(vals), CAP - len(vals))], npt)
    valid = np.ones(CAP, np.bool_)
    valid[rng.choice(np.arange(len(vals), CAP), 4, replace=False)] = False
    return np.where(valid, data, np.zeros(1, npt)), valid


def _strings(seed: int = 0):
    rng = np.random.default_rng(seed)
    vals = STRINGS + [STRINGS[i] for i in rng.integers(
        0, len(STRINGS), max(CAP - len(STRINGS), 0))]
    vals = vals[:max(CAP, len(STRINGS))]
    n = len(vals)
    w = max(len(v.encode()) for v in vals)
    data = np.zeros((n, w), np.uint8)
    lens = np.zeros(n, np.int32)
    for i, v in enumerate(vals):
        b = v.encode()
        data[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    valid = np.ones(n, np.bool_)
    valid[-3:] = False
    data[~valid] = 0
    return data, np.where(valid, lens, 0).astype(np.int32), valid


def _both(t, data, valid, lengths=None, live=None):
    """The column as a device batch (a dead tail of 5 rows) and a host
    batch, in both packages."""
    n = len(valid)
    cap = n + 5
    pad = ((0, 5),) + ((0, 0),) * (data.ndim - 1)
    d = np.pad(data, pad)
    v = np.pad(valid, (0, 5))
    ln = None if lengths is None else np.pad(lengths, (0, 5))
    jb = jbatch.DeviceBatch((jbatch.DeviceColumn(
        jdt.type_named(t), jnp.asarray(d), jnp.asarray(v),
        None if ln is None else jnp.asarray(ln)),), jnp.asarray(n, jnp.int32))
    tb = thost.from_jax_batch_arrays([tdt.type_named(t)], [(d, v, ln)], n,
                                     device="cpu")
    assert tb.capacity == cap
    if lengths is None:
        jh = jhost.HostBatch(("c",), [jhost.HostColumn(
            jdt.type_named(t), data.copy(), valid.copy())])
        th = thost.HostBatch(("c",), [thost.HostColumn(
            tdt.type_named(t), data.copy(), valid.copy())])
    else:
        jh = jhost.HostBatch(("c",), [jhost.HostColumn(
            jdt.STRING, None, valid.copy(), str_matrix=data.copy(),
            str_lengths=lengths.copy())])
        th = thost.HostBatch(("c",), [thost.HostColumn(
            tdt.STRING, None, valid.copy(), str_matrix=data.copy(),
            str_lengths=lengths.copy())])
    return jb, tb, jh, th


def _rows(col):
    v = np.asarray(col.validity, np.bool_)
    if col.dtype.is_string:
        return v.tolist(), [bytes(b) if ok else None
                            for b, ok in zip(col.data, v)]
    return v.tolist(), [np.asarray(col.data)[i].tobytes() if ok else None
                        for i, ok in enumerate(v)]


def _check(src, to, data, valid, lengths=None):
    jb, tb, jh, th = _both(src, data, valid, lengths)
    je = JE.Cast(JE.BoundReference(0, jdt.type_named(src)),
                 jdt.type_named(to))
    te = TE.Cast(TE.BoundReference(0, tdt.type_named(src)),
                 tdt.type_named(to))
    jc, tc = je.eval(jb), te.eval(tb)
    want, got = np.asarray(jc.data), tc.data.numpy()
    assert want.shape == got.shape and want.dtype == got.dtype
    assert want.tobytes() == got.tobytes()
    np.testing.assert_array_equal(np.asarray(jc.validity),
                                  tc.validity.numpy())
    if jc.lengths is not None:
        np.testing.assert_array_equal(np.asarray(jc.lengths),
                                      tc.lengths.numpy())
    assert _rows(te.eval_host(th)) == _rows(je.eval_host(jh))
    return te.eval_host(th)


@pytest.mark.parametrize("src", sorted(VALUES))
def test_cast_to_string_matches_reference(src):
    data, valid = _fixed(src)
    out = _check(src, "string", data, valid)
    assert all(out.data[i] for i in range(CAP) if valid[i])


def test_dates_outside_years_0_9999_match_reference():
    """numpy writes year -1 as '-001' and year 10000 with five digits:
    a column holding such a date is formatted row by row, as the
    reference's numpy formatter writes it."""
    data = np.array([-719529, -719893, 2932897, 0, -719528, 2932896,
                     -1000000, 5000000], np.int32)
    valid = np.ones(len(data), np.bool_)
    valid[3] = False
    data[3] = 0
    out = _check("date", "string", data, valid)
    assert out.data[0] == b"-001-12-31" and out.data[2] == b"10000-01-01"


@pytest.mark.parametrize("to", TARGETS)
def test_cast_from_string_matches_reference(to):
    data, lengths, valid = _strings()
    out = _check("string", to, data, valid, lengths)
    v = np.asarray(out.validity)
    assert v.any() and not v.all()


@pytest.mark.parametrize("src", ["int64", "int32", "float64", "float32",
                                 "date", "timestamp", "boolean"])
def test_round_trip(src):
    """Formatting then parsing gives the value back (floats bit for bit,
    NaN and -0.0 included) on both engines."""
    data, valid = _fixed(src, 1)
    _jb, tb, _jh, th = _both(src, data, valid)
    t = tdt.type_named(src)
    e = TE.Cast(TE.Cast(TE.BoundReference(0, t), tdt.STRING), t)
    dev = e.eval(tb)
    host = e.eval_host(th)
    np.testing.assert_array_equal(dev.validity.numpy()[:CAP], valid)
    np.testing.assert_array_equal(np.asarray(host.validity), valid)
    assert dev.data.numpy()[:CAP].tobytes() == data.tobytes()
    assert np.asarray(host.data).tobytes() == data.tobytes()


def test_reference_quirks_pinned():
    """Where the reference is not Spark, the port equals the reference:
    ``int`` / ``float`` accept underscores and non-ASCII digits, and the
    float format moves to an exponent at 1e16, not Java's 1e7."""
    vals = ["1_000", "1_0.5", "١٢"]
    data = np.zeros((3, 8), np.uint8)
    for i, v in enumerate(vals):
        b = v.encode()
        data[i, :len(b)] = np.frombuffer(b, np.uint8)
    lens = np.array([len(v.encode()) for v in vals], np.int32)
    valid = np.ones(3, np.bool_)
    ints = _check("string", "int64", data, valid, lens)
    assert np.asarray(ints.data).tolist() == [1000, 0, 12]
    assert np.asarray(ints.validity).tolist() == [True, False, True]
    floats = _check("string", "float64", data, valid, lens)
    assert np.asarray(floats.data).tolist() == [1000.0, 10.5, 12.0]
    f = np.array([1e7, 1e15, 1e16, 1.5e-7], np.float64)
    out = _check("float64", "string", f, np.ones(4, np.bool_))
    assert list(out.data) == [b"10000000.0", b"1000000000000000.0",
                              b"1.0E16", b"1.5E-7"]


@pytest.mark.parametrize("conf,hosted", [
    ({}, True),
    ({"spark.rapids.sql.castFloatToString.enabled": True}, False)])
def test_float_to_string_gate(conf, hosted):
    s = TpuSession(conf, device="cpu")
    df = s.create_dataframe({"x": [1.5, None, 1e16]},
                            [("x", tdt.FLOAT64)]).select(
        L.col("x").cast("string").alias("s"))
    phys = df._physical()
    assert (phys.host_fallback_nodes() == ["LogicalProject"]) == hosted
    assert "castFloatToString" in phys.explain() or not hosted
    assert df.collect() == [("1.5",), (None,), ("1.0E16",)]


@pytest.mark.parametrize("to,hosted", [("double", True), ("float", True),
                                       ("long", False), ("date", False)])
def test_string_to_float_gate(to, hosted):
    s = TpuSession(device="cpu")
    df = s.create_dataframe({"s": ["2012", "x", None]},
                            [("s", tdt.STRING)]).select(
        L.col("s").cast(to).alias("v"))
    phys = df._physical()
    assert (phys.host_fallback_nodes() == ["LogicalProject"]) == hosted
    if hosted:
        assert "castStringToFloat" in phys.explain()
    assert [r[0] is None for r in df.collect()] == [False, True, True]
