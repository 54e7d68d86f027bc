"""Port parity of the rest of the date-time expressions: DayOfWeek
(Sunday = 1), WeekDay (Monday = 0), DayOfYear, LastDay, Hour, Minute,
Second, TruncDate (every format and an unknown one), DateAdd, DateSub,
DateDiff, AddMonths, TimeAdd, TimeSub, ToUnixTimestamp and FromUnixTime
against the JAX package's classes on the CPU, on both engines, bit for
bit (data under NULL and dead rows too, and validity).

The inputs hold the reference's edge values (``tests/test_exprs.py``
TestDatetime and TestTruncDate: 1970-01-01, 2000-02-29, 2020-12-31,
1969-12-31), dates before 1970 down to year 0, leap days, month ends,
negative timestamps (one microsecond and one day before the epoch) and
far ones, INT32 day counts that wrap, NULLs and a dead tail. The
floor division and modulo of negative days and microseconds are those
of the reference's ``_fdiv``.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import datetime as pydt

import numpy as np
import pytest

from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu.columnar import dtypes as jdt

from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch.columnar import dtypes as tdt

from test_torch_math import (
    JAX, PORT, assert_same, device_batch, eval_both, host_batch)

CAP = 160
LIVE = 151
EPOCH = pydt.date(1970, 1, 1)


def _days(y, m, d):
    return (pydt.date(y, m, d) - EPOCH).days


DAY_EDGES = [0, 11016, 18627, -1, _days(2020, 7, 17), _days(2019, 2, 28),
             _days(1900, 3, 1), _days(1900, 2, 28), _days(1600, 2, 29),
             _days(1, 1, 1), -719468, _days(1969, 1, 31), _days(1968, 2, 29),
             _days(2024, 1, 31), _days(2023, 12, 31), _days(1999, 10, 31),
             _days(9999, 12, 31), -25508, 2932896, -100000]
TS_EDGES = [0, -1, 1, -86_400_000_000, -86_400_000_001, 86_399_999_999,
            3600_000_000 * 5 + 60_000_000 * 7 + 9_000_000, -1_000_000,
            -62_135_596_800_000_000, 253_402_300_799_999_999,
            -3600_000_001, 1_700_000_000_123_456]
N_EDGES = [1, 12, -1, -12, 0, 13, 30, -30, 24, -25, 2 ** 31 - 1,
           -2 ** 31, 1000, 7, 11, 2, -13, 35, 120, -1200]


def _columns(seed: int):
    rng = np.random.default_rng(seed)

    def fill(edges, rand, dtype):
        data = np.asarray(rand, dtype)
        data[:len(edges)] = np.asarray(edges, dtype)
        valid = rng.random(CAP) < 0.85
        valid[:len(edges)] = True
        return data, valid

    return [
        ("d", "date") + fill(DAY_EDGES, rng.integers(-800_000, 800_000, CAP),
                             np.int32),
        ("e", "date") + fill(list(reversed(DAY_EDGES)),
                             rng.integers(-30_000, 30_000, CAP), np.int32),
        ("ts", "timestamp") + fill(TS_EDGES,
                                   rng.integers(-10 ** 17, 10 ** 17, CAP),
                                   np.int64),
        ("n", "int32") + fill(N_EDGES, rng.integers(-500, 500, CAP),
                              np.int32),
        ("secs", "int64") + fill([0, -1, 1, 86399, -86401, 2 ** 40,
                                  -(2 ** 40)],
                                 rng.integers(-4 * 10 ** 9, 4 * 10 ** 9, CAP),
                                 np.int64),
        ("us", "int64") + fill([0, -1, 86_400_000_000, -86_400_000_001],
                               rng.integers(-10 ** 12, 10 ** 12, CAP),
                               np.int64),
    ]


SCHEMA = tuple((n, t) for n, t, _d, _v in _columns(0))


def _tree(name, *args):
    def build(P):
        M = JE if P == JAX else TE
        D = jdt if P == JAX else tdt
        R = {n: M.BoundReference(i, D.type_named(t), n)
             for i, (n, t) in enumerate(SCHEMA)}
        return getattr(M, name)(*[R[a] if a in R else a for a in args])
    return build


def _cases():
    cases = {}
    for name in ("DayOfWeek", "WeekDay", "DayOfYear", "LastDay",
                 "ToUnixTimestamp", "Year", "Quarter"):
        for c in ("d", "ts"):
            cases[f"{name}[{c}]"] = _tree(name, c)
    for name in ("Hour", "Minute", "Second"):
        cases[f"{name}[ts]"] = _tree(name, "ts")
    for fmt in ("year", "yyyy", "yy", "YEAR", "quarter", "month", "mon",
                "mm", "MM", "week", "bogus", "dd"):
        for c in ("d", "ts"):
            cases[f"TruncDate[{c},{fmt}]"] = _tree("TruncDate", c, fmt)
    for name in ("DateAdd", "DateSub", "AddMonths"):
        cases[f"{name}[d,n]"] = _tree(name, "d", "n")
        cases[f"{name}[e,n]"] = _tree(name, "e", "n")
    cases["DateDiff[d,e]"] = _tree("DateDiff", "d", "e")
    cases["DateDiff[e,d]"] = _tree("DateDiff", "e", "d")
    for name in ("TimeAdd", "TimeSub"):
        cases[f"{name}[ts,us]"] = _tree(name, "ts", "us")
    cases["FromUnixTime[secs]"] = _tree("FromUnixTime", "secs")
    cases["FromUnixTime[n]"] = _tree("FromUnixTime", "n")
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def batches():
    dcols, hcols = _columns(0), _columns(1)
    return ({P: device_batch(P, dcols, LIVE) for P in (JAX, PORT)},
            {P: host_batch(P, hcols) for P in (JAX, PORT)})


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_reference(case, engine, batches):
    got, want = eval_both(CASES[case], batches, engine)
    assert_same(*got, *want)


# ---------------------------------------------------------------------------
# Pinned answers (the reference's own expectations)
# ---------------------------------------------------------------------------

def _port(name, engine, cols, *extra):
    """The port's ``name`` over (type, values) columns (all valid) on one
    engine -> values list."""
    tcols = [(f"c{i}", t, np.asarray(v, tdt.type_named(t).np_dtype),
              np.ones(len(v), np.bool_)) for i, (t, v) in enumerate(cols)]
    refs = [TE.BoundReference(i, tdt.type_named(t), f"c{i}")
            for i, (t, _v) in enumerate(cols)]
    e = getattr(TE, name)(*refs, *extra)
    if engine == "host":
        hb = host_batch(PORT, tcols)
        c = e.eval_host(hb)
        return np.asarray(c.data).tolist(), np.asarray(c.validity).tolist()
    tb = device_batch(PORT, tcols, live=len(cols[0][1]))
    c = e.eval(tb)
    return c.data.numpy().tolist(), c.validity.numpy().tolist()


@pytest.mark.parametrize("engine", ["device", "host"])
def test_reference_expectations(engine):
    dates = ("date", [0, 11016, 18627, -1])
    assert _port("DayOfWeek", engine, [dates])[0] == [5, 3, 5, 4]
    assert _port("WeekDay", engine, [dates])[0] == [3, 1, 3, 2]
    assert _port("DayOfYear", engine, [dates])[0] == [1, 60, 366, 365]
    assert _port("LastDay", engine, [dates])[0] == [30, 11016, 18627, -1]
    got = _port("AddMonths", engine, [("date", [0, 11016, _days(2024, 1, 31)]),
                                      ("int32", [1, 12, 1])])[0]
    assert got == [31, 11016 + 365, _days(2024, 2, 29)]
    ts = ("timestamp", [3600_000_000 * 5 + 60_000_000 * 7 + 9_000_000,
                        -1_000_000])
    assert [_port(n, engine, [ts])[0] for n in ("Hour", "Minute",
                                                "Second")] == \
        [[5, 23], [7, 59], [9, 59]]
    d = ("date", [_days(2020, 7, 17), _days(2019, 2, 28)])
    for fmt, want in (("year", [_days(2020, 1, 1), _days(2019, 1, 1)]),
                      ("month", [_days(2020, 7, 1), _days(2019, 2, 1)]),
                      ("quarter", [_days(2020, 7, 1), _days(2019, 1, 1)]),
                      ("week", [_days(2020, 7, 13), _days(2019, 2, 25)])):
        assert _port("TruncDate", engine, [d], fmt)[0] == want
    assert _port("TruncDate", engine, [d], "bogus") == ([0, 0],
                                                        [False, False])
    assert _port("ToUnixTimestamp", engine, [("timestamp", [-1, 1_999_999])
                                             ])[0] == [-1, 1]
    assert _port("DateDiff", engine, [("date", [100, -5]),
                                      ("date", [0, 10])])[0] == [100, -15]
