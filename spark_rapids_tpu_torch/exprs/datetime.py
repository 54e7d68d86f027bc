"""Date and time expressions (port of the JAX package's
``exprs/datetime.py``: its calendar arithmetic, the date parts ``Year``,
``Month``, ``DayOfMonth``, ``Quarter``, ``DayOfWeek`` (Sunday = 1),
``WeekDay`` (Monday = 0) and ``DayOfYear``, ``LastDay``, the time parts
``Hour``, ``Minute`` and ``Second``, ``TruncDate``, ``DateAdd``,
``DateSub``, ``DateDiff``, ``AddMonths``, ``TimeAdd``, ``TimeSub``,
``ToUnixTimestamp`` and ``FromUnixTime``).

DATE is days since the epoch (int32), TIMESTAMP UTC microseconds (int64),
Catalyst's encodings, so the calendar is integer arithmetic: the
days-from-civil algorithm (proleptic Gregorian) with no tables. Every
division is a floor division, so days before 1970 (negative) land in
the right year. A TIMESTAMP floor-divides to its day first.

Each function takes int64 torch tensors (the device half) or numpy
arrays (the host half); ``//`` and ``%`` floor on both, so one body
serves both halves. The zone is UTC only, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exprs.base import (
    BinaryExpression, Literal, UnaryExpression)

MICROS_PER_SEC = 1000 * 1000
MICROS_PER_DAY = 86400 * MICROS_PER_SEC


def _as(x, np_type):
    if isinstance(x, torch.Tensor):
        return x.to({np.int32: torch.int32, np.int64: torch.int64}[np_type])
    return np.asarray(x).astype(np_type)


def _where(cond, a, b):
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return np.where(cond, a, b)


def _ones(x):
    return x * 0 + 1


def _min(a, b):
    if isinstance(a, torch.Tensor):
        return torch.minimum(a, b)
    return np.minimum(a, b)


def civil_from_days(z):
    """days since the epoch -> (year, month, day), each int32."""
    z = _as(z, np.int64) + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + _where(mp < 10, 3, -9)
    y = y + _as(m <= 2, np.int64)
    return _as(y, np.int32), _as(m, np.int32), _as(d, np.int32)


def days_from_civil(y, m, d):
    """(year, month, day) -> days since the epoch, int32."""
    y = _as(y, np.int64) - _as(m <= 2, np.int64)
    era = y // 400
    yoe = y - era * 400
    mp = _as(_where(m > 2, m - 3, m + 9), np.int64)
    doy = (153 * mp + 2) // 5 + _as(d, np.int64) - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return _as(era * 146097 + doe - 719468, np.int32)


def _days_of(data, src: DataType):
    if src.name == "timestamp":
        return data // MICROS_PER_DAY
    return data


class _DatePart(UnaryExpression):
    def data_type(self) -> DataType:
        return dt.INT32

    def _part(self, y, m, d, days):
        raise NotImplementedError

    def do_columnar(self, data, validity, col):
        days = _days_of(data, self.child.data_type())
        y, m, d = civil_from_days(days)
        return self._part(y, m, d, days), validity

    # The same integer arithmetic over numpy arrays.
    do_host = do_columnar


class Year(_DatePart):
    def _part(self, y, m, d, days):
        return y


class Month(_DatePart):
    def _part(self, y, m, d, days):
        return m


class DayOfMonth(_DatePart):
    def _part(self, y, m, d, days):
        return d


class Quarter(_DatePart):
    def _part(self, y, m, d, days):
        return _as((m - 1) // 3, np.int32) + 1



class DayOfWeek(_DatePart):
    """Spark's dayofweek: Sunday = 1 ... Saturday = 7 (day 0 of the epoch
    was a Thursday)."""

    def _part(self, y, m, d, days):
        return _as((_as(days, np.int64) + 4) % 7 + 1, np.int32)


class WeekDay(_DatePart):
    """Spark's weekday: Monday = 0 ... Sunday = 6."""

    def _part(self, y, m, d, days):
        return _as((_as(days, np.int64) + 3) % 7, np.int32)


class DayOfYear(_DatePart):
    def _part(self, y, m, d, days):
        jan1 = days_from_civil(y, _ones(m), _ones(d))
        return _as(days - jan1 + 1, np.int32)


class LastDay(UnaryExpression):
    """The last day of the date's month."""

    def data_type(self) -> DataType:
        return dt.DATE

    def do_columnar(self, data, validity, col):
        days = _days_of(data, self.child.data_type())
        y, m, d = civil_from_days(days)
        ny = _where(m == 12, y + 1, y)
        nm = _where(m == 12, _ones(m), m + 1)
        return days_from_civil(ny, nm, _ones(d)) - 1, validity

    do_host = do_columnar


class _TimePart(UnaryExpression):
    """A part of a TIMESTAMP's time of day (floor arithmetic: before 1970
    too)."""

    def data_type(self) -> DataType:
        return dt.INT32

    def _part(self, secs):
        raise NotImplementedError

    def do_columnar(self, data, validity, col):
        secs = (data % MICROS_PER_DAY) // MICROS_PER_SEC
        return _as(self._part(secs), np.int32), validity

    do_host = do_columnar


class Hour(_TimePart):
    def _part(self, secs):
        return secs // 3600


class Minute(_TimePart):
    def _part(self, secs):
        return (secs // 60) % 60


class Second(_TimePart):
    def _part(self, secs):
        return secs % 60


class TruncDate(UnaryExpression):
    """trunc(date, fmt) for fmt in year / yyyy / yy, quarter, month / mon /
    mm and week (Monday first); an unknown format gives NULL."""

    _FMT = {"year": "year", "yyyy": "year", "yy": "year",
            "quarter": "quarter",
            "month": "month", "mon": "month", "mm": "month",
            "week": "week"}

    def __init__(self, child, fmt):
        super().__init__(child)
        if isinstance(fmt, Literal):
            fmt = fmt.value
        if isinstance(fmt, bytes):
            fmt = fmt.decode()
        self.fmt = self._FMT.get(str(fmt).lower())

    def data_type(self) -> DataType:
        return dt.DATE

    def do_columnar(self, data, validity, col):
        days = _days_of(data, self.child.data_type())
        if self.fmt is None:
            return _as(days, np.int32), validity & False
        if self.fmt == "week":
            dow = (_as(days, np.int64) + 3) % 7
            return _as(days - dow, np.int32), validity
        y, m, d = civil_from_days(days)
        if self.fmt == "year":
            m = _ones(m)
        elif self.fmt == "quarter":
            m = _as((m - 1) // 3 * 3 + 1, np.int32)
        return days_from_civil(y, m, _ones(d)), validity

    do_host = do_columnar


class _DateArith(BinaryExpression):
    """Integer arithmetic on the raw encodings: ``_out`` is the result
    type, the operands convert to its width first."""

    _out = dt.DATE

    def data_type(self) -> DataType:
        return self._out

    def _op(self, a, b):
        return a + b

    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        t = self._out.np_dtype.type
        with np.errstate(all="ignore"):
            return self._op(_as(l_data, t), _as(r_data, t)), \
                l_valid & r_valid

    do_host = do_columnar


class DateAdd(_DateArith):
    """date_add(date, n days)."""


class DateSub(_DateArith):
    def _op(self, a, b):
        return a - b


class DateDiff(DateSub):
    """datediff(end, start) in days."""

    _out = dt.INT32


class TimeAdd(_DateArith):
    """timestamp + an interval in microseconds (the right child evaluates
    to int64 microseconds, as in the reference)."""

    _out = dt.TIMESTAMP


class TimeSub(TimeAdd):
    def _op(self, a, b):
        return a - b


class AddMonths(BinaryExpression):
    """add_months(date, n): the day clamps to the target month's end."""

    def data_type(self) -> DataType:
        return dt.DATE

    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        y, m, d = civil_from_days(l_data)
        months = _as(y, np.int64) * 12 + (m - 1) + _as(r_data, np.int64)
        ny = _as(months // 12, np.int32)
        nm = _as(months % 12, np.int32) + 1
        nny = _where(nm == 12, ny + 1, ny)
        nnm = _where(nm == 12, _ones(nm), nm + 1)
        last = days_from_civil(nny, nnm, _ones(nm)) - \
            days_from_civil(ny, nm, _ones(nm))
        nd = _min(d, _as(last, np.int32))
        return days_from_civil(ny, nm, nd), l_valid & r_valid

    do_host = do_columnar


class ToUnixTimestamp(UnaryExpression):
    """Seconds since the epoch of a TIMESTAMP or DATE."""

    def data_type(self) -> DataType:
        return dt.INT64

    def do_columnar(self, data, validity, col):
        if self.child.data_type().name == "date":
            return _as(data, np.int64) * 86400, validity
        return data // MICROS_PER_SEC, validity

    do_host = do_columnar


UnixTimestamp = ToUnixTimestamp


class FromUnixTime(UnaryExpression):
    """Seconds since the epoch -> TIMESTAMP."""

    def data_type(self) -> DataType:
        return dt.TIMESTAMP

    def do_columnar(self, data, validity, col):
        with np.errstate(all="ignore"):
            return _as(data, np.int64) * MICROS_PER_SEC, validity

    do_host = do_columnar
