"""Date parts (port of the JAX package's ``exprs/datetime.py``, its
calendar arithmetic and ``Year``, ``Month``, ``DayOfMonth`` and
``Quarter``).

DATE is days since the epoch (int32), TIMESTAMP UTC microseconds (int64),
Catalyst's encodings, so the calendar is integer arithmetic: the
days-from-civil algorithm (proleptic Gregorian) with no tables. Every
division is a floor division, so days before 1970 (negative) land in
the right year. A TIMESTAMP floor-divides to its day first.

Each function takes int64 torch tensors (the device half) or numpy
arrays (the host half); ``//`` floors on both.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exprs.base import UnaryExpression

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

