"""Cast (port of the JAX package's ``exprs/cast.py``: ``Cast``,
``_cast_fixed`` and the string side, ``_format_value``,
``_parse_value`` and ``_cast_string_host``; its vectorized
``_format_column`` becomes ``_format_matrix``).

Spark's cast matrix over the fixed-width types, ANSI off:

- numeric widening and narrowing wrap like the JVM; int <-> float
  convert; any type -> bool is ``x != 0``; bool -> numeric is 0 or 1;
- float -> integral truncates toward zero, NaN gives 0, and the value
  saturates at Int's range (Long's for a long target), then narrows by
  wrapping for byte and short (Scala's ``x.toInt.toByte``);
- timestamp -> date floors to days, date -> timestamp is midnight UTC;
  timestamp -> integral is whole seconds (floored), -> float the exact
  seconds; numeric -> timestamp is seconds (NaN and infinities give
  NULL), numeric -> date keeps the day number.

A cast to or from a string is the reference's host-side format or parse,
on both engines: the device half is a counted host roundtrip
(``exprs.base.host_roundtrip``, kind ``cast``). Formatting: booleans
``true`` / ``false``, integers in decimal, dates ``YYYY-MM-DD``, floats as
Python's ``repr`` with Java's ``E`` exponent and ``NaN`` /
``Infinity`` (the reference's format: it switches to an exponent at
1e16 where Java does at 1e7, hence the planner's
``castFloatToString`` gate), timestamps ``YYYY-MM-DD HH:MM:SS[.f]``.
Parsing trims the string, then: booleans from t/true/y/yes/1 and
f/false/n/no/0, integers with Python's ``int`` (out of the type's
range: NULL), floats with Python's ``float`` (``castStringToFloat``
gate), dates ``yyyy[-m[-d]]``, timestamps through ``numpy.datetime64``;
anything else is NULL. Python's ``int`` and ``float`` accept ``"1_000"``
and non-ASCII digits, as the reference does (Spark gives NULL). Strings
of plain ASCII digits (and a sign), plain ``yyyy-mm-dd`` dates and
float literals parse, and booleans, integers, floats and dates of years
0-9999 format, on vectorized paths with the same results (the reference
formats the first three vectorized, floats row by row).

The device half runs torch, the host half numpy. The JAX package's
device engine (XLA:CPU) reads a subnormal float operand as a zero of its
sign; the device half here flushes float inputs the same way, the host
half (numpy, as the reference's host engine) does not.
"""

from __future__ import annotations

import re
import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import flush_subnormal, torch_dtype
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.columnar.host import (
    HostColumn, strings_to_matrix)
from spark_rapids_tpu_torch.exprs.base import (
    Expression, UnaryExpression, as_device_column, as_host_column,
    host_roundtrip, make_column, make_host_column)

_LONG_MIN = -(2 ** 63)
_LONG_MAX = 2 ** 63 - 1
MICROS_PER_DAY = 86400 * 1000 * 1000


class Cast(UnaryExpression):
    """``cast(child as to)``; a string on either side goes through the
    host format or parse on both engines."""

    def __init__(self, child: Expression, to: DataType):
        super().__init__(child)
        self.to = to

    def data_type(self) -> DataType:
        return self.to

    @property
    def self_jittable(self) -> bool:
        # The string side parses or formats on the host (a CPU island).
        return not (self.child.data_type().is_string or self.to.is_string) \
            or self.child.data_type() == self.to

    def eval(self, batch):
        col = as_device_column(self.child.eval(batch), batch)
        src = self.child.data_type()
        if src == self.to:
            return col
        if src.is_string or self.to.is_string:
            return host_roundtrip("cast", col, batch, lambda hc: (
                _cast_string_host(hc, src, self.to)))
        data = col.data
        if src.is_floating:
            data = flush_subnormal(data)
        data, validity = _cast_fixed(_TORCH, data, col.validity, src,
                                     self.to)
        return make_column(self.to, data, validity)

    def eval_host(self, batch):
        col = as_host_column(self.child.eval_host(batch), batch)
        src = self.child.data_type()
        if src == self.to:
            return col
        if src.is_string or self.to.is_string:
            return _cast_string_host(col, src, self.to)
        with np.errstate(all="ignore"):
            data, validity = _cast_fixed(_NUMPY, np.asarray(col.data),
                                         np.asarray(col.validity, np.bool_),
                                         src, self.to)
        return make_host_column(self.to, data, validity)


class _Ops:
    """The few array operations ``_cast_fixed`` needs, for torch (the
    device half) or numpy (the host half)."""

    def __init__(self, lib):
        self.lib = lib

    def astype(self, x, t: DataType):
        if self.lib is torch:
            return x.to(torch_dtype(t))
        return x.astype(t.np_dtype)

    def f64(self, x):
        return x.to(torch.float64) if self.lib is torch \
            else x.astype(np.float64)

    def i64(self, x):
        return x.to(torch.int64) if self.lib is torch \
            else x.astype(np.int64)

    def float_to_int(self, x, t: DataType):
        """Float -> integer conversion as each engine of the reference
        converts: XLA's on the device (NaN gives 0, out-of-range values
        saturate), numpy's on the host."""
        if self.lib is not torch:
            return x.astype(t.np_dtype)
        info = torch.iinfo(torch_dtype(t))
        x = x.to(torch.float64)
        out = torch.clamp(x, min=float(info.min)).nan_to_num(0.0) \
            .to(torch_dtype(t))
        return torch.where(x >= float(info.max),
                           torch.full_like(out, info.max), out)

    def true_div(self, x, d: float):
        """``x / d`` rounded once: torch's CUDA division by a python
        scalar multiplies by its reciprocal, so the divisor goes as a 0-d
        tensor."""
        if self.lib is torch:
            return x / torch.full((), d, dtype=x.dtype, device=x.device)
        return x / d

    def full_like(self, x, value):
        if self.lib is torch:
            return torch.full_like(x, value)
        return np.full_like(x, value)

    def where(self, c, a, b):
        return self.lib.where(c, a, b)

    def floor_divide(self, a, b: int):
        return self.lib.floor_divide(a, b)

    def isnan(self, x):
        return self.lib.isnan(x)

    def isfinite(self, x):
        return self.lib.isfinite(x)

    def trunc(self, x):
        return self.lib.trunc(x)


_TORCH = _Ops(torch)
_NUMPY = _Ops(np)


def _cast_fixed(ops: _Ops, data, validity, src: DataType, to: DataType):
    """Fixed-width -> fixed-width cast on raw arrays."""
    if to.is_boolean:
        return data != 0, validity
    if src.is_boolean:
        return ops.astype(data, to), validity
    if src.name == "timestamp" and to.name == "date":
        return ops.astype(ops.floor_divide(data, MICROS_PER_DAY), to), \
            validity
    if src.name == "date" and to.name == "timestamp":
        return ops.i64(data) * MICROS_PER_DAY, validity
    if src.is_datetime and to.is_numeric:
        if src.name == "timestamp":
            # timestamp->long = seconds; ->int/short/byte narrows from that.
            if to.is_floating:
                return ops.astype(ops.true_div(ops.f64(data), 1e6), to), \
                    validity
            return ops.astype(ops.floor_divide(data, 1000 * 1000), to), \
                validity
        return ops.astype(data, to), validity
    if src.is_numeric and to.name == "timestamp":
        if src.is_floating:
            x = ops.f64(data)
            finite = ops.isfinite(x)
            safe = ops.where(finite, x, ops.full_like(x, 0.0))
            # Spark returns NULL for NaN/Infinity -> timestamp.
            return ops.float_to_int(safe * 1e6, to), validity & finite
        return ops.i64(data) * 1000 * 1000, validity
    if src.is_numeric and to.name == "date":
        if src.is_floating:
            return ops.float_to_int(data, to), validity
        return ops.astype(data, to), validity
    if src.is_floating and to.is_integral:
        # JVM d2i/d2l: truncate toward zero, NaN -> 0, saturate at the
        # intermediate type's range, then wrap-narrow.
        x = ops.f64(data)
        x = ops.where(ops.isnan(x), ops.full_like(x, 0.0), x)
        if to.name == "int64":
            lo, hi = float(_LONG_MIN), float(_LONG_MAX)
            lo_i, hi_i = _LONG_MIN, _LONG_MAX
        else:
            lo_i, hi_i = -(2 ** 31), 2 ** 31 - 1
            lo, hi = float(lo_i), float(hi_i)
        too_big = x >= hi
        too_small = x <= lo
        safe = ops.where(too_big | too_small, ops.full_like(x, 0.0), x)
        longs = ops.i64(ops.trunc(safe))
        longs = ops.where(too_big, ops.full_like(longs, hi_i), longs)
        longs = ops.where(too_small, ops.full_like(longs, lo_i), longs)
        return ops.astype(longs, to), validity
    # numeric widening/narrowing (wrap-around like the JVM) & int<->float.
    return ops.astype(data, to), validity



# ---------------------------------------------------------------------------
# The string side: the reference's host format and parse
# ---------------------------------------------------------------------------

def _format_float(f: float) -> bytes:
    """A float as the reference formats it: ``repr`` with a Java-style
    ``E`` exponent and a ``.0`` on an integral mantissa."""
    if f != f:
        return b"NaN"
    if f in (_INF, -_INF):
        return b"Infinity" if f > 0 else b"-Infinity"
    s = repr(f)
    if "e" in s:
        mant, ex = s.split("e")
        if "." not in mant:
            mant += ".0"
        s = f"{mant}E{int(ex)}"
    elif "." not in s:
        s += ".0"
    return s.encode()


_INF = float("inf")


def _format_value(v, src: DataType) -> bytes:
    """One value as a string (the reference's per-row format)."""
    if src.is_boolean:
        return b"true" if v else b"false"
    if src.is_integral:
        return str(int(v)).encode()
    if src.is_floating:
        # A float32 prints as the repr of its double value, as in the
        # reference (``repr(np.float32(f).item())``).
        return _format_float(float(v))
    if src.name == "date":
        return (np.datetime64(0, "D") + np.timedelta64(int(v), "D")) \
            .astype("datetime64[D]").astype(str).encode()
    if src.name == "timestamp":
        # 'YYYY-MM-DD HH:MM:SS[.ffffff]' with trailing zeros cut.
        s = str(np.datetime64(int(v), "us")).replace("T", " ")
        if "." in s:
            s = s.rstrip("0").rstrip(".")
        return s.encode()
    raise TypeError(f"cannot format {src}")


_DATE_RE = re.compile(r"(\d{4,5})(?:-(\d{1,2})(?:-(\d{1,2}))?)?")


def _parse_value(b: bytes, to: DataType):
    """Parse one string (trimmed first); returns (value, ok)."""
    s = b.decode("utf-8", "replace").strip()
    if s == "":
        return None, False
    try:
        if to.is_boolean:
            low = s.lower()
            if low in ("t", "true", "y", "yes", "1"):
                return True, True
            if low in ("f", "false", "n", "no", "0"):
                return False, True
            return None, False
        if to.is_integral:
            v = int(s)
            info = np.iinfo(to.np_dtype)
            if not (info.min <= v <= info.max):
                return None, False
            return v, True
        if to.is_floating:
            low = s.lower()
            if low == "nan":
                return float("nan"), True
            if low in ("inf", "+inf", "infinity", "+infinity"):
                return float("inf"), True
            if low in ("-inf", "-infinity"):
                return float("-inf"), True
            return float(s), True
        if to.name == "date":
            # ISO yyyy[-mm[-dd]] only; trailing garbage -> NULL.
            m = _DATE_RE.fullmatch(s)
            if not m:
                return None, False
            y = int(m.group(1))
            mo = int(m.group(2) or 1)
            dd = int(m.group(3) or 1)
            if not (1 <= mo <= 12 and 1 <= dd <= 31):
                return None, False
            d = np.datetime64(f"{y:04d}-{mo:02d}-{dd:02d}", "D")
            return int(d.astype("datetime64[D]").astype(np.int64)), True
        if to.name == "timestamp":
            v = np.datetime64(s.replace(" ", "T"))
            return int(v.astype("datetime64[us]").astype(np.int64)), True
    except (ValueError, OverflowError):
        return None, False
    raise TypeError(f"cannot parse to {to}")


def _digits_right(mag: np.ndarray, width: int) -> np.ndarray:
    """(n, width) ASCII decimal digits of non-negative ``mag``,
    right-aligned and zero-filled."""
    out = np.empty((len(mag), width), np.uint8)
    x = mag.copy()
    for k in range(width - 1, -1, -1):
        out[:, k] = 48 + (x % 10).astype(np.uint8)
        x //= 10
    return out


def _left_align(right: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Rows of a right-aligned matrix moved to the left, zero-padded."""
    n, w = right.shape
    out_w = max(int(lens.max()) if n else 1, 1)
    j = np.arange(out_w)[None, :]
    src = np.minimum(w - lens[:, None] + j, w - 1)
    return np.where(j < lens[:, None],
                    np.take_along_axis(right, src, axis=1), 0) \
        .astype(np.uint8)


def _format_ints(arr: np.ndarray):
    """(matrix, lengths) of integers in decimal, as ``"%d"``."""
    v = arr.astype(np.int64)
    neg = v < 0
    # |INT64_MIN| overflows int64: take magnitudes in uint64.
    mag = np.where(neg, (-(v + 1)).astype(np.uint64) + np.uint64(1),
                   v.astype(np.uint64))
    ndig = np.ones(len(v), np.int64)
    for k in range(1, 20):
        ndig += mag >= np.uint64(10 ** k)
    w = int(ndig.max()) + 1
    if w <= 19:
        mag = mag.astype(np.int64)
    right = _digits_right(mag, w)
    right[:, 0] = 0
    sign_at = w - ndig - 1
    rows = np.flatnonzero(neg)
    right[rows, sign_at[rows]] = 45
    return _left_align(right, ndig + neg), (ndig + neg).astype(np.int32)


def _civil(days: np.ndarray):
    """(year, month, day) of day numbers (proleptic Gregorian)."""
    z = days.astype(np.int64) + 719468
    era = np.floor_divide(z, 146097)
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = np.where(mp < 10, mp + 3, mp - 9)
    return yoe + era * 400 + (m <= 2), m, d


def _format_dates(arr: np.ndarray):
    """(matrix, lengths) of dates as ``YYYY-MM-DD``, or None when a year
    falls outside 0-9999 (numpy's format differs there)."""
    y, m, d = _civil(arr)
    if len(y) and (y.min() < 0 or y.max() > 9999):
        return None
    out = np.full((len(y), 10), 45, np.uint8)
    out[:, 0:4] = _digits_right(y, 4)
    out[:, 5:7] = _digits_right(m, 2)
    out[:, 8:10] = _digits_right(d, 2)
    return out, np.full(len(y), 10, np.int32)


def _strings_matrix(strs: list):
    """(matrix, lengths) of ASCII python strings."""
    b = np.array(strs, dtype="S")
    w = max(b.dtype.itemsize, 1)
    m = np.frombuffer(b.tobytes(), np.uint8).reshape(len(strs), w)
    return m, (m != 0).sum(axis=1).astype(np.int32)


def _format_floats(arr: np.ndarray):
    """(matrix, lengths) of floats as the reference formats them: Python's
    ``repr`` as is where it has a '.' and no exponent, ``_format_float``
    elsewhere (exponents, NaN, infinities)."""
    vals = arr.astype(np.float64).tolist()
    strs = [r if ("." in r and "e" not in r and "n" not in r)
            else _format_float(f).decode()
            for r, f in zip(map(repr, vals), vals)]
    return _strings_matrix(strs)


def _format_matrix(col: HostColumn, src: DataType):
    """(matrix, lengths) of a column formatted as the reference formats
    it, for booleans, integers, floats and dates in years 0-9999; None
    for the rest (formatted row by row) and an empty column."""
    if col.num_rows == 0:
        return None
    arr = np.asarray(col.data)
    if src.is_boolean:
        return _strings_matrix(np.where(arr.astype(np.bool_), "true",
                                        "false").tolist())
    if src.is_integral:
        return _format_ints(arr)
    if src.is_floating:
        return _format_floats(arr)
    if src.name == "date":
        return _format_dates(arr)
    return None


def _ascii_ints(m: np.ndarray, lens: np.ndarray):
    """(ok, value): rows that are an optional sign and 1-18 ASCII digits,
    and their int64 value (what ``int`` gives them)."""
    n, w = m.shape
    inside = np.arange(w)[None, :] < lens[:, None]
    digit = (m >= 48) & (m <= 57) & inside
    signed = (lens >= 2) & ((m[:, 0] == 43) | (m[:, 0] == 45))
    ndig = digit.sum(axis=1)
    ok = (ndig == lens - signed) & (ndig >= 1) & (ndig <= 18)
    v = np.zeros(n, np.int64)
    for j in range(w):
        v = np.where(digit[:, j], v * 10 + (m[:, j].astype(np.int64) - 48),
                     v)
    return ok, np.where(signed & (m[:, 0] == 45), -v, v)


_MONTH_DAYS = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])


def _ascii_dates(m: np.ndarray, lens: np.ndarray):
    """(handled, ok, days): rows of exactly ``dddd-dd-dd`` in ASCII, and
    for them whether the reference's parse accepts the date and its day
    number (a day past its month's end is NULL, as ``datetime64``
    refuses it)."""
    n, w = m.shape
    if w < 10:
        z = np.zeros(n, np.bool_)
        return z, z, np.zeros(n, np.int64)
    d = m[:, :10].astype(np.int32) - 48
    digit = (d >= 0) & (d <= 9)
    handled = (lens == 10) & (m[:, 4] == 45) & (m[:, 7] == 45) & \
        digit[:, :4].all(axis=1) & digit[:, 5] & digit[:, 6] & \
        digit[:, 8] & digit[:, 9]
    y = d[:, 0] * 1000 + d[:, 1] * 100 + d[:, 2] * 10 + d[:, 3]
    mo = d[:, 5] * 10 + d[:, 6]
    dd = d[:, 8] * 10 + d[:, 9]
    in_range = (mo >= 1) & (mo <= 12) & (dd >= 1) & (dd <= 31)
    mo = np.where(in_range, mo, 1)
    leap = (y % 4 == 0) & ((y % 100 != 0) | (y % 400 == 0))
    ok = handled & in_range & \
        (dd <= _MONTH_DAYS[mo - 1] + (leap & (mo == 2)))
    # days_from_civil, proleptic Gregorian (year 0 a leap year, as numpy).
    yy = y - (mo <= 2)
    era = yy // 400
    yoe = yy - era * 400
    doy = (153 * np.where(mo > 2, mo - 3, mo + 9) + 2) // 5 + dd - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return handled, ok, era.astype(np.int64) * 146097 + doe - 719468


_FLOAT_BYTES = np.zeros(256, np.bool_)
_FLOAT_BYTES[np.frombuffer(b"0123456789.+-eE", np.uint8)] = True


def _float_or_none(b: bytes):
    try:
        return float(b)
    except ValueError:
        return None


def _parse_column(col: HostColumn, to: DataType):
    """(data, validity) of a string column parsed to ``to``: the
    reference's ``_parse_value`` row by row, with vectorized paths for
    plain ASCII integers and ``yyyy-mm-dd`` dates and a tighter loop for
    float literals, each giving the same values."""
    n = col.num_rows
    m, lens = strings_to_matrix(col)
    lens = np.asarray(lens, np.int64)
    todo = np.array(col.validity, np.bool_)
    data = np.zeros(n, dtype=to.np_dtype)
    validity = np.zeros(n, dtype=np.bool_)
    if to.is_integral and n:
        ok, v = _ascii_ints(m, lens)
        ok &= todo
        info = np.iinfo(to.np_dtype)
        good = ok & (v >= info.min) & (v <= info.max)
        data[good] = v[good].astype(to.np_dtype)
        validity |= good
        todo &= ~ok
    elif to.name == "date" and n:
        handled, ok, days = _ascii_dates(m, lens)
        handled &= todo
        good = handled & ok
        data[good] = days[good].astype(to.np_dtype)
        validity |= good
        todo &= ~handled
    elif to.is_floating and n:
        lit = todo & (lens > 0) & (
            _FLOAT_BYTES[m] | (np.arange(m.shape[1])[None, :]
                               >= lens[:, None])).all(axis=1)
        rows = np.flatnonzero(lit)
        w = m.shape[1]
        text = np.ascontiguousarray(m[rows]).view(f"S{w}").ravel()
        try:
            # numpy's bytes -> float64 parse (Python's ``float`` on these
            # characters); one malformed literal sends every row through
            # ``float`` one by one.
            vals = text.astype(np.float64)
            got = np.ones(len(rows), np.bool_)
        except ValueError:
            parsed = [_float_or_none(b) for b in text.tolist()]
            got = np.array([v is not None for v in parsed], np.bool_)
            vals = np.array([0.0 if v is None else v for v in parsed],
                            np.float64)
        data[rows[got]] = vals[got].astype(to.np_dtype)
        validity[rows[got]] = True
        todo &= ~lit
    for i in np.flatnonzero(todo).tolist():
        v, ok = _parse_value(m[i, :lens[i]].tobytes(), to)
        if ok:
            validity[i] = True
            data[i] = bool(v) if to.is_boolean else to.np_dtype.type(v)
    return data, validity


def _cast_string_host(col: HostColumn, src: DataType,
                      to: DataType) -> HostColumn:
    """A host column cast where either side is a string."""
    n = col.num_rows
    if to.is_string:
        validity = np.array(col.validity, np.bool_)
        fast = _format_matrix(col, src)
        if fast is not None:
            m, lens = fast
            return HostColumn(to, None, validity,
                              str_matrix=m * validity[:, None].astype(
                                  np.uint8),
                              str_lengths=np.where(validity, lens, 0)
                              .astype(np.int32))
        data = np.empty(n, dtype=object)
        data[:] = [_format_value(v, src) if ok else b"" for v, ok in zip(
            np.asarray(col.data), validity.tolist())]
        return HostColumn(to, data, validity)
    data, validity = _parse_column(col, to)
    return HostColumn(to, data, validity)
