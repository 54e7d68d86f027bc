"""Math expressions (port of the JAX package's ``exprs/math.py``).

Unary math functions follow Spark: the input is cast to double and a
domain error gives NaN, as java.lang.Math does, except the logarithms
(``Log``, ``Log10``, ``Log2``, ``Log1p`` and the two-argument
``Logarithm``), which give NULL outside their domain. ``Floor`` and
``Ceil`` return LONG; ``Round`` rounds HALF_UP and ``BRound`` HALF_EVEN,
each in the reference's order of operations, with an exact integer path
for integral input.

Subnormals: the reference's device engine (XLA:CPU) reads a subnormal
operand as a zero of its sign (``_daz``) and flushes a subnormal result
(``_ftz``) for most of these functions, but not for all: ``expm1``,
``sin`` and ``tan`` keep both, ``pow`` and ``atan2`` flush only their
result, ``asin`` also flushes results below twice the smallest normal
(its ``2 * atan2(x, 1 + sqrt(1 - x*x))`` halves them first), and every
float32 operand is flushed as it converts to double. Each device half
here does what the reference's does, pinned function by function by the
parity tests (``flush_subnormal``). The host halves are numpy and flush
nothing.

Where the reference is less accurate than the CPU's libm, the port
follows the libm and not the reference (a divergence the parity tests
pin): ``cbrt`` and ``pow`` of a subnormal, ``sinh`` / ``cosh`` within a
few units of overflow and ``log1p`` / ``atanh`` in part of (-1, 0). The
device halves evaluate ``sqrt`` correctly rounded and ``sinh`` / ``cosh``
without overflow before the result does (torch's CPU kernels do
neither; CUDA's do both); see ``_sqrt`` for the one case its CPU path
leaves an ulp off.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import flush_subnormal
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exprs.arithmetic import convert
from spark_rapids_tpu_torch.exprs.base import (
    BinaryExpression, Literal, UnaryExpression)
from spark_rapids_tpu_torch.exprs.cast import _TORCH


def f64_in(data: torch.Tensor, daz: bool = True) -> torch.Tensor:
    """A device operand as float64, as the reference's engine converts it:
    a float32 subnormal becomes a zero of its sign, and so does a float64
    one when ``daz``."""
    x = convert(data, torch.float64)
    return flush_subnormal(x) if daz else x


def _c(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Square root as IEEE rounds it: torch's (CUDA's is correctly
    rounded, the CPU's can be an ulp off), then one Newton step on the
    exact residual ``x - y*y`` (Dekker's product; torch has no fused
    multiply-add). The step cannot resolve a root within about 2^-54 ulp
    of a rounding midpoint (the largest double's is one), which can stay
    an ulp off on the CPU. Operands below 2^-500 (above 2^1000) are scaled by
    2^600 (2^-200) first, so the residual stays normal (finite)."""
    small = x < 2.0 ** -500
    big = x > 2.0 ** 1000
    xs = torch.where(small, x * 2.0 ** 600,
                     torch.where(big, x * 2.0 ** -200, x))
    y = torch.sqrt(xs)
    c = y * 134217729.0                     # 2^27 + 1: Veltkamp's split
    hi = c - (c - y)
    lo = y - hi
    p = y * y
    err = ((hi * hi - p) + 2.0 * hi * lo) + lo * lo
    fixed = y + ((xs - p) - err) / (2.0 * y)
    y = torch.where(torch.isfinite(y) & (y > 0), fixed, y)
    return torch.where(small, y * 2.0 ** -300,
                       torch.where(big, y * 2.0 ** 100, y))


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root as the reference computes it, ``|x| ** (1/3)`` with the
    sign of x (torch has no cbrt)."""
    return torch.copysign(x.abs().pow(1.0 / 3.0), x)


def _asin(x: torch.Tensor) -> torch.Tensor:
    # The reference halves x on the way (see the module doc): results
    # below twice the smallest normal flush.
    tiny2 = 2.0 * torch.finfo(torch.float64).tiny
    return torch.where(x.abs() < tiny2, x * 0, torch.asin(x))


def _near_overflow(fn, x: torch.Tensor) -> torch.Tensor:
    """sinh / cosh with ``exp(|x|/2) * (exp(|x|/2) / 2)`` above |x| = 700,
    where ``exp(|x|)`` alone overflows first."""
    a = x.abs()
    h = torch.exp(torch.where(a > 700, a, _c(0.0, a)) * 0.5)
    big = h * (h * 0.5)
    if fn is torch.sinh:
        big = torch.copysign(big, x)
    return torch.where(a > 700, big, fn(x))


class _UnaryMathD(UnaryExpression):
    """double -> double math function: ``_t`` on the device half, ``_np``
    on the host half. ``_daz`` reads a subnormal operand as zero and
    ``_ftz`` flushes a subnormal result on the device half, where the
    reference's engine does."""

    _daz = True
    _ftz = True

    def data_type(self) -> DataType:
        return dt.FLOAT64

    def _t(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _np(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def do_columnar(self, data, validity, col):
        out = self._t(f64_in(data, self._daz))
        return (flush_subnormal(out) if self._ftz else out), validity

    def do_host(self, data, validity, col):
        with np.errstate(all="ignore"):
            return self._np(data.astype(np.float64)), validity


def _unary(name, t_fn, np_fn, flush=True, doc=None):
    cls = type(name, (_UnaryMathD,), {
        "_t": staticmethod(t_fn), "_np": staticmethod(np_fn),
        "_daz": flush, "_ftz": flush, "__doc__": doc})
    cls.__module__ = __name__
    return cls


Sqrt = _unary("Sqrt", _sqrt, np.sqrt)
Cbrt = _unary("Cbrt", _cbrt, np.cbrt, flush=False)
Exp = _unary("Exp", torch.exp, np.exp)
Expm1 = _unary("Expm1", torch.expm1, np.expm1, flush=False)
Sin = _unary("Sin", torch.sin, np.sin, flush=False)
Cos = _unary("Cos", torch.cos, np.cos)
Tan = _unary("Tan", torch.tan, np.tan, flush=False)
Asin = _unary("Asin", _asin, np.arcsin)
Acos = _unary("Acos", torch.acos, np.arccos)
Atan = _unary("Atan", torch.atan, np.arctan)
Sinh = _unary("Sinh", lambda x: _near_overflow(torch.sinh, x), np.sinh)
Cosh = _unary("Cosh", lambda x: _near_overflow(torch.cosh, x), np.cosh)
Tanh = _unary("Tanh", torch.tanh, np.tanh)
Asinh = _unary("Asinh", torch.asinh, np.arcsinh,
               doc="Total on the reals: no domain handling needed.")
ToDegrees = _unary("ToDegrees", lambda x: x * (180.0 / math.pi),
                   np.degrees)
ToRadians = _unary("ToRadians", lambda x: x * (math.pi / 180.0),
                   np.radians)
Rint = _unary("Rint", torch.round, np.round,
              doc="Math.rint: round half to even.")


def _sign(x: torch.Tensor) -> torch.Tensor:
    """``sign`` as XLA computes it: NaN stays NaN and a zero keeps its
    sign (``torch.sign`` gives 0 for NaN)."""
    one = _c(1.0, x)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


Signum = _unary("Signum", _sign, np.sign)


class Acosh(_UnaryMathD):
    """Domain x >= 1; outside it java.lang.Math (and Spark) give NaN.
    Evaluated on a clamped safe input, as the reference is."""

    def _t(self, x):
        ok = x >= 1
        res = torch.acosh(torch.where(ok, x, _c(1.0, x)))
        return torch.where(ok, res, _c(float("nan"), x))

    def _np(self, x):
        ok = x >= 1
        return np.where(ok, np.arccosh(np.where(ok, x, 1.0)), np.nan)


class Atanh(_UnaryMathD):
    """|x| < 1 -> finite, x == +-1 -> +-Infinity, |x| > 1 -> NaN, piecewise
    on safe inputs as the reference evaluates it."""

    def _t(self, x):
        inside = x.abs() < 1
        res = torch.atanh(torch.where(inside, x, _c(0.0, x)))
        edge = torch.where(x == 1, _c(float("inf"), x),
                           torch.where(x == -1, _c(float("-inf"), x),
                                       _c(float("nan"), x)))
        return torch.where(inside, res, edge)

    def _np(self, x):
        inside = np.abs(x) < 1
        res = np.arctanh(np.where(inside, x, 0.0))
        edge = np.where(x == 1, np.inf, np.where(x == -1, -np.inf, np.nan))
        return np.where(inside, res, edge)


class _LogBase(UnaryExpression):
    """Spark's logarithms give NULL outside the domain (x <= 0; x <= -1
    for ``log1p``); the function runs on a safe input there."""

    _t = staticmethod(torch.log)
    _np = staticmethod(np.log)
    _bound = 0.0

    def data_type(self) -> DataType:
        return dt.FLOAT64

    def do_columnar(self, data, validity, col):
        x = f64_in(data)
        ok = x > self._bound
        out = self._t(torch.where(ok, x, _c(1.0, x)))
        return flush_subnormal(out), validity & ok

    def do_host(self, data, validity, col):
        x = data.astype(np.float64)
        ok = x > self._bound
        with np.errstate(all="ignore"):
            return self._np(np.where(ok, x, 1.0)), validity & ok


class Log(_LogBase):
    pass


class Log10(_LogBase):
    _t = staticmethod(torch.log10)
    _np = staticmethod(np.log10)


class Log2(_LogBase):
    _t = staticmethod(torch.log2)
    _np = staticmethod(np.log2)


class Log1p(_LogBase):
    _t = staticmethod(torch.log1p)
    _np = staticmethod(np.log1p)
    _bound = -1.0


class Logarithm(BinaryExpression):
    """log(base, x), Spark's two-argument Logarithm: NULL outside the
    domain (base <= 0, base == 1 or x <= 0; NaN operands fall through the
    comparisons to NULL too)."""

    def data_type(self) -> DataType:
        return dt.FLOAT64

    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        b, x = f64_in(l_data), f64_in(r_data)
        ok = (b > 0) & (b != 1) & (x > 0)
        sb = torch.where(ok, b, _c(2.0, b))
        sx = torch.where(ok, x, _c(1.0, x))
        out = flush_subnormal(torch.log(sx)) / flush_subnormal(torch.log(sb))
        return flush_subnormal(out), l_valid & r_valid & ok

    def do_host(self, l_data, l_valid, r_data, r_valid):
        b, x = l_data.astype(np.float64), r_data.astype(np.float64)
        ok = (b > 0) & (b != 1) & (x > 0)
        with np.errstate(all="ignore"):
            out = np.log(np.where(ok, x, 1.0)) / np.log(np.where(ok, b, 2.0))
        return out, l_valid & r_valid & ok


class _ToLong(UnaryExpression):
    """Spark's floor / ceil return LONG (the input goes through double,
    as in the reference, integral input included)."""

    _t = staticmethod(torch.floor)
    _np = staticmethod(np.floor)

    def data_type(self) -> DataType:
        return dt.INT64

    def do_columnar(self, data, validity, col):
        return _TORCH.float_to_int(self._t(f64_in(data)), dt.INT64), \
            validity

    def do_host(self, data, validity, col):
        with np.errstate(all="ignore"):
            return self._np(data.astype(np.float64)).astype(np.int64), \
                validity


class Floor(_ToLong):
    pass


class Ceil(_ToLong):
    _t = staticmethod(torch.ceil)
    _np = staticmethod(np.ceil)


class Pow(BinaryExpression):
    def data_type(self) -> DataType:
        return dt.FLOAT64

    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        out = torch.pow(f64_in(l_data, False), f64_in(r_data, False))
        return flush_subnormal(out), l_valid & r_valid

    def do_host(self, l_data, l_valid, r_data, r_valid):
        with np.errstate(all="ignore"):
            return (np.power(l_data.astype(np.float64),
                             r_data.astype(np.float64)),
                    l_valid & r_valid)


class Atan2(BinaryExpression):
    def data_type(self) -> DataType:
        return dt.FLOAT64

    def do_columnar(self, l_data, l_valid, r_data, r_valid):
        out = torch.atan2(f64_in(l_data, False), f64_in(r_data, False))
        return flush_subnormal(out), l_valid & r_valid

    def do_host(self, l_data, l_valid, r_data, r_valid):
        with np.errstate(all="ignore"):
            return (np.arctan2(l_data.astype(np.float64),
                               r_data.astype(np.float64)),
                    l_valid & r_valid)


def _int_factor(scale: int) -> int:
    """10 ** -scale as the reference's int64 arithmetic gives it (it
    wraps past 10 ** 18)."""
    with np.errstate(all="ignore"):
        return int(np.int64(10) ** np.int64(-scale))


def _floordiv(a, b, xp):
    if xp is torch:
        return torch.div(a, b, rounding_mode="floor")
    with np.errstate(all="ignore"):
        return np.floor_divide(a, b)


class Round(UnaryExpression):
    """round(x, d): HALF_UP, as Spark's (not banker's rounding). The scale
    is a literal. Float input: ``floor(x*f + 0.5)`` (``ceil(x*f - 0.5)``
    below zero), then ``/ f``; integral input rounds exactly in int64."""

    def __init__(self, child, scale=0):
        super().__init__(child)
        if isinstance(scale, Literal):
            scale = scale.value
        self.scale = int(scale)

    def data_type(self) -> DataType:
        return self.child.data_type()

    # -- integral input ----------------------------------------------------
    def _int_round(self, xp, x):
        factor = _int_factor(self.scale)
        mag = xp.abs(x) + factor // 2
        r = _floordiv(mag, factor, xp) * factor
        return xp.where(x < 0, -r, r)

    # -- float input -------------------------------------------------------
    def _factor(self, x):
        """10.0 ** scale; on the device a 0-d tensor, as torch's CUDA
        division by a python scalar multiplies by its reciprocal (an ulp
        off the quotient)."""
        f = 10.0 ** self.scale
        return _c(f, x) if isinstance(x, torch.Tensor) else f

    def _float_round(self, x, flush):
        f = self._factor(x)
        scaled = flush(x * f)
        lo = torch.floor if isinstance(x, torch.Tensor) else np.floor
        hi = torch.ceil if isinstance(x, torch.Tensor) else np.ceil
        where = torch.where if isinstance(x, torch.Tensor) else np.where
        return flush(where(scaled >= 0, lo(flush(scaled + 0.5)),
                           hi(flush(scaled - 0.5))) / f)

    def do_columnar(self, data, validity, col):
        if self.data_type().is_integral:
            if self.scale >= 0:
                return data, validity
            return self._int_round(torch, data.to(torch.int64)), validity
        return self._float_round(f64_in(data), flush_subnormal), validity

    def do_host(self, data, validity, col):
        if self.data_type().is_integral:
            if self.scale >= 0:
                return data, validity
            with np.errstate(all="ignore"):
                return self._int_round(np, data.astype(np.int64)), validity
        with np.errstate(all="ignore"):
            return self._float_round(data.astype(np.float64),
                                     lambda v: v), validity


class BRound(Round):
    """bround(x, d): HALF_EVEN (banker's rounding)."""

    def _int_round(self, xp, x):
        factor = _int_factor(self.scale)
        q = _floordiv(x, factor, xp)          # rem in [0, factor)
        rem = x - q * factor
        up = (2 * rem > factor) | ((2 * rem == factor) & (q % 2 != 0))
        return (q + (up.to(torch.int64) if xp is torch
                     else up.astype(np.int64))) * factor

    def _float_round(self, x, flush):
        f = self._factor(x)
        rnd = torch.round if isinstance(x, torch.Tensor) else np.round
        return flush(rnd(flush(x * f)) / f)
