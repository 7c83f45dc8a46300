"""Math expressions (port of ``spark_rapids_tpu/exprs/mathexprs.py``).

Every unary function returns DOUBLE (``Floor`` and ``Ceil`` too, as in the
JAX package, where Spark returns LONG); a domain error gives NaN, as
``java.lang.Math`` does.  The device forms are plain torch ops, the host
twins the numpy functions the JAX package's twins call.  The
transcendental functions (``sqrt`` on torch's CPU too) may differ from
numpy's in the last bit or so (CUDA's libdevice, torch's CPU kernels and
numpy each round their own way); ``floor``, ``ceil``, ``rint``,
``signum`` and ``round`` are exact.  Torch has no cube root, gives
``sign(NaN) = 0`` and overflows ``sinh``/``cosh`` where ``exp`` does:
those three are written out here.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import (
    BinaryExpression, CpuVal, DevVal, UnaryExpression, cast_cpu, cast_dev,
)


class _UnaryMathExpression(UnaryExpression):
    _torch = None  # staticmethods set by _make_unary
    _np = None

    def _resolve_type(self):
        self.dtype = T.DOUBLE
        self.nullable = self.child.nullable

    def gpu_eval(self, ctx) -> DevVal:
        v = cast_dev(self.child.gpu_eval(ctx), T.DOUBLE)
        return DevVal(T.DOUBLE, self._torch(v.data), v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = cast_cpu(self.child.cpu_eval(ctx), T.DOUBLE)
        with np.errstate(all="ignore"):
            data = self._np(v.values)
        return CpuVal(T.DOUBLE, np.asarray(data, dtype=np.float64),
                      v.validity)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root (torch has none): ``|x|^(1/3)`` with its sign, then one
    Newton step, ``y + (x / y^2 - y) / 3``, which brings the power's
    error of tens of ULP at large magnitudes back to about one."""
    y = torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)
    step = y + (x / (y * y) - y) / 3.0
    return torch.where(torch.isfinite(y) & (y != 0), step, y)


def _exp_half_squared(ax: torch.Tensor) -> torch.Tensor:
    """``exp(|x|) / 2`` as ``(exp(|x|/2) / 2) * exp(|x|/2)``: finite up to
    sinh's own overflow (|x| ~ 710.48), where ``exp`` alone overflows
    at 709.78."""
    t = torch.exp(ax * 0.5)
    return (t * 0.5) * t


def _sinh(x: torch.Tensor) -> torch.Tensor:
    big = torch.abs(x) > 20.0  # e^-|x| below an ULP of the result
    return torch.where(big, torch.sign(x) * _exp_half_squared(x.abs()),
                       torch.sinh(x))


def _cosh(x: torch.Tensor) -> torch.Tensor:
    big = torch.abs(x) > 20.0
    return torch.where(big, _exp_half_squared(x.abs()), torch.cosh(x))


def _signum(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), x, torch.sign(x))  # sign(NaN) = 0


def _make_unary(name, torch_fn, np_fn):
    return type(name, (_UnaryMathExpression,), {
        "_torch": staticmethod(torch_fn),
        "_np": staticmethod(np_fn),
    })


Sqrt = _make_unary("Sqrt", torch.sqrt, np.sqrt)
Exp = _make_unary("Exp", torch.exp, np.exp)
Log = _make_unary("Log", torch.log, np.log)
Log2 = _make_unary("Log2", torch.log2, np.log2)
Log10 = _make_unary("Log10", torch.log10, np.log10)
Log1p = _make_unary("Log1p", torch.log1p, np.log1p)
Expm1 = _make_unary("Expm1", torch.expm1, np.expm1)
Floor = _make_unary("Floor", torch.floor, np.floor)
Ceil = _make_unary("Ceil", torch.ceil, np.ceil)
Sin = _make_unary("Sin", torch.sin, np.sin)
Cos = _make_unary("Cos", torch.cos, np.cos)
Tan = _make_unary("Tan", torch.tan, np.tan)
Asin = _make_unary("Asin", torch.asin, np.arcsin)
Acos = _make_unary("Acos", torch.acos, np.arccos)
Atan = _make_unary("Atan", torch.atan, np.arctan)
Cbrt = _make_unary("Cbrt", _cbrt, np.cbrt)
Signum = _make_unary("Signum", _signum, np.sign)
Rint = _make_unary("Rint", torch.round, np.rint)
ToDegrees = _make_unary("ToDegrees", torch.rad2deg, np.degrees)
ToRadians = _make_unary("ToRadians", torch.deg2rad, np.radians)
Sinh = _make_unary("Sinh", _sinh, np.sinh)
Cosh = _make_unary("Cosh", _cosh, np.cosh)
Tanh = _make_unary("Tanh", torch.tanh, np.tanh)
Asinh = _make_unary("Asinh", torch.asinh, np.arcsinh)
Acosh = _make_unary("Acosh", torch.acosh, np.arccosh)
Atanh = _make_unary("Atanh", torch.atanh, np.arctanh)
Cot = _make_unary("Cot", lambda x: 1.0 / torch.tan(x),
                  lambda x: 1.0 / np.tan(x))


class Pow(BinaryExpression):
    def _resolve_type(self):
        self.dtype = T.DOUBLE
        self.nullable = self.left.nullable or self.right.nullable

    def gpu_eval(self, ctx) -> DevVal:
        a = cast_dev(self.left.gpu_eval(ctx), T.DOUBLE)
        b = cast_dev(self.right.gpu_eval(ctx), T.DOUBLE)
        return DevVal(T.DOUBLE, torch.pow(a.data, b.data),
                      a.validity & b.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        a = cast_cpu(self.left.cpu_eval(ctx), T.DOUBLE)
        b = cast_cpu(self.right.cpu_eval(ctx), T.DOUBLE)
        with np.errstate(all="ignore"):
            data = np.power(a.values, b.values)
        return CpuVal(T.DOUBLE, data, a.validity & b.validity)


class Round(UnaryExpression):
    """round(x, scale), HALF_UP (Spark's default):
    ``sign(x) * floor(|x| * 10^scale + 0.5) / 10^scale``; an integral input
    at a scale >= 0 is returned as it is."""

    def __init__(self, child, scale: int = 0):
        self.scale = int(scale)
        super().__init__(child)

    def with_children(self, children):
        return Round(children[0], self.scale)

    def _resolve_type(self):
        self.dtype = self.child.dtype if self.child.dtype.is_numeric \
            else T.DOUBLE
        self.nullable = self.child.nullable

    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        if v.dtype.is_integral and self.scale >= 0:
            return v
        x = v.data.to(torch.float64)
        m = 10.0 ** self.scale
        r = torch.sign(x) * torch.floor(torch.abs(x) * m + 0.5) / m
        return DevVal(self.dtype, r.to(self.dtype.torch_dtype), v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        if v.dtype.is_integral and self.scale >= 0:
            return v
        x = v.values.astype(np.float64)
        m = 10.0 ** self.scale
        with np.errstate(all="ignore"):
            r = np.sign(x) * np.floor(np.abs(x) * m + 0.5) / m
        return CpuVal(self.dtype, r.astype(self.dtype.np_dtype), v.validity)


class Logarithm(BinaryExpression):
    """log(base, x) (Spark's Logarithm): ``ln(x) / ln(base)``."""

    def _resolve_type(self):
        self.dtype = T.DOUBLE
        self.nullable = True

    def gpu_eval(self, ctx) -> DevVal:
        b = cast_dev(self.left.gpu_eval(ctx), T.DOUBLE)
        x = cast_dev(self.right.gpu_eval(ctx), T.DOUBLE)
        return DevVal(T.DOUBLE, torch.log(x.data) / torch.log(b.data),
                      b.validity & x.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        b = cast_cpu(self.left.cpu_eval(ctx), T.DOUBLE)
        x = cast_cpu(self.right.cpu_eval(ctx), T.DOUBLE)
        with np.errstate(all="ignore"):
            data = np.log(x.values) / np.log(b.values)
        return CpuVal(T.DOUBLE, data, b.validity & x.validity)
