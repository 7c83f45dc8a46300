"""Arithmetic expressions (port of ``spark_rapids_tpu/exprs/arithmetic.py``).

Spark non-ANSI semantics, Java integer rules: integral overflow wraps, which
matches torch's fixed-width integer arithmetic; a NULL operand gives NULL;
division and remainder by zero give NULL.  Java's integer division
truncates toward zero where torch's floor division floors, so ``div`` and
``%`` take the JAX package's formula ``sign(a) * sign(b) * (|a| // |b|)``
(with ``|Long.MIN_VALUE|`` wrapping as it does there).  Each class's
``cpu_eval`` is the JAX package's host twin in numpy, step for step.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import (
    BinaryExpression, CpuVal, DevVal, UnaryExpression, cast_cpu, cast_dev,
    promote_cpu, promote_dev,
)


class _BinaryArithmetic(BinaryExpression):
    def _compute(self, x, y):
        raise NotImplementedError

    def gpu_eval(self, ctx) -> DevVal:
        a, b, out = promote_dev(self.left.gpu_eval(ctx),
                                self.right.gpu_eval(ctx))
        data = self._compute(a.data, b.data)
        return DevVal(out, data.to(out.torch_dtype), a.validity & b.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        a, b, out = promote_cpu(self.left.cpu_eval(ctx),
                                self.right.cpu_eval(ctx))
        with np.errstate(all="ignore"):
            data = self._compute(a.values, b.values)
        return CpuVal(out, data.astype(out.np_dtype), a.validity & b.validity)


class Add(_BinaryArithmetic):
    def _compute(self, x, y):
        return x + y


class Subtract(_BinaryArithmetic):
    def _compute(self, x, y):
        return x - y


class Multiply(_BinaryArithmetic):
    def _compute(self, x, y):
        return x * y


def _trunc_div(a: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """Java's truncating quotient of ``den`` != 0, in ``a``'s dtype."""
    q = torch.div(torch.abs(a), torch.abs(den), rounding_mode="floor")
    return torch.sign(a) * torch.sign(den) * q


def _java_rem(a: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return a - _trunc_div(a, den) * den


def _java_rem_np(a: np.ndarray, den: np.ndarray) -> np.ndarray:
    q = np.sign(a) * np.sign(den) * (np.abs(a) // np.abs(den))
    return a - q * den


class Divide(BinaryExpression):
    """Spark '/': always DOUBLE; x / 0 is NULL, not inf."""

    def _resolve_type(self):
        self.dtype = T.DOUBLE
        self.nullable = True

    def gpu_eval(self, ctx) -> DevVal:
        a = cast_dev(self.left.gpu_eval(ctx), T.DOUBLE)
        b = cast_dev(self.right.gpu_eval(ctx), T.DOUBLE)
        zero = b.data == 0.0
        data = a.data / b.data.masked_fill(zero, 1.0)
        return DevVal(T.DOUBLE, data, a.validity & b.validity & ~zero)

    def cpu_eval(self, ctx) -> CpuVal:
        a = cast_cpu(self.left.cpu_eval(ctx), T.DOUBLE)
        b = cast_cpu(self.right.cpu_eval(ctx), T.DOUBLE)
        zero = b.values == 0.0
        with np.errstate(all="ignore"):
            data = a.values / np.where(zero, 1.0, b.values)
        return CpuVal(T.DOUBLE, data, a.validity & b.validity & ~zero)


class IntegralDivide(BinaryExpression):
    """Spark 'div': LONG, truncated toward zero; x div 0 is NULL."""

    def _resolve_type(self):
        self.dtype = T.LONG
        self.nullable = True

    def gpu_eval(self, ctx) -> DevVal:
        a = cast_dev(self.left.gpu_eval(ctx), T.LONG)
        b = cast_dev(self.right.gpu_eval(ctx), T.LONG)
        zero = b.data == 0
        q = _trunc_div(a.data, b.data.masked_fill(zero, 1))
        return DevVal(T.LONG, q, a.validity & b.validity & ~zero)

    def cpu_eval(self, ctx) -> CpuVal:
        a = cast_cpu(self.left.cpu_eval(ctx), T.LONG)
        b = cast_cpu(self.right.cpu_eval(ctx), T.LONG)
        zero = b.values == 0
        den = np.where(zero, 1, b.values)
        with np.errstate(all="ignore"):
            q = (np.sign(a.values) * np.sign(den)
                 * (np.abs(a.values) // np.abs(den)))
        return CpuVal(T.LONG, q.astype(np.int64),
                      a.validity & b.validity & ~zero)


class Remainder(BinaryExpression):
    """Spark '%': Java semantics, the dividend's sign (``fmod`` for
    floats); x % 0 is NULL."""

    def gpu_eval(self, ctx) -> DevVal:
        a, b, out = promote_dev(self.left.gpu_eval(ctx),
                                self.right.gpu_eval(ctx))
        zero = b.data == 0
        den = b.data.masked_fill(zero, 1)
        r = torch.fmod(a.data, den) if out.is_fractional \
            else _java_rem(a.data, den)
        return DevVal(out, r.to(out.torch_dtype),
                      a.validity & b.validity & ~zero)

    def cpu_eval(self, ctx) -> CpuVal:
        a, b, out = promote_cpu(self.left.cpu_eval(ctx),
                                self.right.cpu_eval(ctx))
        zero = b.values == 0
        den = np.where(zero, 1, b.values)
        with np.errstate(all="ignore"):
            r = np.fmod(a.values, den) if out.is_fractional \
                else _java_rem_np(a.values, den)
        return CpuVal(out, r.astype(out.np_dtype),
                      a.validity & b.validity & ~zero)


class Pmod(BinaryExpression):
    """Spark pmod as the JAX package computes it: r = a % n (Java
    remainder); where r < 0, (r + n) % n.  The result takes the divisor's
    sign for a negative divisor; floats run the same formula with floor
    division."""

    def gpu_eval(self, ctx) -> DevVal:
        a, b, out = promote_dev(self.left.gpu_eval(ctx),
                                self.right.gpu_eval(ctx))
        zero = b.data == 0
        den = b.data.masked_fill(zero, 1)
        r = torch.fmod(a.data, den) if out.is_fractional \
            else _java_rem(a.data, den)
        r = torch.where(r < 0, _java_rem(r + den, den), r)
        return DevVal(out, r.to(out.torch_dtype),
                      a.validity & b.validity & ~zero)

    def cpu_eval(self, ctx) -> CpuVal:
        a, b, out = promote_cpu(self.left.cpu_eval(ctx),
                                self.right.cpu_eval(ctx))
        zero = b.values == 0
        den = np.where(zero, 1, b.values)
        with np.errstate(all="ignore"):
            r = np.fmod(a.values, den) if out.is_fractional \
                else _java_rem_np(a.values, den)
            r = np.where(r < 0, _java_rem_np(r + den, den), r)
        return CpuVal(out, r.astype(out.np_dtype),
                      a.validity & b.validity & ~zero)


class UnaryMinus(UnaryExpression):
    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        return DevVal(v.dtype, -v.data, v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        return CpuVal(v.dtype, (-v.values).astype(v.dtype.np_dtype),
                      v.validity)


class Abs(UnaryExpression):
    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        return DevVal(v.dtype, torch.abs(v.data), v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        return CpuVal(v.dtype, np.abs(v.values), v.validity)


class UnaryPositive(UnaryExpression):
    """+x: the value unchanged, kept as a node for plan parity."""

    def gpu_eval(self, ctx) -> DevVal:
        return self.child.gpu_eval(ctx)

    def cpu_eval(self, ctx) -> CpuVal:
        return self.child.cpu_eval(ctx)
