"""Arithmetic expressions (port of ``spark_rapids_tpu/exprs/arithmetic.py``).

Spark non-ANSI semantics, Java integer rules: integral overflow wraps, which
matches torch's fixed-width integer arithmetic; a NULL operand gives NULL;
division and remainder by zero give NULL.  Java's integer division
truncates toward zero where torch's floor division floors, so ``div`` and
``%`` take the JAX package's formula ``sign(a) * sign(b) * (|a| // |b|)``
(with ``|Long.MIN_VALUE|`` wrapping as it does there).
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import (
    BinaryExpression, DevVal, UnaryExpression, cast_dev, promote_dev,
)


class _BinaryArithmetic(BinaryExpression):
    def _compute(self, x, y):
        raise NotImplementedError

    def gpu_eval(self, ctx) -> DevVal:
        a, b, out = promote_dev(self.left.gpu_eval(ctx),
                                self.right.gpu_eval(ctx))
        data = self._compute(a.data, b.data)
        return DevVal(out, data.to(out.torch_dtype), a.validity & b.validity)


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


class UnaryMinus(UnaryExpression):
    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        return DevVal(v.dtype, -v.data, v.validity)


class Abs(UnaryExpression):
    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        return DevVal(v.dtype, torch.abs(v.data), v.validity)


class UnaryPositive(UnaryExpression):
    """+x: the value unchanged, kept as a node for plan parity."""

    def gpu_eval(self, ctx) -> DevVal:
        return self.child.gpu_eval(ctx)
