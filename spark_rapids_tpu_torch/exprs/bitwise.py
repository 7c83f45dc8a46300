"""Bitwise expressions (port of ``spark_rapids_tpu/exprs/bitwise.py``):
``&``, ``|``, ``^`` and ``~`` over integers, and the Java shifts.

Java masks the shift count to the operand's width (``s & 31`` for an INT,
``s & 63`` for a LONG).  ``>>>`` shifts the unsigned bit pattern; torch
has no unsigned 64-bit arithmetic, so a LONG is shifted arithmetically
and the sign bits it brought in are masked off (an INT goes through its
zero-extended LONG).  The host twins are the JAX package's numpy forms,
with their unsigned views.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import (
    BinaryExpression, CpuVal, DevVal, UnaryExpression, promote_cpu,
    promote_dev,
)


class _BitwiseBinary(BinaryExpression):
    def _compute(self, x, y):
        raise NotImplementedError

    def gpu_supported(self, conf):
        for c in (self.left, self.right):
            if not c.dtype.is_integral:
                return f"bitwise op needs integral inputs, got {c.dtype}"
        return None

    def gpu_eval(self, ctx) -> DevVal:
        a, b, out = promote_dev(self.left.gpu_eval(ctx),
                                self.right.gpu_eval(ctx))
        return DevVal(out, self._compute(a.data, b.data).to(out.torch_dtype),
                      a.validity & b.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        a, b, out = promote_cpu(self.left.cpu_eval(ctx),
                                self.right.cpu_eval(ctx))
        return CpuVal(out, self._compute(a.values, b.values)
                      .astype(out.np_dtype), a.validity & b.validity)


class BitwiseAnd(_BitwiseBinary):
    def _compute(self, x, y):
        return x & y


class BitwiseOr(_BitwiseBinary):
    def _compute(self, x, y):
        return x | y


class BitwiseXor(_BitwiseBinary):
    def _compute(self, x, y):
        return x ^ y


class BitwiseNot(UnaryExpression):
    def gpu_supported(self, conf):
        if not self.child.dtype.is_integral:
            return (f"bitwise not needs an integral input, "
                    f"got {self.child.dtype}")
        return None

    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        return DevVal(v.dtype, ~v.data, v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        return CpuVal(v.dtype, ~v.values, v.validity)


class _Shift(BinaryExpression):
    """An INT or LONG value (a BYTE or SHORT one widens to INT) shifted
    by an integral count, Java-masked."""

    def _resolve_type(self):
        self.dtype = T.LONG if self.left.dtype == T.LONG else T.INT
        self.nullable = self.left.nullable or self.right.nullable

    def gpu_supported(self, conf):
        if self.left.dtype not in (T.BYTE, T.SHORT, T.INT, T.LONG):
            return f"shift needs an integral value, got {self.left.dtype}"
        if not self.right.dtype.is_integral:
            return f"shift amount must be integral, got {self.right.dtype}"
        return None

    @property
    def _bits(self) -> int:
        return 64 if self.dtype == T.LONG else 32

    def _shift_dev(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _shift_np(self, x: np.ndarray, s: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def gpu_eval(self, ctx) -> DevVal:
        a, b = self.left.gpu_eval(ctx), self.right.gpu_eval(ctx)
        x = a.data.to(self.dtype.torch_dtype)
        s = (b.data.to(torch.int32) & (self._bits - 1)).to(x.dtype)
        return DevVal(self.dtype, self._shift_dev(x, s),
                      a.validity & b.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        a, b = self.left.cpu_eval(ctx), self.right.cpu_eval(ctx)
        x = a.values.astype(self.dtype.np_dtype)
        s = (b.values.astype(np.int64) & (self._bits - 1)).astype(x.dtype)
        with np.errstate(all="ignore"):
            data = self._shift_np(x, s)
        return CpuVal(self.dtype, data.astype(self.dtype.np_dtype),
                      a.validity & b.validity)


class ShiftLeft(_Shift):
    def _shift_dev(self, x, s):
        return x << s

    def _shift_np(self, x, s):
        return x << s


class ShiftRight(_Shift):
    """Arithmetic shift (Java ``>>``): the sign bit fills in."""

    def _shift_dev(self, x, s):
        return x >> s

    def _shift_np(self, x, s):
        return x >> s


class ShiftRightUnsigned(_Shift):
    """Logical shift (Java ``>>>``): zeros fill in."""

    def _shift_dev(self, x, s):
        if self.dtype == T.INT:
            u = x.to(torch.int64) & 0xFFFFFFFF   # the zero-extended bits
            return (u >> s.to(torch.int64)).to(torch.int32)
        # arithmetic shift, then the s sign-filled top bits cleared
        keep = (torch.ones_like(x) << (64 - s).clamp(max=63)) - 1
        return torch.where(s == 0, x, (x >> s) & keep)

    def _shift_np(self, x, s):
        udt = np.uint64 if self.dtype == T.LONG else np.uint32
        return (x.view(udt) >> s.view(udt)).view(x.dtype)
