"""CAST (port of the device casts of ``spark_rapids_tpu/exprs/cast.py``):
between numeric types with Java narrowing semantics, boolean to and from
numeric, date and timestamp.

Double (or float) to an integral type: NaN becomes 0, values at or past the
target's bounds (±inf too) saturate at them, the rest truncates toward
zero.  Converting NaN or an out-of-range float to an integer is undefined
in CUDA, so the out-of-range lanes are masked to 0 before the conversion
and get their bounds after it.  A cast to or from a string runs on the CPU
in the JAX package; the port has no CPU fallback yet, so the planner
refuses it.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import (
    DevVal, Expression, UnaryExpression,
)

_INT_BOUNDS = {
    T.BYTE: (-(2 ** 7), 2 ** 7 - 1),
    T.SHORT: (-(2 ** 15), 2 ** 15 - 1),
    T.INT: (-(2 ** 31), 2 ** 31 - 1),
    T.LONG: (-(2 ** 63), 2 ** 63 - 1),
}
_US_PER_DAY = 86_400_000_000


class Cast(UnaryExpression):
    def __init__(self, child: Expression, to: T.DataType):
        self.to = to
        super().__init__(child)

    def with_children(self, children):
        return Cast(children[0], self.to)

    def _resolve_type(self):
        self.dtype = self.to
        self.nullable = self.child.nullable or (
            self.child.dtype.is_string and not self.to.is_string)

    @property
    def name(self):
        return f"Cast(->{self.to})"

    def gpu_supported(self, conf):
        src, dst = self.child.dtype, self.to
        if src != dst and (src.is_string or dst.is_string):
            return (f"{self.name}: a cast from {src} to {dst} runs on the "
                    "CPU, whose fallback is not ported yet")
        return None

    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        src, dst = v.dtype, self.to
        if src == dst:
            return v
        data = v.data
        if src == T.BOOLEAN:
            data = data.to(dst.torch_dtype)
        elif src.is_fractional and dst.is_integral:
            lo, hi = _INT_BOUNDS[dst]
            over = data >= float(hi)        # +inf included
            under = data <= float(lo)       # -inf included
            off = over | under | torch.isnan(data)
            conv = torch.trunc(data.masked_fill(off, 0.0)).to(
                dst.torch_dtype)
            data = conv.masked_fill(over, hi).masked_fill(under, lo)
        elif dst == T.BOOLEAN:
            data = data != 0
        elif src == T.DATE and dst == T.TIMESTAMP:
            data = data.to(torch.int64) * _US_PER_DAY
        elif src == T.TIMESTAMP and dst == T.DATE:
            data = torch.div(data, _US_PER_DAY,
                             rounding_mode="floor").to(torch.int32)
        elif src == T.TIMESTAMP and dst.is_numeric:
            data = torch.div(data, 1_000_000,
                             rounding_mode="floor").to(dst.torch_dtype)
        elif src.is_numeric and dst == T.TIMESTAMP:
            data = (data.to(torch.float64) * 1e6).to(torch.int64) \
                if src.is_fractional else data.to(torch.int64) * 1_000_000
        else:
            data = data.to(dst.torch_dtype)
        return DevVal(dst, data, v.validity)
