"""CAST (port of the device casts of ``spark_rapids_tpu/exprs/cast.py``):
between numeric types with Java narrowing semantics, boolean to and from
numeric, date and timestamp.

Double (or float) to an integral type: NaN becomes 0, values at or past the
target's bounds (±inf too) saturate at them, the rest truncates toward
zero.  Converting NaN or an out-of-range float to an integer is undefined
in CUDA, so the out-of-range lanes are masked to 0 before the conversion
and get their bounds after it.  A cast to or from a string runs on the
host twin ``cpu_eval`` only, as in the JAX package; ``cpu_eval`` is that
package's twin step for step (NaN to "NaN", a whole double to "x.0", a
string that does not parse to NULL).
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import (
    CpuVal, DevVal, Expression, UnaryExpression,
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
            return (f"{self.name}: a cast from {src} to {dst} involves a "
                    "string conversion (CPU only)")
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

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        src, dst = v.dtype, self.to
        if src == dst:
            return v
        validity = v.validity.copy()
        with np.errstate(all="ignore"):
            if src.is_string:
                values, validity = _cast_from_string(v, dst)
            elif dst.is_string:
                values = np.array([_to_string(x, src) for x in v.values],
                                  dtype=object)
            elif src == T.BOOLEAN:
                values = v.values.astype(dst.np_dtype)
            elif src.is_fractional and dst.is_integral:
                lo, hi = _INT_BOUNDS[dst]
                x = np.nan_to_num(v.values.astype(np.float64), nan=0.0,
                                  posinf=float(hi), neginf=float(lo))
                values = np.trunc(np.clip(x, float(lo), float(hi))).astype(
                    dst.np_dtype)
            elif dst == T.BOOLEAN:
                values = v.values != 0
            elif src == T.DATE and dst == T.TIMESTAMP:
                values = v.values.astype(np.int64) * _US_PER_DAY
            elif src == T.TIMESTAMP and dst == T.DATE:
                values = np.floor_divide(v.values, _US_PER_DAY).astype(
                    np.int32)
            elif src == T.TIMESTAMP and dst.is_numeric:
                values = np.floor_divide(v.values, 1_000_000).astype(
                    dst.np_dtype)
            elif src.is_numeric and dst == T.TIMESTAMP:
                values = ((v.values.astype(np.float64) * 1e6).astype(
                    np.int64) if src.is_fractional
                    else v.values.astype(np.int64) * 1_000_000)
            else:
                values = v.values.astype(dst.np_dtype)
        return CpuVal(dst, values, validity)


_EPOCH_DATE = datetime.date(1970, 1, 1)
_EPOCH = datetime.datetime(1970, 1, 1)


def _to_string(x, src: T.DataType) -> str:
    if src == T.BOOLEAN:
        return "true" if x else "false"
    if src.is_integral:
        return str(int(x))
    if src.is_fractional:
        f = float(x)
        if f != f:
            return "NaN"
        if f in (float("inf"), float("-inf")):
            # Spark's text; the JAX package's twin raises OverflowError
            return "Infinity" if f > 0 else "-Infinity"
        if f == int(f) and abs(f) < 1e16:
            return f"{f:.1f}"
        return repr(f)
    if src == T.DATE:
        try:
            return (_EPOCH_DATE + datetime.timedelta(days=int(x))
                    ).isoformat()
        except OverflowError:  # past Python's years 1-9999
            from spark_rapids_tpu_torch.exprs.datetime import (
                civil_from_days,
            )
            y, m, d = (int(v) for v in civil_from_days(
                torch.tensor([int(x)])))
            return f"{y:04d}-{m:02d}-{d:02d}"
    if src == T.TIMESTAMP:
        dt = _EPOCH + datetime.timedelta(microseconds=int(x))
        return dt.strftime("%Y-%m-%d %H:%M:%S")
    return str(x)


def _cast_from_string(v: CpuVal, dst: T.DataType):
    out_validity = v.validity.copy()
    values = np.zeros(len(v.values),
                      dtype=object if dst.is_string else dst.np_dtype)
    for i, (s, ok) in enumerate(zip(v.values, v.validity)):
        if not ok:
            continue
        s = str(s).strip()
        try:
            if dst == T.BOOLEAN:
                low = s.lower()
                if low in ("true", "t", "yes", "y", "1"):
                    values[i] = True
                elif low in ("false", "f", "no", "n", "0"):
                    values[i] = False
                else:
                    out_validity[i] = False
            elif dst.is_integral:
                values[i] = dst.np_dtype(int(float(s)) if "." in s
                                         else int(s))
            elif dst.is_fractional:
                values[i] = dst.np_dtype(float(s))
            elif dst == T.DATE:
                d = datetime.date.fromisoformat(s[:10])
                values[i] = (d - _EPOCH_DATE).days
            elif dst == T.TIMESTAMP:
                dt = datetime.datetime.fromisoformat(s)
                values[i] = int((dt - _EPOCH).total_seconds() * 1e6)
            else:
                values[i] = s
        except (ValueError, OverflowError):
            out_validity[i] = False
    return values, out_validity
