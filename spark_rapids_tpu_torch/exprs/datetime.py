"""Date expressions (port of the date part of
``spark_rapids_tpu/exprs/datetime.py``): the date parts ``year``, ``month``,
``dayofmonth``, ``dayofweek``, ``dayofyear``, ``quarter`` and ``weekday``,
and ``date_add``, ``date_sub`` and ``datediff``.

A DATE is int32 days since 1970-01-01; a TIMESTAMP is int64 UTC
microseconds, whose day is the floor of micros / 86,400,000,000.  The
calendar comes from the branch-free civil-from-days algorithm, integer
only.  Every division floors (``torch.div(..., rounding_mode="floor")``,
numpy's ``floor_divide``): days before 1970 are negative, and a truncating
division would put them in the wrong year.

The host twins (``cpu_eval``) run the same integer formulas over the
host's numpy arrays (wrapped as CPU tensors), which is what the JAX
package's numpy twins compute.

Not ported yet: the time parts (hour, minute, second), unix time,
``to_date``, ``date_format``, ``last_day`` and timestamp arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import (
    BinaryExpression, CpuVal, DevVal, UnaryExpression,
)

MICROS_PER_DAY = 86_400_000_000


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(days: torch.Tensor):
    """Days since the epoch -> (year, month, day), int64 tensors."""
    z = days.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor
                    ) -> torch.Tensor:
    """(year, month, day) -> days since the epoch, int64."""
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = m + torch.where(m > 2, -3, 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _days_of(v: DevVal) -> torch.Tensor:
    if v.dtype == T.TIMESTAMP:
        return _fdiv(v.data, MICROS_PER_DAY)
    return v.data


def _host_tensor(v: CpuVal) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(v.values))


class _DatePart(UnaryExpression):
    """An INT part of a DATE or TIMESTAMP, NULL where the input is."""

    def _resolve_type(self):
        self.dtype = T.INT
        self.nullable = self.child.nullable

    def _part(self, days: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def gpu_supported(self, conf):
        if self.child.dtype.is_string:
            return f"{self.name}: a string input is not ported yet"
        return None

    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        return DevVal(T.INT, self._part(_days_of(v)).to(torch.int32),
                      v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        days = _days_of(DevVal(v.dtype, _host_tensor(v), None))
        return CpuVal(T.INT, self._part(days).to(torch.int32).numpy(),
                      v.validity)


class Year(_DatePart):
    def _part(self, days):
        return civil_from_days(days)[0]


class Month(_DatePart):
    def _part(self, days):
        return civil_from_days(days)[1]


class DayOfMonth(_DatePart):
    def _part(self, days):
        return civil_from_days(days)[2]


class DayOfWeek(_DatePart):
    """1 = Sunday ... 7 = Saturday (1970-01-01 was a Thursday, 5)."""

    def _part(self, days):
        return torch.remainder(days.to(torch.int64) + 4, 7) + 1


class DayOfYear(_DatePart):
    def _part(self, days):
        y = civil_from_days(days)[0]
        one = torch.ones_like(y)
        return days.to(torch.int64) - days_from_civil(y, one, one) + 1


class Quarter(_DatePart):
    def _part(self, days):
        return _fdiv(civil_from_days(days)[1] - 1, 3) + 1


class WeekDay(_DatePart):
    """0 = Monday ... 6 = Sunday (``dayofweek`` is the 1 = Sunday form)."""

    def _part(self, days):
        return torch.remainder(days + 3, 7)


class _DateArith(BinaryExpression):
    """A DATE or INT result from a date and a day count or two dates, NULL
    where either input is.  int32 arithmetic wraps, as the JAX package's
    does."""

    out_type = T.DATE

    def _resolve_type(self):
        self.dtype = self.out_type
        self.nullable = self.left.nullable or self.right.nullable

    def gpu_supported(self, conf):
        for c in self.children:
            if c.dtype.is_string:
                return f"{self.name}: a string input is not ported yet"
        return None

    def _combine(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def gpu_eval(self, ctx) -> DevVal:
        a, b = self.left.gpu_eval(ctx), self.right.gpu_eval(ctx)
        return DevVal(self.out_type, self._combine(a.data, b.data),
                      a.validity & b.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        a, b = self.left.cpu_eval(ctx), self.right.cpu_eval(ctx)
        data = self._combine(_host_tensor(a), _host_tensor(b))
        return CpuVal(self.out_type, data.numpy(), a.validity & b.validity)


class DateAdd(_DateArith):
    def _combine(self, a, b):
        return (a + b.to(torch.int32)).to(torch.int32)


class DateSub(_DateArith):
    def _combine(self, a, b):
        return (a - b.to(torch.int32)).to(torch.int32)


class DateDiff(_DateArith):
    out_type = T.INT

    def _combine(self, a, b):
        return (a - b).to(torch.int32)
