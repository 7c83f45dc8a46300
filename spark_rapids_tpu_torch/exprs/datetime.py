"""Date expressions (port of the date part of
``spark_rapids_tpu/exprs/datetime.py``): the date parts ``year``, ``month``,
``dayofmonth``, ``dayofweek``, ``dayofyear``, ``quarter`` and ``weekday``,
``date_add``, ``date_sub`` and ``datediff``, and ``to_date``.

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
``date_format``, ``last_day`` and timestamp arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import (
    BinaryExpression, CpuVal, DevVal, Expression, UnaryExpression,
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


_JAVA_TO_STRPTIME = [("yyyy", "%Y"), ("MM", "%m"), ("dd", "%d"),
                     ("HH", "%H"), ("mm", "%M"), ("ss", "%S")]
_JAVA_TOKENS = {j for j, _ in _JAVA_TO_STRPTIME}


def _java_fmt_to_strptime(fmt: str) -> str:
    """The supported subset of a Java date format as a strptime one; any
    other letter token raises (a blind replace would turn MMM into %mM
    and make every row NULL)."""
    import re
    for tok in re.findall(r"[A-Za-z]+", fmt):
        if tok not in _JAVA_TOKENS:
            raise ValueError(
                f"unsupported date format token {tok!r} in {fmt!r}; "
                f"supported: {sorted(_JAVA_TOKENS)}")
    out = fmt
    for j, p in _JAVA_TO_STRPTIME:
        out = out.replace(j, p)
    return out


def _render_strptime(dt, pat: str) -> str:
    """A parsed date rendered back in ``pat``, zero-padded (strict
    parsing: strptime also takes unpadded fields)."""
    return (pat.replace("%Y", f"{dt.year:04d}")
            .replace("%m", f"{dt.month:02d}")
            .replace("%d", f"{dt.day:02d}")
            .replace("%H", f"{dt.hour:02d}")
            .replace("%M", f"{dt.minute:02d}")
            .replace("%S", f"{dt.second:02d}"))


def _parse_iso_dates(data: torch.Tensor, offsets: torch.Tensor):
    """(days int32, parsed bool, year) of every row of a string column
    read as ``yyyy-MM-dd``: ten bytes, digits at fixed positions, dashes
    at 4 and 7, a real calendar day (the (y, m, d) round trip through
    the day count must come back unchanged: Feb 30 does not)."""
    nbytes = int(data.shape[0])
    starts = offsets[:-1].to(torch.int64)
    lens = offsets[1:] - offsets[:-1]
    pos = torch.arange(10, dtype=torch.int64, device=data.device)
    idx = (starts[:, None] + pos[None, :]).clamp(0, max(nbytes - 1, 0))
    ch = data[idx].to(torch.int64)                     # [cap, 10]
    digit = (ch >= 48) & (ch <= 57)
    ok = lens == 10
    for p in (0, 1, 2, 3, 5, 6, 8, 9):
        ok = ok & digit[:, p]
    ok = ok & (ch[:, 4] == 45) & (ch[:, 7] == 45)
    d10 = ch - 48
    y = d10[:, 0] * 1000 + d10[:, 1] * 100 + d10[:, 2] * 10 + d10[:, 3]
    m = d10[:, 5] * 10 + d10[:, 6]
    d = d10[:, 8] * 10 + d10[:, 9]
    ok = ok & (m >= 1) & (m <= 12) & (d >= 1) & (d <= 31)
    days = days_from_civil(y, m.clamp(min=1), d.clamp(min=1))
    y2, m2, d2 = civil_from_days(days)
    ok = ok & (y2 == y) & (m2 == m) & (d2 == d)
    return days.to(torch.int32), ok, y


class ToDate(UnaryExpression):
    """to_date(str[, fmt]) -> DATE; a string that does not parse gives
    NULL (Spark's ParseToDate).  The default ``yyyy-MM-dd`` parses on the
    device by fixed-position digits over the byte buffer; another format
    runs on the host through strptime.  A DATE input is returned as it
    is.  The host twin parses the default format by the same digits but
    refuses year 0, which strptime (the JAX package's twin) cannot
    represent; the device, as the JAX package's, takes it."""

    FMT = "yyyy-MM-dd"

    def __init__(self, child: Expression, fmt: str = FMT):
        self.fmt = str(fmt)
        super().__init__(child)

    def with_children(self, children):
        return ToDate(children[0], self.fmt)

    def _resolve_type(self):
        self.dtype = T.DATE
        self.nullable = True

    def gpu_supported(self, conf):
        if self.child.dtype == T.DATE:
            return None
        if not (self.child.dtype.is_string or self.child.dtype == T.NULL):
            return f"to_date over {self.child.dtype} runs on the host"
        if self.fmt != self.FMT:
            return f"to_date format {self.fmt!r} runs on the host"
        return None

    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        if v.dtype == T.DATE:
            return v
        if v.offsets is None:  # a NULL literal
            zeros = torch.zeros(ctx.capacity, dtype=torch.int32,
                                device=ctx.device)
            return DevVal(T.DATE, zeros, zeros.to(torch.bool))
        days, ok, _ = _parse_iso_dates(v.data, v.offsets)
        return DevVal(T.DATE, days, v.validity & ok)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        if v.dtype == T.DATE:
            return v
        n = len(v.values)
        if v.dtype == T.NULL:
            return CpuVal(T.DATE, np.zeros(n, dtype=np.int32),
                          np.zeros(n, dtype=np.bool_))
        if self.fmt == self.FMT:
            from spark_rapids_tpu_torch.batch import _string_host_to_buffers
            offsets, data = _string_host_to_buffers(
                np.asarray(v.values), v.validity)
            days, ok, y = _parse_iso_dates(torch.from_numpy(data),
                                           torch.from_numpy(offsets))
            valid = v.validity & (ok & (y >= 1)).numpy()
            return CpuVal(T.DATE, np.where(valid, days.numpy(), 0)
                          .astype(np.int32), valid)
        return self._strptime(v)

    def _strptime(self, v: CpuVal) -> CpuVal:
        import datetime as _dt
        pat = _java_fmt_to_strptime(self.fmt)
        out = np.zeros(len(v.values), dtype=np.int32)
        valid = np.array(v.validity, dtype=np.bool_)
        epoch = _dt.date(1970, 1, 1)
        for i, s in enumerate(v.values):
            if not valid[i]:
                continue
            try:
                dt = _dt.datetime.strptime(str(s), pat)
            except ValueError:
                valid[i] = False
                continue
            if _render_strptime(dt, pat) != str(s):
                valid[i] = False
                continue
            out[i] = (dt.date() - epoch).days
        return CpuVal(T.DATE, out, valid)
