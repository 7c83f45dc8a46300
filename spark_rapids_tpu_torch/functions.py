"""Column functions (port of the part of ``spark_rapids_tpu/functions.py``
whose expressions are ported)."""

from __future__ import annotations

from typing import Any

from spark_rapids_tpu_torch.dataframe import Column, _to_expr
from spark_rapids_tpu_torch.exprs import aggregates as A
from spark_rapids_tpu_torch.exprs.base import ColumnRef, Literal


def col(name: str) -> Column:
    return Column(ColumnRef(name))


def lit(value: Any) -> Column:
    return Column(Literal(value))


def _agg(cls, c) -> Column:
    return Column(cls(_to_expr(col(c) if isinstance(c, str) else c)))


def sum(c) -> Column:  # noqa: A001
    return _agg(A.Sum, c)


def count(c) -> Column:
    if isinstance(c, str) and c == "*":
        return Column(A.count_star())
    return _agg(A.Count, c)


def avg(c) -> Column:
    return _agg(A.Average, c)


def min(c) -> Column:  # noqa: A001
    return _agg(A.Min, c)


def max(c) -> Column:  # noqa: A001
    return _agg(A.Max, c)


def count_distinct(c) -> Column:
    """count(DISTINCT c): rewritten by ``GroupedData.agg`` into two
    stacked aggregations."""
    return _agg(A.CountDistinct, c)


countDistinct = count_distinct


# -- scalar functions --------------------------------------------------------


def _unary(cls, c) -> Column:
    return Column(cls(_to_expr(col(c) if isinstance(c, str) else c)))


def year(c) -> Column:
    from spark_rapids_tpu_torch.exprs.datetime import Year
    return _unary(Year, c)


def month(c) -> Column:
    from spark_rapids_tpu_torch.exprs.datetime import Month
    return _unary(Month, c)


def dayofmonth(c) -> Column:
    from spark_rapids_tpu_torch.exprs.datetime import DayOfMonth
    return _unary(DayOfMonth, c)


def substring(c, pos: int, length: int) -> Column:
    from spark_rapids_tpu_torch.exprs.strings import Substring
    return Column(Substring(_to_expr(col(c) if isinstance(c, str) else c),
                            pos, length))


# -- CASE WHEN --------------------------------------------------------------


def when(condition, value) -> "CaseBuilder":
    return CaseBuilder().when(condition, value)


class CaseBuilder:
    """``when(...).when(...).otherwise(...)``: a CASE WHEN."""

    def __init__(self):
        self._branches = []

    def when(self, condition, value) -> "CaseBuilder":
        self._branches.append((_to_expr(condition), _to_expr(value)))
        return self

    def otherwise(self, value) -> Column:
        from spark_rapids_tpu_torch.exprs.conditional import CaseWhen
        return Column(CaseWhen(self._branches, _to_expr(value)))

    @property
    def column(self) -> Column:
        """The CASE with no ELSE: NULL where no branch holds."""
        from spark_rapids_tpu_torch.exprs.conditional import CaseWhen
        return Column(CaseWhen(self._branches, None))
