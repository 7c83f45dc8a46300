"""Column functions (port of the part of ``spark_rapids_tpu/functions.py``
the slice needs)."""

from __future__ import annotations

from spark_rapids_tpu_torch.dataframe import Column, _to_expr
from spark_rapids_tpu_torch.exprs import aggregates as A
from spark_rapids_tpu_torch.exprs.base import ColumnRef


def col(name: str) -> Column:
    return Column(ColumnRef(name))


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
