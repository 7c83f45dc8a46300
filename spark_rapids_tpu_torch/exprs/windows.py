"""Window expressions (port of ``spark_rapids_tpu/exprs/windows.py``).

The window exec (``ops/window.py``) sorts a partition once by (partition
keys, order keys), derives the partition segments and peer blocks, and
computes every function with prefix sums and scans over the sorted rows.

Frames: ROWS and RANGE from UNBOUNDED PRECEDING to CURRENT ROW (a RANGE
frame runs to the last peer), UNBOUNDED to UNBOUNDED (the whole
partition), bounded value RANGE (x PRECEDING to y FOLLOWING) over one
numeric, date or timestamp order key (a binary search in the sorted span;
NULL and NaN keys frame over their peer blocks), and bounded ROWS frames
for sum, count, avg, min and max (min and max through a sparse table).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.aggregates import AggregateFunction
from spark_rapids_tpu_torch.exprs.base import Expression, SortOrder

UNBOUNDED = None
CURRENT_ROW = 0


@dataclasses.dataclass(frozen=True)
class WindowFrame:
    """``kind`` is "rows" or "range"; ``start`` and ``end`` are offsets
    from the current row (negative: preceding), None unbounded."""

    kind: str = "range"
    start: Optional[int] = UNBOUNDED
    end: Optional[int] = CURRENT_ROW

    @property
    def is_unbounded_whole(self) -> bool:
        return self.start is None and self.end is None

    @property
    def is_running(self) -> bool:
        return self.start is None and self.end == 0


class WindowFunction(Expression):
    """Base of the ranking and offset window functions."""

    needs_order = True


class RowNumber(WindowFunction):
    def __init__(self):
        self.children = ()
        self.dtype = T.INT
        self.nullable = False

    def with_children(self, children):
        return self


class Rank(WindowFunction):
    def __init__(self):
        self.children = ()
        self.dtype = T.INT
        self.nullable = False

    def with_children(self, children):
        return self


class DenseRank(WindowFunction):
    def __init__(self):
        self.children = ()
        self.dtype = T.INT
        self.nullable = False

    def with_children(self, children):
        return self


class Lag(WindowFunction):
    """The value ``offset`` rows before the current one in its partition,
    else ``default`` (NULL without one)."""

    def __init__(self, child: Expression, offset: int = 1,
                 default: Optional[Expression] = None):
        self.children = (child,) if default is None else (child, default)
        self.offset = int(offset)
        self.dtype = child.dtype
        self.nullable = True

    def with_children(self, children):
        d = children[1] if len(children) > 1 else None
        return type(self)(children[0], self.offset, d)


class Lead(Lag):
    """The value ``offset`` rows after the current one."""


class WindowExpression(Expression):
    """function OVER (PARTITION BY ... ORDER BY ... frame).  Without a
    frame: RANGE UNBOUNDED PRECEDING to CURRENT ROW with an ORDER BY, the
    whole partition without one (Spark's defaults)."""

    def __init__(self, function: Expression,
                 partition_by: List[Expression],
                 order_by: List[SortOrder],
                 frame: Optional[WindowFrame] = None):
        self.function = function
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        if frame is None:
            frame = WindowFrame("range", UNBOUNDED, CURRENT_ROW) \
                if order_by else WindowFrame("rows", UNBOUNDED, UNBOUNDED)
        self.frame = frame
        self.children = (function,) + tuple(partition_by) + \
            tuple(o.child for o in order_by)
        self.dtype = function.dtype
        self.nullable = True

    def with_children(self, children):
        nf = children[0]
        np_ = children[1:1 + len(self.partition_by)]
        no = children[1 + len(self.partition_by):]
        orders = [SortOrder(c, o.ascending, o.nulls_first)
                  for c, o in zip(no, self.order_by)]
        return WindowExpression(nf, list(np_), orders, self.frame)

    @property
    def name(self):
        return f"WindowExpression({self.function.name})"

    def gpu_supported(self, conf) -> Optional[str]:
        """None where the device window exec computes this expression,
        else the reason (the planner's placement reason for the node)."""
        fn = self.function
        if isinstance(fn, (RowNumber, Rank, DenseRank)):
            if not self.order_by:
                return f"{fn.name} requires ORDER BY"
            return None
        if isinstance(fn, Lag):
            if len(fn.children) > 1 and fn.children[0].dtype.is_string:
                return (f"{fn.name} with a default value on a string "
                        f"column not supported on GPU")
            return None
        if isinstance(fn, AggregateFunction):
            from spark_rapids_tpu_torch.exprs.aggregates import (
                Average, Count, Max, Min, Sum,
            )
            if not isinstance(fn, (Sum, Count, Min, Max, Average)):
                return f"window aggregate {fn.name} not supported"
            r = fn.gpu_supported(conf)
            if r:
                return r
            if self.frame.kind == "range" and not (
                    self.frame.is_running or
                    self.frame.is_unbounded_whole):
                # a bounded value range needs exactly one numeric, date or
                # timestamp order key; the host exec raises the error
                if len(self.order_by) != 1:
                    return ("bounded RANGE frame needs exactly one "
                            "ORDER BY expression")
                kd = self.order_by[0].child.dtype
                if not kd.is_numeric and kd not in (T.DATE, T.TIMESTAMP):
                    return ("bounded RANGE frame needs a numeric "
                            "order key")
            return None
        return f"window function {fn.name} not supported"
