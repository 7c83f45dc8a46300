"""Column functions (port of ``spark_rapids_tpu/functions.py`` but for
``udf`` and ``pandas_udf``), the ``broadcast`` join hint, the window specs
(``Window``, ``WindowSpec``, ``Column.over``) with the ranking and offset
functions, and ``Column.bitwiseAND``/``bitwiseOR``/``bitwiseXOR``."""

from __future__ import annotations

from typing import Any

from spark_rapids_tpu_torch.dataframe import Column, _to_expr
from spark_rapids_tpu_torch.exprs import aggregates as A
from spark_rapids_tpu_torch.exprs import windows as W
from spark_rapids_tpu_torch.exprs.base import Alias, ColumnRef, Literal


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


mean = avg


def min(c) -> Column:  # noqa: A001
    return _agg(A.Min, c)


def max(c) -> Column:  # noqa: A001
    return _agg(A.Max, c)


def first(c, ignore_nulls: bool = False) -> Column:
    return Column(A.First(_to_expr(col(c) if isinstance(c, str) else c),
                          ignore_nulls))


def last(c, ignore_nulls: bool = False) -> Column:
    return Column(A.Last(_to_expr(col(c) if isinstance(c, str) else c),
                         ignore_nulls))


def stddev(c) -> Column:
    return _agg(A.StddevSamp, c)


stddev_samp = stddev


def stddev_pop(c) -> Column:
    return _agg(A.StddevPop, c)


def variance(c) -> Column:
    return _agg(A.VarianceSamp, c)


var_samp = variance


def var_pop(c) -> Column:
    return _agg(A.VariancePop, c)


def _binstat(cls, x, y) -> Column:
    x = col(x) if isinstance(x, str) else x
    y = col(y) if isinstance(y, str) else y
    return Column(cls(_to_expr(x), _to_expr(y)))


def corr(x, y) -> Column:
    """Pearson correlation: rewritten by ``GroupedData.agg``."""
    return _binstat(A.Corr, x, y)


def covar_pop(x, y) -> Column:
    return _binstat(A.CovarPop, x, y)


def covar_samp(x, y) -> Column:
    return _binstat(A.CovarSamp, x, y)


def grouping_id() -> Column:
    """The bitmask of the keys a rollup, cube or grouping-sets row
    masked out."""
    return Column(A.GroupingID())


def percentile(c, percentage: float) -> Column:
    """Exact percentile with linear interpolation (Spark's
    ``percentile``), rewritten by ``GroupedData.agg`` into ranks and a
    sum."""
    return Column(A.Percentile(
        _to_expr(col(c) if isinstance(c, str) else c), percentage))


def count_distinct(c) -> Column:
    """count(DISTINCT c): rewritten by ``GroupedData.agg`` into two
    stacked aggregations."""
    return _agg(A.CountDistinct, c)


countDistinct = count_distinct


# -- scalar functions --------------------------------------------------------


def _unary(cls, c) -> Column:
    return Column(cls(_to_expr(col(c) if isinstance(c, str) else c)))


def abs(c) -> Column:  # noqa: A001
    from spark_rapids_tpu_torch.exprs.arithmetic import Abs
    return _unary(Abs, c)


def sqrt(c) -> Column:
    from spark_rapids_tpu_torch.exprs.mathexprs import Sqrt
    return _unary(Sqrt, c)


def exp(c) -> Column:
    from spark_rapids_tpu_torch.exprs.mathexprs import Exp
    return _unary(Exp, c)


def log(c) -> Column:
    from spark_rapids_tpu_torch.exprs.mathexprs import Log
    return _unary(Log, c)


def floor(c) -> Column:
    """DOUBLE, as the JAX package's (Spark gives LONG)."""
    from spark_rapids_tpu_torch.exprs.mathexprs import Floor
    return _unary(Floor, c)


def ceil(c) -> Column:
    """DOUBLE, as the JAX package's (Spark gives LONG)."""
    from spark_rapids_tpu_torch.exprs.mathexprs import Ceil
    return _unary(Ceil, c)


def round(c, scale: int = 0) -> Column:  # noqa: A001
    from spark_rapids_tpu_torch.exprs.mathexprs import Round
    return Column(Round(_to_expr(col(c) if isinstance(c, str) else c),
                        scale))


def pow(b, e) -> Column:  # noqa: A001
    from spark_rapids_tpu_torch.exprs.mathexprs import Pow
    return Column(Pow(_to_expr(b), _to_expr(e)))


def sinh(c) -> Column:
    from spark_rapids_tpu_torch.exprs.mathexprs import Sinh
    return _unary(Sinh, c)


def cosh(c) -> Column:
    from spark_rapids_tpu_torch.exprs.mathexprs import Cosh
    return _unary(Cosh, c)


def tanh(c) -> Column:
    from spark_rapids_tpu_torch.exprs.mathexprs import Tanh
    return _unary(Tanh, c)


def cot(c) -> Column:
    from spark_rapids_tpu_torch.exprs.mathexprs import Cot
    return _unary(Cot, c)


def coalesce(*cols) -> Column:
    from spark_rapids_tpu_torch.exprs.nullexprs import Coalesce
    return Column(Coalesce(*[_to_expr(c) for c in cols]))


def isnull(c) -> Column:
    from spark_rapids_tpu_torch.exprs.nullexprs import IsNull
    return _unary(IsNull, c)


def isnan(c) -> Column:
    from spark_rapids_tpu_torch.exprs.nullexprs import IsNan
    return _unary(IsNan, c)


def to_date(c, fmt: str = "yyyy-MM-dd") -> Column:
    from spark_rapids_tpu_torch.exprs.datetime import ToDate
    return Column(ToDate(_to_expr(col(c) if isinstance(c, str) else c),
                         fmt))


def hash(*cols) -> Column:  # noqa: A001
    """Spark's murmur3 hash (seed 42) of the columns, INT."""
    from spark_rapids_tpu_torch.exprs.hashing import Murmur3Hash
    return Column(Murmur3Hash(*[_to_expr(
        col(c) if isinstance(c, str) else c) for c in cols]))


def array(*cols) -> Column:
    from spark_rapids_tpu_torch.exprs.misc import CreateArray
    return Column(CreateArray(*[_to_expr(
        col(c) if isinstance(c, str) else c) for c in cols]))


def broadcast(df):
    """The join hint: the planner broadcasts this side of a join."""
    from spark_rapids_tpu_torch.dataframe import DataFrame
    from spark_rapids_tpu_torch.plan import logical as L
    return DataFrame(L.BroadcastHint(df.plan), df.session)


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


def _c(c):
    return _to_expr(col(c) if isinstance(c, str) else c)


def weekday(c) -> Column:
    from spark_rapids_tpu_torch.exprs.datetime import WeekDay
    return _unary(WeekDay, c)


def date_format(c, fmt: str = "yyyy-MM-dd") -> Column:
    from spark_rapids_tpu_torch.exprs.datetime import DateFormat
    return Column(DateFormat(_c(c), fmt))


def unix_timestamp(c) -> Column:
    from spark_rapids_tpu_torch.exprs.datetime import UnixTimestamp
    return _unary(UnixTimestamp, c)


def from_unixtime(c, fmt: str = "yyyy-MM-dd HH:mm:ss") -> Column:
    from spark_rapids_tpu_torch.exprs.datetime import FromUnixTime
    return Column(FromUnixTime(_c(c), fmt))


# -- strings -----------------------------------------------------------------


def length(c) -> Column:
    from spark_rapids_tpu_torch.exprs.strings import Length
    return _unary(Length, c)


def upper(c) -> Column:
    from spark_rapids_tpu_torch.exprs.strings import Upper
    return _unary(Upper, c)


def lower(c) -> Column:
    from spark_rapids_tpu_torch.exprs.strings import Lower
    return _unary(Lower, c)


def initcap(c) -> Column:
    from spark_rapids_tpu_torch.exprs.strings import InitCap
    return _unary(InitCap, c)


def trim(c) -> Column:
    from spark_rapids_tpu_torch.exprs.strings import StringTrim
    return _unary(StringTrim, c)


def concat(*cols) -> Column:
    from spark_rapids_tpu_torch.exprs.strings import ConcatStrings
    return Column(ConcatStrings(*[_c(c) for c in cols]))


def concat_ws(sep: str, *cols) -> Column:
    from spark_rapids_tpu_torch.exprs.strings import ConcatWs
    return Column(ConcatWs(sep, *[_c(c) for c in cols]))


def replace(c, search: str, replacement: str) -> Column:
    from spark_rapids_tpu_torch.exprs.strings import StringReplace
    return Column(StringReplace(_c(c), search, replacement))


def regexp_replace(c, pattern: str, replacement: str) -> Column:
    from spark_rapids_tpu_torch.exprs.strings import RegExpReplace
    return Column(RegExpReplace(_c(c), pattern, replacement))


def split(c, delimiter: str) -> Column:
    """array<string>: on the host (variable-length elements)."""
    from spark_rapids_tpu_torch.exprs.strings import StringSplit
    return Column(StringSplit(_c(c), delimiter))


def split_part(c, delimiter: str, part: int) -> Column:
    """The 1-based field between literal delimiters (Spark
    ``split_part``)."""
    from spark_rapids_tpu_torch.exprs.strings import SplitPart
    return Column(SplitPart(_c(c), delimiter, part))


def substring_index(c, delimiter: str, count: int) -> Column:
    from spark_rapids_tpu_torch.exprs.strings import SubstringIndex
    return Column(SubstringIndex(_c(c), delimiter, count))


def hex(c) -> Column:  # noqa: A001
    from spark_rapids_tpu_torch.exprs.strings import Hex
    return _unary(Hex, c)


# -- bitwise -----------------------------------------------------------------


def shiftleft(c, n) -> Column:
    from spark_rapids_tpu_torch.exprs.bitwise import ShiftLeft
    return Column(ShiftLeft(_c(c), _to_expr(n)))


def shiftright(c, n) -> Column:
    from spark_rapids_tpu_torch.exprs.bitwise import ShiftRight
    return Column(ShiftRight(_c(c), _to_expr(n)))


def shiftrightunsigned(c, n) -> Column:
    from spark_rapids_tpu_torch.exprs.bitwise import ShiftRightUnsigned
    return Column(ShiftRightUnsigned(_c(c), _to_expr(n)))


def bitwise_not(c) -> Column:
    from spark_rapids_tpu_torch.exprs.bitwise import BitwiseNot
    return _unary(BitwiseNot, c)


bitwiseNOT = bitwise_not


def _bitwise_col(self: Column, other, cls_name: str) -> Column:
    from spark_rapids_tpu_torch.exprs import bitwise as B
    return Column(getattr(B, cls_name)(self.expr, _to_expr(other)))


Column.bitwiseAND = lambda self, o: _bitwise_col(self, o, "BitwiseAnd")
Column.bitwiseOR = lambda self, o: _bitwise_col(self, o, "BitwiseOr")
Column.bitwiseXOR = lambda self, o: _bitwise_col(self, o, "BitwiseXor")


# -- arrays ------------------------------------------------------------------


def get_item(c, ordinal: int) -> Column:
    from spark_rapids_tpu_torch.exprs.misc import GetArrayItem
    return Column(GetArrayItem(_c(c), ordinal))


def size(c) -> Column:
    from spark_rapids_tpu_torch.exprs.misc import ArraySize
    return _unary(ArraySize, c)


def array_contains(c, value) -> Column:
    from spark_rapids_tpu_torch.exprs.misc import ArrayContains
    return Column(ArrayContains(_c(c), value))


def array_min(c) -> Column:
    from spark_rapids_tpu_torch.exprs.misc import ArrayMin
    return _unary(ArrayMin, c)


def array_max(c) -> Column:
    from spark_rapids_tpu_torch.exprs.misc import ArrayMax
    return _unary(ArrayMax, c)


def sort_array(c, asc: bool = True) -> Column:
    from spark_rapids_tpu_torch.exprs.misc import SortArray
    return Column(SortArray(_c(c), asc))


def array_position(c, value) -> Column:
    from spark_rapids_tpu_torch.exprs.misc import ArrayPosition
    return Column(ArrayPosition(_c(c), value))


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


# -- window ------------------------------------------------------------------


class WindowSpec:
    """PARTITION BY, ORDER BY and the frame of a window; immutable, each
    method gives a new spec."""

    def __init__(self, partition_by=None, order_by=None, frame=None):
        self._partition_by = partition_by or []
        self._order_by = order_by or []
        self._frame = frame

    def partition_by(self, *cols) -> "WindowSpec":
        exprs = [_to_expr(col(c) if isinstance(c, str) else c) for c in cols]
        return WindowSpec(exprs, self._order_by, self._frame)

    partitionBy = partition_by

    def order_by(self, *cols) -> "WindowSpec":
        from spark_rapids_tpu_torch.dataframe import _to_order
        return WindowSpec(self._partition_by, [_to_order(c) for c in cols],
                          self._frame)

    orderBy = order_by

    def _make_frame(self, kind: str, start, end) -> "WindowSpec":
        def bound(v, what):
            if v is None or v is Window.unboundedPreceding or \
                    v is Window.unboundedFollowing:
                return None
            if isinstance(v, bool) or not isinstance(v, int):
                raise TypeError(f"{kind} frame {what} bound must be an "
                                f"int, got {v!r}")
            return v
        return WindowSpec(self._partition_by, self._order_by,
                          W.WindowFrame(kind, bound(start, "start"),
                                        bound(end, "end")))

    def rows_between(self, start, end) -> "WindowSpec":
        return self._make_frame("rows", start, end)

    rowsBetween = rows_between

    def range_between(self, start, end) -> "WindowSpec":
        """A value frame over the single numeric order key (RANGE BETWEEN
        x PRECEDING AND y FOLLOWING)."""
        return self._make_frame("range", start, end)

    rangeBetween = range_between


class Window:
    unboundedPreceding = object()
    unboundedFollowing = object()
    currentRow = 0

    @staticmethod
    def partition_by(*cols) -> WindowSpec:
        return WindowSpec().partition_by(*cols)

    partitionBy = partition_by

    @staticmethod
    def order_by(*cols) -> WindowSpec:
        return WindowSpec().order_by(*cols)

    orderBy = order_by


class _OverColumn(Column):
    pass


def _over(self: Column, spec: WindowSpec) -> Column:
    """``fn.over(spec)``: the function as a window expression (an alias
    stays outside it)."""
    e, name = self.expr, None
    if isinstance(e, Alias):
        name, e = e.alias_name, e.children[0]
    w = W.WindowExpression(e, spec._partition_by, spec._order_by,
                           spec._frame)
    return Column(Alias(w, name) if name else w)


Column.over = _over  # type: ignore[attr-defined]


def row_number() -> Column:
    return Column(W.RowNumber())


def rank() -> Column:
    return Column(W.Rank())


def dense_rank() -> Column:
    return Column(W.DenseRank())


def lag(c, offset: int = 1, default=None) -> Column:
    e = _to_expr(col(c) if isinstance(c, str) else c)
    d = None if default is None else _to_expr(default)
    return Column(W.Lag(e, offset, d))


def lead(c, offset: int = 1, default=None) -> Column:
    e = _to_expr(col(c) if isinstance(c, str) else c)
    d = None if default is None else _to_expr(default)
    return Column(W.Lead(e, offset, d))


def monotonically_increasing_id() -> Column:
    from spark_rapids_tpu_torch.exprs.misc import MonotonicallyIncreasingID
    return Column(MonotonicallyIncreasingID())


def spark_partition_id() -> Column:
    from spark_rapids_tpu_torch.exprs.misc import SparkPartitionID
    return Column(SparkPartitionID())


def rand(seed: int = 42) -> Column:
    from spark_rapids_tpu_torch.exprs.misc import Rand
    return Column(Rand(seed))
