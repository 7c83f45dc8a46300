"""Logical plan nodes built by the DataFrame frontend (port of the part of
``spark_rapids_tpu/plan/logical.py`` the port runs)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.aggregates import AggregateExpression
from spark_rapids_tpu_torch.exprs.base import Expression, SortOrder


class LogicalPlan:
    children: Tuple["LogicalPlan", ...] = ()

    @property
    def schema(self) -> T.Schema:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__

    def describe(self) -> str:
        return self.name


class InMemoryScan(LogicalPlan):
    """Scan over host-resident batches (createDataFrame / test input)."""

    def __init__(self, batches: List, schema: T.Schema,
                 num_partitions: int = 1):
        self.batches = batches  # List[HostBatch]
        self._schema = schema
        self.num_partitions = num_partitions
        self.children = ()

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return f"InMemoryScan({self._schema})"


class FileScan(LogicalPlan):
    """File-source scan (parquet/csv/orc); decode happens on the host and
    the planner stages the batches onto the device above it."""

    def __init__(self, fmt: str, paths: List[str], schema: T.Schema,
                 options: Optional[Dict[str, Any]] = None,
                 pushed_filters: Optional[List[Expression]] = None,
                 partitions=None):
        self.fmt = fmt
        self.paths = paths
        self._schema = schema
        self.options = options or {}
        self.pushed_filters = pushed_filters or []
        # Hive-layout partition columns: (partition_schema,
        # {file: [values...]}), appended as constants per file by the scan
        self.partitions = partitions
        self.children = ()

    @property
    def schema(self):
        return self._schema

    def describe(self):
        extra = f", pushed={len(self.pushed_filters)}" \
            if self.pushed_filters else ""
        return f"FileScan({self.fmt}, {len(self.paths)} files{extra})"


class Range(LogicalPlan):
    """``session.range``: one LONG column ``id`` from ``start`` to ``end``
    (exclusive) by ``step``."""

    def __init__(self, start: int, end: int, step: int = 1,
                 num_partitions: int = 1, name: str = "id"):
        if step == 0:
            raise ValueError("range step must not be 0")
        self.start, self.end, self.step = start, end, step
        self.num_partitions = num_partitions
        self.col_name = name
        self.children = ()

    @property
    def schema(self):
        return T.Schema([T.Field(self.col_name, T.LONG)])

    def describe(self):
        return f"Range({self.start}, {self.end}, {self.step})"


class Project(LogicalPlan):
    def __init__(self, exprs: List[Expression], names: List[str],
                 child: LogicalPlan):
        self.exprs = exprs
        self.names = names
        self.children = (child,)

    @property
    def schema(self):
        return T.Schema([T.Field(n, e.dtype, e.nullable)
                         for n, e in zip(self.names, self.exprs)])

    def describe(self):
        return f"Project({', '.join(self.names)})"


class Filter(LogicalPlan):
    def __init__(self, condition: Expression, child: LogicalPlan):
        self.condition = condition
        self.children = (child,)

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return f"Filter({self.condition!r})"


class Aggregate(LogicalPlan):
    """Groupby aggregation; empty ``keys`` = global reduction."""

    def __init__(self, keys: List[Expression], key_names: List[str],
                 aggs: List[AggregateExpression], child: LogicalPlan):
        self.keys = keys
        self.key_names = key_names
        self.aggs = aggs
        self.children = (child,)

    @property
    def schema(self):
        fields = [T.Field(n, e.dtype, e.nullable)
                  for n, e in zip(self.key_names, self.keys)]
        fields += [T.Field(a.output_name, a.dtype, True) for a in self.aggs]
        return T.Schema(fields)

    def describe(self):
        return (f"Aggregate(keys=[{', '.join(self.key_names)}], "
                f"aggs=[{', '.join(a.output_name for a in self.aggs)}])")


class Sort(LogicalPlan):
    def __init__(self, orders: List[SortOrder], is_global: bool,
                 child: LogicalPlan):
        self.orders = orders
        self.is_global = is_global
        self.children = (child,)

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        g = "global" if self.is_global else "local"
        return f"Sort({g}, {len(self.orders)} keys)"


class Join(LogicalPlan):
    JOIN_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti",
                  "cross")

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_keys: List[Expression], right_keys: List[Expression],
                 how: str, condition: Optional[Expression] = None):
        if how not in self.JOIN_TYPES:
            raise ValueError(f"unknown join type {how!r}")
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.how = how
        self.condition = condition
        self.children = (left, right)

    @property
    def schema(self):
        left, right = self.children
        if self.how in ("left_semi", "left_anti"):
            return left.schema
        lfields = list(left.schema.fields)
        rfields = list(right.schema.fields)
        if self.how in ("left", "full"):
            rfields = [T.Field(f.name, f.dtype, True) for f in rfields]
        if self.how in ("right", "full"):
            lfields = [T.Field(f.name, f.dtype, True) for f in lfields]
        return T.Schema(lfields + rfields)

    def describe(self):
        return f"Join({self.how})"


class Union(LogicalPlan):
    """UNION ALL of children whose column types agree (names from the
    first)."""

    def __init__(self, children: List[LogicalPlan]):
        self.children = tuple(children)
        s0 = self.children[0].schema
        for c in self.children[1:]:
            if [f.dtype for f in c.schema.fields] != \
                    [f.dtype for f in s0.fields]:
                raise ValueError(f"union schema mismatch: {c.schema} "
                                 f"against {s0}")

    @property
    def schema(self):
        return self.children[0].schema


class Expand(LogicalPlan):
    """Grouping-sets expansion: each projection list emits one copy of
    every input row (GpuExpandExec's role)."""

    def __init__(self, projections: List[List[Expression]],
                 names: List[str], child: LogicalPlan):
        self.projections = projections
        self.names = names
        self.children = (child,)

    @property
    def schema(self):
        return T.Schema([T.Field(n, e.dtype, True)
                         for n, e in zip(self.names, self.projections[0])])

    def describe(self):
        return f"Expand({len(self.projections)} projections)"


class Window(LogicalPlan):
    """The child's columns, then one column per window expression; every
    expression of one node shares its (partition, order) spec."""

    def __init__(self, window_exprs, output_names: List[str],
                 child: LogicalPlan):
        self.window_exprs = window_exprs
        self.output_names = output_names
        self.children = (child,)

    @property
    def schema(self):
        base = list(self.children[0].schema.fields)
        extra = [T.Field(n, w.dtype, True)
                 for n, w in zip(self.output_names, self.window_exprs)]
        return T.Schema(base + extra)

    def describe(self):
        return f"Window({', '.join(self.output_names)})"


class Generate(LogicalPlan):
    """explode / posexplode of an array column: the child's other columns
    repeated once per element, then ``pos`` (posexplode), then the
    element column ``alias``.  With ``outer`` an empty or NULL array keeps
    its row, with a NULL element (GpuGenerateExec's role)."""

    def __init__(self, column: str, alias: str, pos: bool, outer: bool,
                 child: LogicalPlan):
        self.column = column
        self.alias = alias
        self.pos = pos
        self.outer = outer
        self.children = (child,)

    @property
    def schema(self):
        child = self.children[0].schema
        arr = child.field(self.column)
        if not arr.dtype.is_array:
            raise TypeError(f"explode needs an array, got {arr.dtype}")
        fields = [f for f in child.fields if f.name != self.column]
        if self.pos:
            fields.append(T.Field("pos", T.INT, False))
        fields.append(T.Field(self.alias, arr.dtype.element, self.outer))
        return T.Schema(fields)

    def describe(self):
        kind = "posexplode" if self.pos else "explode"
        return f"Generate({kind}({self.column}) as {self.alias})"


class BroadcastHint(LogicalPlan):
    """``functions.broadcast(df)``: the planner broadcasts this side of a
    join whatever its estimated size."""

    def __init__(self, child: LogicalPlan):
        self.children = (child,)

    @property
    def schema(self):
        return self.children[0].schema


class Limit(LogicalPlan):
    def __init__(self, n: int, child: LogicalPlan):
        self.n = n
        self.children = (child,)

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return f"Limit({self.n})"


class Repartition(LogicalPlan):
    """Explicit exchange: mode in {hash, roundrobin, range, single}."""

    def __init__(self, mode: str, num_partitions: int,
                 keys: List[Expression], child: LogicalPlan,
                 orders: Optional[List[SortOrder]] = None):
        self.mode = mode
        self.num_partitions = num_partitions
        self.keys = keys
        self.orders = orders
        self.children = (child,)

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return f"Repartition({self.mode}, {self.num_partitions})"


class Sample(LogicalPlan):
    def __init__(self, fraction: float, seed: int, child: LogicalPlan):
        self.fraction = fraction
        self.seed = seed
        self.children = (child,)

    @property
    def schema(self):
        return self.children[0].schema


class WriteFile(LogicalPlan):
    """Data-writing command (GpuDataWritingCommandExec analogue)."""

    def __init__(self, fmt: str, path: str, mode: str,
                 options: Dict[str, Any], child: LogicalPlan):
        self.fmt = fmt
        self.path = path
        self.mode = mode
        self.options = options
        self.children = (child,)

    @property
    def schema(self):
        return T.Schema([])


class CacheHolder:
    """Materialized cache state shared by every DataFrame over a cached
    plan: the device batches, one list per partition, once filled.  Plain
    device memory for now; the spill catalog is not ported yet."""

    def __init__(self):
        self.partitions = None  # List[List[ColumnBatch]] once filled

    @property
    def is_materialized(self) -> bool:
        return self.partitions is not None

    def unpersist(self) -> None:
        """Drop the device batches; the next query fills them again."""
        self.partitions = None


class CachedRelation(LogicalPlan):
    def __init__(self, child: LogicalPlan, holder: CacheHolder):
        self.children = (child,)
        self.holder = holder

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        state = "materialized" if self.holder.is_materialized else "lazy"
        return f"CachedRelation({state})"
