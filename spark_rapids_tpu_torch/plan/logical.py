"""Logical plan nodes built by the DataFrame frontend (port of the part of
``spark_rapids_tpu/plan/logical.py`` the slice needs)."""

from __future__ import annotations

from typing import List, Optional, Tuple

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


class Limit(LogicalPlan):
    def __init__(self, n: int, child: LogicalPlan):
        self.n = n
        self.children = (child,)

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return f"Limit({self.n})"


class CacheHolder:
    """Materialized cache state shared by every DataFrame over a cached
    plan: the device batches, one list per partition, once filled.  Plain
    device memory for now; the spill catalog is not ported yet."""

    def __init__(self):
        self.partitions = None  # List[List[ColumnBatch]] once filled

    @property
    def is_materialized(self) -> bool:
        return self.partitions is not None


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
