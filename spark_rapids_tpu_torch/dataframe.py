"""Lazy DataFrame frontend over the logical plan (port of the part of
``spark_rapids_tpu/dataframe.py`` the port runs): filter, with_column,
join, group_by().agg(), order_by, limit, cache, collect, and the string
predicates contains, like, startswith and endswith."""

from __future__ import annotations

from typing import List, Optional

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.aggregates import (
    AggregateExpression, AggregateFunction,
)
from spark_rapids_tpu_torch.exprs.base import (
    Alias, ColumnRef, Expression, Literal, SortOrder, output_name, resolve,
)
from spark_rapids_tpu_torch.plan import logical as L


class Column:
    """Expression wrapper with operator sugar (pyspark Column analogue)."""

    def __init__(self, expr: Expression):
        self.expr = expr

    def _bin(self, other, cls):
        return Column(cls(self.expr, _to_expr(other)))

    def __mul__(self, other):
        from spark_rapids_tpu_torch.exprs.arithmetic import Multiply
        return self._bin(other, Multiply)

    def __eq__(self, other):  # type: ignore[override]
        from spark_rapids_tpu_torch.exprs.predicates import Equals
        return self._bin(other, Equals)

    def __lt__(self, other):
        from spark_rapids_tpu_torch.exprs.predicates import LessThan
        return self._bin(other, LessThan)

    def __le__(self, other):
        from spark_rapids_tpu_torch.exprs.predicates import LessThanOrEqual
        return self._bin(other, LessThanOrEqual)

    def __gt__(self, other):
        from spark_rapids_tpu_torch.exprs.predicates import GreaterThan
        return self._bin(other, GreaterThan)

    def __and__(self, other):
        from spark_rapids_tpu_torch.exprs.predicates import And
        return self._bin(other, And)

    def alias(self, name: str) -> "Column":
        return Column(Alias(self.expr, name))

    def asc(self, nulls_first: Optional[bool] = None) -> SortOrder:
        return SortOrder(self.expr, True, nulls_first)

    def desc(self, nulls_first: Optional[bool] = None) -> SortOrder:
        return SortOrder(self.expr, False, nulls_first)

    def startswith(self, prefix: str) -> "Column":
        from spark_rapids_tpu_torch.exprs.strings import StringStartsWith
        return Column(StringStartsWith(self.expr, Literal(prefix)))

    def endswith(self, suffix: str) -> "Column":
        from spark_rapids_tpu_torch.exprs.strings import StringEndsWith
        return Column(StringEndsWith(self.expr, Literal(suffix)))

    def contains(self, needle: str) -> "Column":
        from spark_rapids_tpu_torch.exprs.strings import StringContains
        return Column(StringContains(self.expr, Literal(needle)))

    def like(self, pattern: str) -> "Column":
        from spark_rapids_tpu_torch.exprs.strings import Like
        return Column(Like(self.expr, pattern))

    def __repr__(self):
        return f"Column({self.expr!r})"

    def __hash__(self):
        return id(self)


def _to_expr(v) -> Expression:
    if isinstance(v, Column):
        return v.expr
    if isinstance(v, Expression):
        return v
    return Literal(v)


def _to_order(v) -> SortOrder:
    if isinstance(v, SortOrder):
        return v
    if isinstance(v, str):
        return SortOrder(ColumnRef(v), True)
    if isinstance(v, Column):
        return SortOrder(v.expr, True)
    raise TypeError(f"cannot order by {v!r}")


class DataFrame:
    def __init__(self, plan: L.LogicalPlan, session):
        self.plan = plan
        self.session = session

    @property
    def schema(self) -> T.Schema:
        return self.plan.schema

    @property
    def columns(self) -> List[str]:
        return self.plan.schema.names

    def __getitem__(self, name: str) -> Column:
        f = self.schema.field(name)
        return Column(ColumnRef(name, f.dtype, f.nullable))

    def _resolve(self, e: Expression) -> Expression:
        return resolve(e, self.schema)

    def with_column(self, name: str, col) -> "DataFrame":
        exprs, names = [], []
        replaced = False
        for f in self.schema.fields:
            if f.name == name:
                exprs.append(self._resolve(_to_expr(col)))
                replaced = True
            else:
                exprs.append(ColumnRef(f.name, f.dtype, f.nullable))
            names.append(f.name)
        if not replaced:
            exprs.append(self._resolve(_to_expr(col)))
            names.append(name)
        return DataFrame(L.Project(exprs, names, self.plan), self.session)

    def filter(self, condition) -> "DataFrame":
        e = self._resolve(_to_expr(condition))
        return DataFrame(L.Filter(e, self.plan), self.session)

    def group_by(self, *cols) -> "GroupedData":
        keys, names = [], []
        for i, c in enumerate(cols):
            e = self._resolve(_to_expr(self[c] if isinstance(c, str) else c))
            keys.append(e)
            names.append(output_name(e, i))
        return GroupedData(self, keys, names)

    def join(self, other: "DataFrame", on=None, how: str = "inner"
             ) -> "DataFrame":
        """Join with ``other``: ``on`` a column name or list of names (a
        USING join), or a boolean Column whose ``==`` conjuncts between the
        two sides become the equi-join keys (anything else is the residual
        condition).  Right-side names that collide with left ones get an
        ``_r`` suffix."""
        how = {"leftouter": "left", "left_outer": "left",
               "rightouter": "right", "right_outer": "right",
               "outer": "full", "fullouter": "full", "full_outer": "full",
               "leftsemi": "left_semi", "semi": "left_semi",
               "leftanti": "left_anti", "anti": "left_anti"}.get(how, how)
        lkeys: List[Expression] = []
        rkeys: List[Expression] = []
        condition = None
        if on is None:
            how = "cross" if how == "inner" else how
        elif isinstance(on, str):
            on = [on]
        if isinstance(on, (list, tuple)):
            return self._join_using(other, list(on), how)
        if isinstance(on, Column):
            lkeys, rkeys, condition = _extract_join_keys(
                on.expr, self.schema, other.schema)
        right, mapping = _dedupe_right(
            self, other, how in ("left_semi", "left_anti"))
        if mapping:
            def remap(e: Expression) -> Expression:
                if isinstance(e, ColumnRef) and e.column in mapping:
                    return ColumnRef(mapping[e.column], e.dtype, e.nullable)
                return e
            rkeys = [k.transform_up(remap) for k in rkeys]
            if condition is not None:
                # the condition may reference either side; remap only the
                # names that exist solely on the right
                lnames = set(self.schema.names)

                def remap_cond(e: Expression) -> Expression:
                    if isinstance(e, ColumnRef) and e.column in mapping \
                            and e.column not in lnames:
                        return ColumnRef(mapping[e.column], e.dtype,
                                         e.nullable)
                    return e
                condition = condition.transform_up(remap_cond)
        node = L.Join(self.plan, right.plan, lkeys, rkeys, how, condition)
        return DataFrame(node, self.session)

    def _join_using(self, other: "DataFrame", names: List[str], how: str
                    ) -> "DataFrame":
        """USING-join semantics: one output column per key name (the left
        value; the right one for a right join; their coalesce for a full
        join), then the other left columns, then the other right ones."""
        lkeys = [self._resolve(ColumnRef(n)) for n in names]
        # rename the right key columns so the raw join output has no dups
        ren = {n: f"__rkey_{i}" for i, n in enumerate(names)}
        rexprs, rnames = [], []
        for f in other.schema.fields:
            rexprs.append(ColumnRef(f.name, f.dtype, f.nullable))
            rnames.append(ren.get(f.name, f.name))
        right = DataFrame(L.Project(rexprs, rnames, other.plan),
                          other.session)
        right, _mapping = _dedupe_right(
            self, right, how in ("left_semi", "left_anti"))
        rkeys = [right._resolve(ColumnRef(ren[n])) for n in names]
        joined = DataFrame(L.Join(self.plan, right.plan, lkeys, rkeys, how),
                           self.session)
        if how in ("left_semi", "left_anti"):
            return joined
        sch = joined.schema
        exprs, out_names = [], []
        for n in names:
            lref, rref = ColumnRef(n), ColumnRef(ren[n])
            if how == "right":
                e = resolve(rref, sch)
            elif how == "full":
                from spark_rapids_tpu_torch.exprs.nullexprs import Coalesce
                e = Coalesce(resolve(lref, sch), resolve(rref, sch))
            else:
                e = resolve(lref, sch)
            exprs.append(e)
            out_names.append(n)
        for f in sch.fields:
            if f.name in names or f.name in ren.values():
                continue
            exprs.append(ColumnRef(f.name, f.dtype, f.nullable))
            out_names.append(f.name)
        return DataFrame(L.Project(exprs, out_names, joined.plan),
                         self.session)

    def order_by(self, *cols) -> "DataFrame":
        orders = []
        for c in cols:
            o = _to_order(c)
            orders.append(SortOrder(self._resolve(o.child), o.ascending,
                                    o.nulls_first))
        return DataFrame(L.Sort(orders, True, self.plan), self.session)

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(L.Limit(n, self.plan), self.session)

    def collect(self) -> List[tuple]:
        hb = self.session.execute(self.plan)
        cols = [c.to_list() for c in hb.columns]
        return [tuple(c[i] for c in cols) for i in range(hb.num_rows)]

    def cache(self) -> "DataFrame":
        """Mark for caching: the first execution keeps the device batches
        for every later query over this DataFrame."""
        if isinstance(self.plan, L.CachedRelation):
            return self
        return DataFrame(L.CachedRelation(self.plan, L.CacheHolder()),
                         self.session)


def _dedupe_right(left: DataFrame, right: DataFrame, is_semi: bool):
    """Rename right-side columns whose names the left side has (suffix
    ``_r``) so the joined schema is unambiguous; semi and anti joins keep
    only the left side and rename nothing.  Returns (right_df,
    {old_name: new_name})."""
    if is_semi:
        return right, {}
    lnames = set(left.schema.names)
    if not (lnames & set(right.schema.names)):
        return right, {}
    exprs, names, mapping = [], [], {}
    for f in right.schema.fields:
        exprs.append(ColumnRef(f.name, f.dtype, f.nullable))
        nm = f.name
        while nm in lnames:
            nm = nm + "_r"
        if nm != f.name:
            mapping[f.name] = nm
        names.append(nm)
    return DataFrame(L.Project(exprs, names, right.plan),
                     right.session), mapping


def _extract_join_keys(expr: Expression, lschema: T.Schema,
                       rschema: T.Schema):
    """Split a join condition into equi-key pairs and the residual
    condition (None when every conjunct is a key pair)."""
    from spark_rapids_tpu_torch.exprs.predicates import And, Equals
    lkeys, rkeys, residual = [], [], []

    def visit(e: Expression):
        if isinstance(e, And):
            visit(e.children[0])
            visit(e.children[1])
            return
        if isinstance(e, Equals):
            a, b = e.children
            if isinstance(a, ColumnRef) and isinstance(b, ColumnRef):
                if a.column in lschema and b.column in rschema:
                    lkeys.append(resolve(a, lschema))
                    rkeys.append(resolve(b, rschema))
                    return
                if b.column in lschema and a.column in rschema:
                    lkeys.append(resolve(b, lschema))
                    rkeys.append(resolve(a, rschema))
                    return
        residual.append(e)

    visit(expr)
    cond = None
    for r in residual:
        cond = r if cond is None else And(cond, r)
    return lkeys, rkeys, cond


class GroupedData:
    def __init__(self, df: DataFrame, keys: List[Expression],
                 names: List[str]):
        self.df = df
        self.keys = keys
        self.names = names

    def agg(self, *aggs) -> DataFrame:
        out: List[AggregateExpression] = []
        for i, a in enumerate(aggs):
            if isinstance(a, AggregateExpression):
                out.append(a)
                continue
            e, name = a.expr if isinstance(a, Column) else a, None
            if isinstance(e, Alias):
                name, e = e.alias_name, e.children[0]
            if not isinstance(e, AggregateFunction):
                raise TypeError(f"not an aggregate: {a!r}")
            e = e.with_children([resolve(e.child, self.df.schema)])
            out.append(AggregateExpression(
                e, name or f"{e.name.lower()}_{i}"))
        return DataFrame(L.Aggregate(self.keys, self.names, out,
                                     self.df.plan), self.df.session)
