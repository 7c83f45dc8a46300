"""Lazy DataFrame frontend over the logical plan (port of the part of
``spark_rapids_tpu/dataframe.py`` the port runs): select, filter,
with_column, join and cross_join, union, group_by().agg() and agg() without
keys (count(DISTINCT) through the two-level rewrite), distinct, order_by,
limit, cache, collect, explain, temp views for the SQL front end, and the
Column operators of the ported expressions."""

from __future__ import annotations

from typing import List, Optional

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs import aggregates as A
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

    def __add__(self, other):
        from spark_rapids_tpu_torch.exprs.arithmetic import Add
        return self._bin(other, Add)

    def __radd__(self, other):
        return Column(_to_expr(other)) + self

    def __sub__(self, other):
        from spark_rapids_tpu_torch.exprs.arithmetic import Subtract
        return self._bin(other, Subtract)

    def __rsub__(self, other):
        return Column(_to_expr(other)) - self

    def __mul__(self, other):
        from spark_rapids_tpu_torch.exprs.arithmetic import Multiply
        return self._bin(other, Multiply)

    def __rmul__(self, other):
        return Column(_to_expr(other)) * self

    def __truediv__(self, other):
        from spark_rapids_tpu_torch.exprs.arithmetic import Divide
        return self._bin(other, Divide)

    def __mod__(self, other):
        from spark_rapids_tpu_torch.exprs.arithmetic import Remainder
        return self._bin(other, Remainder)

    def __neg__(self):
        from spark_rapids_tpu_torch.exprs.arithmetic import UnaryMinus
        return Column(UnaryMinus(self.expr))

    def __eq__(self, other):  # type: ignore[override]
        from spark_rapids_tpu_torch.exprs.predicates import Equals
        return self._bin(other, Equals)

    def __ne__(self, other):  # type: ignore[override]
        from spark_rapids_tpu_torch.exprs.predicates import NotEquals
        return self._bin(other, NotEquals)

    def __lt__(self, other):
        from spark_rapids_tpu_torch.exprs.predicates import LessThan
        return self._bin(other, LessThan)

    def __le__(self, other):
        from spark_rapids_tpu_torch.exprs.predicates import LessThanOrEqual
        return self._bin(other, LessThanOrEqual)

    def __gt__(self, other):
        from spark_rapids_tpu_torch.exprs.predicates import GreaterThan
        return self._bin(other, GreaterThan)

    def __ge__(self, other):
        from spark_rapids_tpu_torch.exprs.predicates import GreaterThanOrEqual
        return self._bin(other, GreaterThanOrEqual)

    def __and__(self, other):
        from spark_rapids_tpu_torch.exprs.predicates import And
        return self._bin(other, And)

    def __or__(self, other):
        from spark_rapids_tpu_torch.exprs.predicates import Or
        return self._bin(other, Or)

    def __invert__(self):
        from spark_rapids_tpu_torch.exprs.predicates import Not
        return Column(Not(self.expr))

    def is_null(self) -> "Column":
        from spark_rapids_tpu_torch.exprs.nullexprs import IsNull
        return Column(IsNull(self.expr))

    def is_not_null(self) -> "Column":
        from spark_rapids_tpu_torch.exprs.nullexprs import IsNotNull
        return Column(IsNotNull(self.expr))

    isNull = is_null
    isNotNull = is_not_null

    def isin(self, *values) -> "Column":
        from spark_rapids_tpu_torch.exprs.predicates import In
        vals = values[0] if len(values) == 1 and \
            isinstance(values[0], (list, tuple, set)) else values
        return Column(In(self.expr, list(vals)))

    def between(self, low, high) -> "Column":
        return (self >= low) & (self <= high)

    def cast(self, dtype) -> "Column":
        from spark_rapids_tpu_torch.exprs.cast import Cast
        dt = T.type_from_name(dtype) if isinstance(dtype, str) else dtype
        return Column(Cast(self.expr, dt))

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

    def select(self, *cols) -> "DataFrame":
        """Project ``cols``: names (``"*"`` for every column), Columns or
        expressions; an aliased one takes its alias's name."""
        exprs, names = [], []
        for i, c in enumerate(cols):
            if isinstance(c, str):
                if c == "*":
                    for f in self.schema.fields:
                        exprs.append(ColumnRef(f.name, f.dtype, f.nullable))
                        names.append(f.name)
                    continue
                c = self[c]
            e = self._resolve(_to_expr(c))
            exprs.append(e)
            names.append(output_name(e, i))
        return DataFrame(L.Project(exprs, names, self.plan), self.session)

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

    def agg(self, *aggs) -> "DataFrame":
        """Aggregation without grouping keys: one row."""
        return GroupedData(self, [], []).agg(*aggs)

    def distinct(self) -> "DataFrame":
        """Distinct rows: an aggregate keyed by every column, with no
        aggregate function, as the JAX package plans its Distinct node."""
        keys = [ColumnRef(f.name, f.dtype, f.nullable)
                for f in self.schema.fields]
        return DataFrame(L.Aggregate(keys, list(self.schema.names), [],
                                     self.plan), self.session)

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

    def cross_join(self, other: "DataFrame") -> "DataFrame":
        """Every pair of rows (a nested-loop join without condition)."""
        node = L.Join(self.plan, other.plan, [], [], "cross", None)
        return DataFrame(node, self.session)

    crossJoin = cross_join

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL by position; names from this side, numeric columns
        widened to their common type first (Spark's
        WidenSetOperationTypes)."""
        left, right = self._union_coerce(other)
        return DataFrame(L.Union([left, right]), self.session)

    unionAll = union

    def _union_coerce(self, other: "DataFrame"):
        lf = list(self.plan.schema.fields)
        rf = list(other.plan.schema.fields)
        if len(lf) != len(rf) or \
                all(a.dtype == b.dtype for a, b in zip(lf, rf)):
            return self.plan, other.plan
        try:
            common = [T.promote(a.dtype, b.dtype) for a, b in zip(lf, rf)]
        except TypeError:
            return self.plan, other.plan  # L.Union raises its check

        def recast(plan, fields):
            from spark_rapids_tpu_torch.exprs.cast import Cast
            exprs = []
            for f, dt in zip(fields, common):
                ref = ColumnRef(f.name, f.dtype, f.nullable)
                exprs.append(ref if f.dtype == dt else Cast(ref, dt))
            return L.Project(exprs, [f.name for f in lf], plan)

        return recast(self.plan, lf), recast(other.plan, rf)

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
        orders = [self._resolve_order(_to_order(c)) for c in cols]
        return DataFrame(L.Sort(orders, True, self.plan), self.session)

    def _resolve_order(self, o: SortOrder) -> SortOrder:
        """Resolve a sort expression against this DataFrame's schema.  A
        bare column name the select list renamed away falls back to its
        alias's output column (SQL's ORDER BY on the pre-alias name)."""
        try:
            return SortOrder(self._resolve(o.child), o.ascending,
                             o.nulls_first)
        except KeyError:
            alias = self._order_alias_for(o.child)
            if alias is None:
                raise
            return SortOrder(self._resolve(ColumnRef(alias)), o.ascending,
                             o.nulls_first)

    def _order_alias_for(self, e: Expression) -> Optional[str]:
        """Output name of a select-list entry that is a pure rename of the
        input column ``e`` references, when this plan is a projection
        (possibly under a limit); None otherwise."""
        if not isinstance(e, ColumnRef):
            return None
        node = self.plan
        while isinstance(node, L.Limit):
            node = node.children[0]
        if not isinstance(node, L.Project):
            return None
        for name, pe in zip(node.names, node.exprs):
            inner = pe
            while isinstance(inner, Alias):
                inner = inner.children[0]
            if isinstance(inner, ColumnRef) and inner.column == e.column:
                return name
        return None

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(L.Limit(n, self.plan), self.session)

    def collect(self) -> List[tuple]:
        hb = self.session.execute(self.plan)
        cols = [c.to_list() for c in hb.columns]
        return [tuple(c[i] for c in cols) for i in range(hb.num_rows)]

    def explain(self) -> str:
        """Print and return the placement of every operator (``*`` on the
        GPU, ``!`` on the host and why) and the physical plan."""
        text = self.session.explain_plan(self.plan)
        print(text)
        return text

    def create_or_replace_temp_view(self, name: str) -> None:
        self.session.register_view(name, self)

    createOrReplaceTempView = create_or_replace_temp_view

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
        if any(isinstance(a.fn, A.CountDistinct) for a in out):
            return self._agg_with_distinct(out)
        return DataFrame(L.Aggregate(self.keys, self.names, out,
                                     self.df.plan), self.df.session)

    def _agg_with_distinct(self, out: List[AggregateExpression]
                           ) -> DataFrame:
        """The distinct-aggregate rewrite (Spark's
        RewriteDistinctAggregates)::

            Agg(k, [count(DISTINCT v), regular...])
              -> Agg(k, [count(v'), re-agg(regular)],
                     Agg(k + [v], [regular per (k, v)]))

        The inner aggregation dedups the (k, v) pairs and computes the
        regular aggregates once per pair; the outer one counts the now
        unique non-NULL values and re-aggregates the regulars (sum of
        sums, sum of counts, min of mins, avg as sum over count).
        Without keys the outer aggregation is keyless."""
        from spark_rapids_tpu_torch.exprs.arithmetic import Divide
        from spark_rapids_tpu_torch.exprs.cast import Cast

        dvals = [a.fn.child for a in out if isinstance(a.fn, A.CountDistinct)]
        if any(repr(e) != repr(dvals[0]) for e in dvals[1:]):
            raise NotImplementedError(
                "count_distinct over different expressions in one "
                "aggregation needs the Expand-based rewrite (not yet "
                "implemented); split into separate aggregations")
        dname = "__cd_val"
        inner_aggs: List[AggregateExpression] = []
        plans = []  # per output: how the outer level produces it
        for i, a in enumerate(out):
            fn = a.fn
            if isinstance(fn, A.CountDistinct):
                plans.append(("count_distinct",))
            elif isinstance(fn, A.Average):
                ns, nc = f"__cd_s{i}", f"__cd_c{i}"
                inner_aggs.append(AggregateExpression(A.Sum(fn.child), ns))
                inner_aggs.append(AggregateExpression(A.Count(fn.child), nc))
                plans.append(("avg", ns, nc))
            elif isinstance(fn, (A.Sum, A.Count, A.Min, A.Max)):
                nm = f"__cd_a{i}"
                inner_aggs.append(AggregateExpression(fn, nm))
                plans.append(("reagg", nm, fn))
            else:
                raise NotImplementedError(
                    f"{type(fn).__name__} cannot be combined with "
                    "count_distinct (no re-aggregation rule)")

        inner = GroupedData(self.df, self.keys + [dvals[0]],
                            self.names + [dname]).agg(*inner_aggs)
        o_aggs: List[AggregateExpression] = []
        avg_slots = {}  # output index -> (sum name, count name)
        for i, (a, plan) in enumerate(zip(out, plans)):
            if plan[0] == "count_distinct":
                o_aggs.append(AggregateExpression(
                    A.Count(inner._resolve(ColumnRef(dname))),
                    a.output_name))
            elif plan[0] == "avg":
                _, ns, nc = plan
                os_, oc = f"__cd_os{i}", f"__cd_oc{i}"
                o_aggs.append(AggregateExpression(
                    A.Sum(inner._resolve(ColumnRef(ns))), os_))
                o_aggs.append(AggregateExpression(
                    A.Sum(inner._resolve(ColumnRef(nc))), oc))
                avg_slots[i] = (os_, oc)
            else:
                _, nm, fn = plan
                ref = inner._resolve(ColumnRef(nm))
                # a count re-aggregates as the sum of the per-(k, v) counts
                o_fn = A.Sum(ref) if isinstance(fn, A.Count) else \
                    type(fn)(ref)
                o_aggs.append(AggregateExpression(o_fn, a.output_name))
        outer = inner.group_by(*self.names).agg(*o_aggs)
        if not avg_slots:
            return outer
        # avg outputs as sum / count, in the requested order and names
        sel: List[Column] = [Column(ColumnRef(n)) for n in self.names]
        for i, a in enumerate(out):
            if i in avg_slots:
                os_, oc = avg_slots[i]
                e = Divide(Cast(ColumnRef(os_), T.DOUBLE),
                           Cast(ColumnRef(oc), T.DOUBLE))
                sel.append(Column(Alias(e, a.output_name)))
            else:
                sel.append(Column(ColumnRef(a.output_name)))
        return outer.select(*sel)
