"""Lazy DataFrame frontend over the logical plan (port of the part of
``spark_rapids_tpu/dataframe.py`` the port runs): select, with_column
(window expressions hoisted into Window nodes) and drop, filter, join and
cross_join, union, intersect and subtract, explode, group_by().agg() and
agg() without keys (count(DISTINCT) through the two-level rewrite,
percentile through row_number and count windows, corr and covar through
mean windows and sums of centered products), rollup, cube and
grouping_sets (an Expand under one aggregate), distinct, order_by, limit,
cache, collect, explain, temp views for the SQL front end, and the Column
operators of the ported expressions."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

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

    def getItem(self, ordinal: int) -> "Column":
        """The array element at a literal 0-based ordinal (NULL out of
        range)."""
        from spark_rapids_tpu_torch.exprs.misc import GetArrayItem
        return Column(GetArrayItem(self.expr, ordinal))

    def __getitem__(self, ordinal: int) -> "Column":
        if isinstance(ordinal, bool) or not isinstance(ordinal, int):
            raise TypeError(f"an array ordinal must be an int: {ordinal!r}")
        return self.getItem(ordinal)

    def substr(self, start: int, length: int) -> "Column":
        from spark_rapids_tpu_torch.exprs.strings import Substring
        return Column(Substring(self.expr, start, length))

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
        return DataFrame(self._project_node(exprs, names), self.session)

    def _project_node(self, exprs: List[Expression], names: List[str]
                      ) -> L.LogicalPlan:
        """A Project, with every window expression anywhere in its trees
        hoisted into Window nodes below it (Spark's
        ExtractWindowExpressions): each distinct window (by
        ``fingerprint()``, which sees frames and offsets) becomes a hidden
        ``__w<i>`` column, one Window node per (partition, order) spec."""
        from spark_rapids_tpu_torch.exprs.windows import WindowExpression

        found: Dict[str, Tuple[str, Expression]] = {}

        def hoist(e: Expression) -> Expression:
            if isinstance(e, WindowExpression):
                key = e.fingerprint()
                if key not in found:
                    found[key] = (f"__w{len(found)}", e)
                return ColumnRef(found[key][0], e.dtype, True)
            kids = e.children
            if not kids:
                return e
            new_kids = [hoist(c) for c in kids]
            if all(a is b for a, b in zip(new_kids, kids)):
                return e
            return e.with_children(new_kids)

        new_exprs = [hoist(e) for e in exprs]
        if not found:
            return L.Project(exprs, names, self.plan)
        groups: Dict[str, List[Tuple[str, Expression]]] = {}
        for hn, w in found.values():
            orders = [(repr(o.child), o.ascending, o.nulls_first)
                      for o in w.order_by]
            key = f"{[repr(p) for p in w.partition_by]}|{orders}"
            groups.setdefault(key, []).append((hn, w))
        child = self.plan
        for items in groups.values():
            child = L.Window([w for _, w in items], [hn for hn, _ in items],
                             child)
        return L.Project([resolve(e, child.schema) for e in new_exprs],
                         names, child)

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
        return DataFrame(self._project_node(exprs, names), self.session)

    def drop(self, *names: str) -> "DataFrame":
        """Every column but ``names`` (a name the frame lacks is
        ignored)."""
        keep = [f for f in self.schema.fields if f.name not in names]
        exprs = [ColumnRef(f.name, f.dtype, f.nullable) for f in keep]
        return DataFrame(L.Project(exprs, [f.name for f in keep],
                                   self.plan), self.session)

    def explode(self, column: str, alias: Optional[str] = None,
                pos: bool = False, outer: bool = False) -> "DataFrame":
        """One row per element of the array column ``column``, the other
        columns repeated, the element as ``alias`` (default ``col``);
        ``pos`` adds the element's position, ``outer`` keeps an empty or
        NULL array's row with a NULL element (on the host)."""
        return DataFrame(L.Generate(column, alias or "col", pos, outer,
                                    self.plan), self.session)

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

    def _grouping_sets(self, cols, sets) -> "GroupingSetsData":
        gd = self.group_by(*cols)
        n = len(gd.keys)
        for s in sets:
            bad = [i for i in s if not (0 <= i < n)]
            if bad:
                raise ValueError(
                    f"grouping set {s} references key positions {bad}; "
                    f"only {n} grouping keys exist")
        return GroupingSetsData(self, gd.keys, gd.names,
                                [tuple(s) for s in sets])

    def rollup(self, *cols) -> "GroupingSetsData":
        """GROUP BY ROLLUP: the subtotal ladder ((k1..kn), (k1..kn-1),
        ..., ()) through an Expand."""
        return self._grouping_sets(cols, rollup_sets(len(cols)))

    def cube(self, *cols) -> "GroupingSetsData":
        """GROUP BY CUBE: every subset of the grouping keys."""
        return self._grouping_sets(cols, cube_sets(len(cols)))

    def grouping_sets(self, cols, sets) -> "GroupingSetsData":
        """GROUPING SETS: ``sets`` is a list of tuples of key positions
        (indices into ``cols``)."""
        return self._grouping_sets(cols, [tuple(s) for s in sets])

    def _set_op(self, other: "DataFrame", keep: str) -> "DataFrame":
        """INTERSECT and EXCEPT (distinct): both sides unioned under a side
        marker, grouped by every column, kept by the marker's min and max.
        Group keys already take NULL (and NaN) as equal, SQL's set
        equality; Spark plans these as semi and anti joins, the JAX package
        (and so the port) as this aggregate."""
        from spark_rapids_tpu_torch import functions as F
        if len(self.columns) != len(other.columns):
            raise ValueError(
                f"set operation needs equal column counts: "
                f"{len(self.columns)} vs {len(other.columns)}")
        side = "__setop_side"
        right = other.select(*[other[c2].alias(c1) for c1, c2 in
                               zip(self.columns, other.columns)])
        # the min/max group-by ignores how often a row occurs: no
        # per-side distinct
        u = (self.with_column(side, F.lit(0))
             .union(right.with_column(side, F.lit(1))))
        g = (u.group_by(*self.columns)
             .agg(F.min(side).alias("__mn"), F.max(side).alias("__mx")))
        mn, mx = g["__mn"], g["__mx"]
        cond = (mn == 0) & (mx == 1) if keep == "both" else \
            (mn == 0) & (mx == 0)
        return g.filter(cond).select(*self.columns)

    def intersect(self, other: "DataFrame") -> "DataFrame":
        """Distinct rows present in both frames (SQL INTERSECT)."""
        return self._set_op(other, "both")

    def subtract(self, other: "DataFrame") -> "DataFrame":
        """Distinct rows of this frame absent from ``other`` (SQL
        EXCEPT)."""
        return self._set_op(other, "left")

    exceptDistinct = subtract

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
            e = e.with_children([resolve(c, self.df.schema)
                                 for c in e.children])
            out.append(AggregateExpression(
                e, name or f"{e.name.lower()}_{i}"))
        if any(isinstance(a.fn, A._BinaryStatMarker) for a in out):
            return self._agg_with_binary_stats(out)
        if any(isinstance(a.fn, A.Percentile) for a in out):
            return self._agg_with_percentile(out)
        if any(isinstance(a.fn, A.CountDistinct) for a in out):
            return self._agg_with_distinct(out)
        return DataFrame(L.Aggregate(self.keys, self.names, out,
                                     self.df.plan), self.df.session)

    def _agg_with_binary_stats(self, out: List[AggregateExpression]
                               ) -> DataFrame:
        """The corr / covar_pop / covar_samp rewrite: no aggregation path
        takes two inputs, so each becomes window means over the rows where
        both inputs are non-NULL, SUMs of centered products and their
        ratio in a projection after the aggregation (centered on the
        group's means, so a large mean does not cancel)::

            gx = x where both x and y are non-NULL; gy likewise
            mx = avg(gx) OVER (keys); my = avg(gy) OVER (keys)
            sp = SUM((gx - mx) * (gy - my)); n = COUNT(gx)
            covar_pop = sp / n; covar_samp = sp / (n - 1), NaN at n = 1
            corr = sp / sqrt(SUM((gx - mx)^2) * SUM((gy - my)^2)), NaN
                   where a variance is 0
            every one NULL at n = 0

        Without keys the windows are one partition.  The other aggregates
        ride the aggregation unchanged."""
        from spark_rapids_tpu_torch import functions as F

        df = self.df
        wp = F.Window.partition_by(*[Column(k) for k in self.keys])
        final: List[AggregateExpression] = []
        post = {}  # output name -> its column over the aggregation
        for i, a in enumerate(out):
            fn = a.fn
            if not isinstance(fn, A._BinaryStatMarker):
                final.append(a)
                continue
            x, y = Column(fn.left), Column(fn.right)
            both = x.is_not_null() & y.is_not_null()
            gxn, gyn = f"__bs_x{i}", f"__bs_y{i}"
            mxn, myn = f"__bs_mx{i}", f"__bs_my{i}"
            df = (df.with_column(gxn, F.when(both, x.cast(T.DOUBLE))
                                 .otherwise(None))
                  .with_column(gyn, F.when(both, y.cast(T.DOUBLE))
                               .otherwise(None)))
            df = (df.with_column(mxn, F.avg(df[gxn]).over(wp))
                  .with_column(myn, F.avg(df[gyn]).over(wp)))
            dx, dy = df[gxn] - df[mxn], df[gyn] - df[myn]
            spn, nn = f"__bs_sp{i}", f"__bs_n{i}"

            def total(c: Column, name: str, frame=df):
                return AggregateExpression(
                    A.Sum(resolve(c.expr, frame.schema)), name)

            final.append(total(dx * dy, spn))
            final.append(AggregateExpression(
                A.Count(resolve(ColumnRef(gxn), df.schema)), nn))
            nan = F.lit(float("nan"))
            if isinstance(fn, A.Corr):
                sxn, syn = f"__bs_sx{i}", f"__bs_sy{i}"
                final.append(total(dx * dx, sxn))
                final.append(total(dy * dy, syn))

                def result(g, spn=spn, nn=nn, sxn=sxn, syn=syn):
                    denom = g[sxn] * g[syn]
                    return (F.when((g[nn] >= 1) & (denom > 0),
                                   g[spn] / F.sqrt(denom))
                            .when(g[nn] >= 1, nan).otherwise(None))
            elif isinstance(fn, A.CovarSamp):
                def result(g, spn=spn, nn=nn):
                    samp = g[spn] / (g[nn] - 1).cast(T.DOUBLE)
                    return (F.when(g[nn] > 1, samp)
                            .when(g[nn] == 1, nan).otherwise(None))
            else:
                def result(g, spn=spn, nn=nn):
                    return (F.when(g[nn] >= 1,
                                   g[spn] / g[nn].cast(T.DOUBLE))
                            .otherwise(None))
            post[a.output_name] = result
        grouped = GroupedData(df, self.keys, self.names).agg(*final)
        sel = [grouped[n].alias(n) for n in self.names]
        for a in out:
            col = post[a.output_name](grouped) if a.output_name in post \
                else grouped[a.output_name]
            sel.append(col.alias(a.output_name))
        return grouped.select(*sel)

    def _agg_with_percentile(self, out: List[AggregateExpression]
                             ) -> DataFrame:
        """The exact-percentile rewrite: no fixed-size buffer holds a
        percentile's state, so each becomes ranks and an interpolation::

            rn  = row_number() OVER (keys ORDER BY x IS NULL, x)
            n   = count(x) OVER (keys)             -- the non-NULL count
            pos = p * (n - 1); lo = floor(pos); frac = pos - lo
            c   = x * (1 - frac) where rn - 1 == lo,
                  x * frac       where rn - 1 == lo + 1 and frac > 0,
                  NULL elsewhere
            percentile = SUM(c) GROUP BY keys

        NULL rows rank after every value and contribute NULL, so an
        all-NULL group sums to NULL, as Spark's.  The value is gated, not
        multiplied by a 0/1 weight, so an inf or NaN off the two ranks
        cannot poison the sum.  Percentiles of one input share one window
        pass; the other aggregates ride the final aggregation
        unchanged."""
        from spark_rapids_tpu_torch import functions as F
        from spark_rapids_tpu_torch.exprs.nullexprs import IsNull

        if any(isinstance(a.fn, A.CountDistinct) for a in out):
            raise NotImplementedError(
                "percentile and count_distinct in one aggregation; "
                "split into separate aggregations")
        df = self.df
        key_cols = [Column(k) for k in self.keys]
        contrib: Dict[int, str] = {}
        ranks: Dict[str, Tuple[str, str]] = {}  # input -> (rn, n) columns
        for i, a in enumerate(out):
            if not isinstance(a.fn, A.Percentile):
                continue
            x = Column(a.fn.child)
            wp = F.Window.partition_by(*key_cols)
            key = repr(a.fn.child)
            if key not in ranks:
                nf, rn, n = f"__pct_nf{i}", f"__pct_rn{i}", f"__pct_n{i}"
                df = (df.with_column(nf, Column(IsNull(a.fn.child)))
                      .with_column(rn, F.row_number().over(
                          wp.order_by(F.col(nf), x)))
                      .with_column(n, F.count(x).over(wp)))
                ranks[key] = (rn, n)
            rn, n = ranks[key]
            pos = (df[n] - 1).cast(T.DOUBLE) * F.lit(a.fn.percentage)
            lo = F.floor(pos)
            frac = pos - lo
            rn0 = (df[rn] - 1).cast(T.DOUBLE)
            name = f"__pct_c{i}"
            df = df.with_column(
                name,
                F.when(rn0 == lo, x.cast(T.DOUBLE) * (F.lit(1.0) - frac))
                .when((rn0 == lo + F.lit(1.0)) & (frac > F.lit(0.0)),
                      x.cast(T.DOUBLE) * frac)
                .otherwise(None))
            contrib[i] = name
        final = [AggregateExpression(
            A.Sum(resolve(ColumnRef(contrib[i]), df.schema)), a.output_name)
            if i in contrib else a for i, a in enumerate(out)]
        return GroupedData(df, self.keys, self.names).agg(*final)

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


GROUPING_ID_COL = "__grouping_id"
GROUPING_SET_COL = "__gset_idx"


def rollup_sets(n: int):
    """((0..n-1), (0..n-2), ..., ()): the ROLLUP ladder.  The order sets
    the grouping id's bits: bit (n-1-i) marks key i masked."""
    return [tuple(range(k)) for k in range(n, -1, -1)]


def cube_sets(n: int):
    """Every subset of the n grouping keys (CUBE)."""
    import itertools
    return [s for k in range(n, -1, -1)
            for s in itertools.combinations(range(n), k)]


class GroupingSetsData(GroupedData):
    """GroupedData over ROLLUP, CUBE or GROUPING SETS: an Expand makes one
    copy of the input per grouping set (the input's columns passed on for
    the aggregates, the key columns masked to NULL where the set leaves
    them out, the set's index and its grouping id), then ONE aggregation
    groups by (masked keys, set index) (GpuExpandExec's role).  Only
    ``agg``: the pandas paths are not ported, and raise as the JAX
    package's do."""

    def __init__(self, df: DataFrame, keys: List[Expression],
                 names: List[str], sets: List[tuple]):
        super().__init__(df, keys, names)
        self.sets = sets

    def apply_in_pandas(self, fn, schema) -> DataFrame:
        raise NotImplementedError(
            "apply_in_pandas under rollup/cube/grouping sets is not "
            "supported (Spark has no pandas path for grouping sets "
            "either); aggregate with agg() instead")

    applyInPandas = apply_in_pandas

    def agg_in_pandas(self, specs) -> DataFrame:
        raise NotImplementedError(
            "agg_in_pandas under rollup/cube/grouping sets is not "
            "supported; aggregate with agg() instead")

    def cogroup(self, other):
        raise NotImplementedError(
            "cogroup under rollup/cube/grouping sets is not supported")

    def agg(self, *aggs) -> DataFrame:
        from spark_rapids_tpu_torch import functions as F
        n = len(self.keys)
        child_fields = self.df.schema.fields
        masked = [f"__gset_k{i}" for i in range(n)]
        projections = []
        # the set's index, not its grouping id, is the hidden group key:
        # a repeated grouping set must give its rows again (SPARK-33229)
        for si, s in enumerate(self.sets):
            gid = sum(1 << (n - 1 - i) for i in range(n) if i not in s)
            proj = [ColumnRef(f.name, f.dtype, f.nullable)
                    for f in child_fields]
            for i, k in enumerate(self.keys):
                proj.append(k if i in s else Literal(None, k.dtype))
            proj.append(Literal(si, T.INT))
            proj.append(Literal(gid, T.INT))
            projections.append(proj)
        names = [f.name for f in child_fields] + masked + \
            [GROUPING_SET_COL, GROUPING_ID_COL]
        expanded = DataFrame(L.Expand(projections, names, self.df.plan),
                             self.df.session)
        inner_keys = [ColumnRef(mn, k.dtype, True)
                      for mn, k in zip(masked, self.keys)]
        inner_keys.append(ColumnRef(GROUPING_SET_COL, T.INT, False))
        gd = GroupedData(expanded, inner_keys,
                         self.names + [GROUPING_SET_COL])
        fixed = []
        for a in aggs:
            e = a.expr if isinstance(a, Column) else None
            name = None
            if isinstance(e, Alias):
                name, e = e.alias_name, e.children[0]
            if isinstance(e, A.GroupingID):
                fixed.append(F.min(Column(
                    ColumnRef(GROUPING_ID_COL, T.INT, False)))
                    .alias(name or "grouping_id"))
            else:
                fixed.append(a)
        out = gd.agg(*fixed)
        return out.select(*[c for c in out.columns
                            if c not in (GROUPING_ID_COL,
                                         GROUPING_SET_COL)])
