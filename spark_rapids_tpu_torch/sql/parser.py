"""Recursive-descent SQL parser -> the port's DataFrames (port of
``spark_rapids_tpu/sql/parser.py``).

Grammar, as in the JAX package:

  statement := [WITH name AS (query) [, ...]] query
  query     := set_term ((UNION | EXCEPT) [ALL | DISTINCT] set_term)*
               [ORDER BY ...] [LIMIT n]
  set_term  := select (INTERSECT [DISTINCT] select)*
  select    := SELECT [DISTINCT] proj (, proj)* FROM source (join)*
               [WHERE expr] [GROUP BY group] [HAVING expr]
  group     := expr (, expr)* | ROLLUP (expr, ...) | CUBE (expr, ...)
             | GROUPING SETS ((expr, ...) | expr, ...)
  source    := ident [[AS] alias] | ( query ) [AS] alias
  join      := [INNER|LEFT [OUTER]|RIGHT [OUTER]|FULL [OUTER]|LEFT SEMI|
               LEFT ANTI] JOIN source (ON expr | USING (cols))
             | CROSS JOIN source
  expr      := standard precedence: OR > AND > NOT > cmp > add > mul > unary;
               fn(...) OVER ([PARTITION BY ...] [ORDER BY ...]
               [(ROWS | RANGE) BETWEEN bound AND bound])

The same text builds the same logical plan as the JAX package, with the
same output names (``_default_name``, the hidden ``__agg_i``,
``__having_i`` and ``__w<i>`` columns).  INTERSECT binds tighter than
UNION and EXCEPT; UNION without ALL is a distinct union; INTERSECT ALL and
EXCEPT ALL raise, as in the JAX package.  A window expression is opaque to
the aggregate test, so ``avg(x) OVER (...)`` over a subquery's aggregate
output plans a Window, not an aggregation.  A construct whose expression
or operator the port does not have yet raises
:class:`NotImplementedError` naming it and saying "not ported yet":
``explode``, ``||`` and every function whose expression is not ported.
``COUNT(DISTINCT x)`` is the one DISTINCT aggregate, over one column, as in
the JAX package.  Nothing is guessed at and nothing is handed to the JAX
package.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs import aggregates as A
from spark_rapids_tpu_torch.exprs.base import (
    Alias, ColumnRef, Expression, Literal, SortOrder,
)
from spark_rapids_tpu_torch.exprs.windows import WindowExpression
from spark_rapids_tpu_torch.sql.lexer import Token, tokenize


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet")


class Parser:
    def __init__(self, tokens: List[Token], session):
        self.toks = tokens
        self.i = 0
        self.session = session
        # WITH-clause bindings, name -> DataFrame; consulted before the
        # session catalog so a CTE shadows a view of the same name
        self.ctes = {}

    # -- token helpers ------------------------------------------------------

    def peek(self, offset=0) -> Token:
        return self.toks[min(self.i + offset, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, value: Optional[str] = None
               ) -> Optional[Token]:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind: str, value: Optional[str] = None) -> Token:
        t = self.accept(kind, value)
        if t is None:
            got = self.peek()
            raise SyntaxError(
                f"expected {value or kind}, got {got.value!r} at {got.pos}")
        return t

    def at_kw(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == "keyword" and t.value in words

    def _at_ident(self, *words: str) -> bool:
        """A soft keyword: an identifier matching one of ``words``
        (ROLLUP/CUBE/GROUPING SETS are not reserved)."""
        t = self.peek()
        return t.kind == "ident" and t.value.lower() in words

    # -- entry --------------------------------------------------------------

    def parse_statement(self):
        """[WITH name AS (query) [, ...]] query: CTEs are lazy DataFrames
        bound in a parser-local namespace."""
        if self._at_ident("with"):
            self.next()
            while True:
                name = self.expect("ident").value
                self.expect("keyword", "as")
                self.expect("op", "(")
                self.ctes[name.lower()] = self.parse_query()
                self.expect("op", ")")
                if not self.accept("op", ","):
                    break
        return self.parse_query()

    def _setop_qualifier(self, op: str) -> bool:
        """[ALL | DISTINCT] after a set-operation keyword; True for ALL."""
        has_all = bool(self.accept("keyword", "all"))
        has_distinct = bool(self.accept("keyword", "distinct"))
        if has_all and has_distinct:
            raise SyntaxError(f"{op.upper()} ALL DISTINCT is contradictory")
        return has_all

    def parse_set_term(self):
        """select (INTERSECT select)*: INTERSECT binds tighter than UNION
        and EXCEPT."""
        df = self.parse_select()
        while self.at_kw("intersect"):
            self.next()
            if self._setop_qualifier("intersect"):
                raise NotImplementedError(
                    "INTERSECT ALL (multiset semantics) is not "
                    "supported; use INTERSECT [DISTINCT]")
            df = df.intersect(self.parse_select())
        return df

    def parse_query(self):
        df = self.parse_set_term()
        while self.at_kw("union", "except"):
            op = self.next().value
            has_all = self._setop_qualifier(op)
            if op == "union":
                df = df.union(self.parse_set_term())
                if not has_all:
                    df = df.distinct()
            elif has_all:
                raise NotImplementedError(
                    "EXCEPT ALL (multiset semantics) is not supported; "
                    "use EXCEPT [DISTINCT]")
            else:
                df = df.subtract(self.parse_set_term())
        if self.at_kw("order"):
            self.next()
            self.expect("keyword", "by")
            orders = [self.parse_sort_item()]
            while self.accept("op", ","):
                orders.append(self.parse_sort_item())
            df = df.order_by(*orders)
        if self.at_kw("limit"):
            self.next()
            df = df.limit(int(self.expect("number").value))
        return df

    def parse_sort_item(self) -> SortOrder:
        e = self.parse_expr()
        asc = True
        if self.accept("keyword", "asc"):
            asc = True
        elif self.accept("keyword", "desc"):
            asc = False
        nulls_first = None
        if self.accept("keyword", "nulls"):
            nulls_first = self.next().value == "first"
        return SortOrder(e, asc, nulls_first)

    # -- SELECT -------------------------------------------------------------

    def parse_select(self):
        self.expect("keyword", "select")
        distinct = bool(self.accept("keyword", "distinct"))
        projections: List[Tuple[Expression, Optional[str]]] = []
        star = False
        while True:
            if self.accept("op", "*"):
                star = True
            else:
                e = self.parse_expr()
                name = None
                if self.accept("keyword", "as"):
                    name = self.next().value
                elif self.peek().kind == "ident" and not self.at_kw():
                    name = self.next().value
                projections.append((e, name))
            if not self.accept("op", ","):
                break
        self.expect("keyword", "from")
        df = self.parse_source()
        df = self.parse_joins(df)
        where = None
        if self.accept("keyword", "where"):
            where = self.parse_expr()
        group_by: Optional[List[Expression]] = None
        group_sets = None  # None: a plain GROUP BY; else key index sets
        if self.accept("keyword", "group"):
            self.expect("keyword", "by")
            if self._at_ident("rollup", "cube") and \
                    self.peek(1).value == "(":
                group_by, group_sets = self.parse_rollup_cube()
            elif self._at_ident("grouping") and \
                    self.peek(1).kind == "ident" and \
                    self.peek(1).value.lower() == "sets":
                group_by, group_sets = self.parse_grouping_sets()
            else:
                group_by = [self.parse_expr()]
                while self.accept("op", ","):
                    group_by.append(self.parse_expr())
        having = None
        if self.accept("keyword", "having"):
            having = self.parse_expr()
        return self.build_select(df, star, projections, where, group_by,
                                 having, distinct, group_sets)

    def parse_rollup_cube(self):
        """ROLLUP (k, ...) or CUBE (k, ...): (keys, their index sets)."""
        from spark_rapids_tpu_torch.dataframe import cube_sets, rollup_sets
        kind = self.next().value.lower()
        self.expect("op", "(")
        keys = [self.parse_expr()]
        while self.accept("op", ","):
            keys.append(self.parse_expr())
        self.expect("op", ")")
        n = len(keys)
        return keys, rollup_sets(n) if kind == "rollup" else cube_sets(n)

    def parse_grouping_sets(self):
        """GROUPING SETS ((a, b), a, ()): (the distinct keys in order of
        first use, each set as their indices).  A bare expression is a set
        of one (Spark's shorthand)."""
        self.next()
        self.next()
        self.expect("op", "(")
        sets, keys = [], []
        while True:
            one = []
            if self.accept("op", "("):
                if not (self.peek().kind == "op" and
                        self.peek().value == ")"):
                    one.append(self.parse_expr())
                    while self.accept("op", ","):
                        one.append(self.parse_expr())
                self.expect("op", ")")
            else:
                one.append(self.parse_expr())
            idxs = []
            for e in one:
                at = next((i for i, k in enumerate(keys)
                           if repr(k) == repr(e)), None)
                if at is None:
                    at = len(keys)
                    keys.append(e)
                idxs.append(at)
            sets.append(tuple(idxs))
            if not self.accept("op", ","):
                break
        self.expect("op", ")")
        return keys, sets

    def build_select(self, df, star, projections, where, group_by, having,
                     distinct, group_sets=None):
        from spark_rapids_tpu_torch.dataframe import Column
        from spark_rapids_tpu_torch.exprs.base import output_name, resolve
        # WHERE runs on the FROM clause's rows, above its joins
        if where is not None:
            df = df.filter(Column(where))
        has_agg = group_by is not None or any(
            _contains_agg(e) for e, _ in projections) or \
            (having is not None and _contains_agg(having))
        if has_agg:
            keys = [resolve(k, df.schema) for k in (group_by or [])]
            key_names = [output_name(k, i) for i, k in enumerate(keys)]
            key_map = {k.fingerprint(): nm for k, nm in zip(keys, key_names)}
            if group_sets is not None:
                gd = df._grouping_sets([Column(k) for k in keys],
                                       group_sets)
            else:
                gd = df.group_by(*[Column(k) for k in keys])
            aggs, post = [], []  # post: (output_name, expr-or-None)
            agg_map = {}  # fingerprint(agg) -> output column name
            for idx, (e, name) in enumerate(projections):
                nm = name or _default_name(e, idx)
                if _contains_agg(e):
                    er = resolve(e, df.schema)
                    if isinstance(er, A.AggregateFunction):
                        aggs.append(Column(Alias(er, nm)))
                        agg_map[er.fingerprint()] = nm
                        post.append((nm, None))
                    else:
                        # arithmetic over aggregates: aggregate the calls
                        # under hidden names, project the expression after
                        for a in _collect_aggs(er):
                            if a.fingerprint() not in agg_map:
                                hn = f"__agg_{len(agg_map)}"
                                aggs.append(Column(Alias(a, hn)))
                                agg_map[a.fingerprint()] = hn
                        post.append((nm, ("postagg", er)))
                else:
                    post.append((nm, resolve(e, df.schema)))
            # HAVING may reference aggregates the select list does not
            hidden = []
            if having is not None:
                having = resolve(having, df.schema)
                for a in _collect_aggs(having):
                    if a.fingerprint() not in agg_map:
                        hn = f"__having_{len(hidden)}"
                        aggs.append(Column(Alias(a, hn)))
                        agg_map[a.fingerprint()] = hn
                        hidden.append(hn)
            out = gd.agg(*aggs)
            if having is not None:
                out = out.filter(Column(_replace_aggs(having, agg_map,
                                                      key_map)))
            sel = []
            for nm, e in post:
                if e is None:
                    sel.append(Column(ColumnRef(nm)).alias(nm))
                elif isinstance(e, tuple) and e[0] == "postagg":
                    e2 = _replace_aggs(e[1], agg_map, key_map)
                    sel.append(Column(e2).alias(nm))
                else:
                    sel.append(Column(_replace_keys(e, key_map)).alias(nm))
            df = out.select(*sel)
        elif star and not projections:
            pass
        else:
            sel = []
            if star:
                sel.append("*")
            for idx, (e, name) in enumerate(projections):
                sel.append(Column(Alias(e, name or _default_name(e, idx))))
            df = df.select(*sel)
        if distinct:
            df = df.distinct()
        return df

    # -- FROM / JOIN --------------------------------------------------------

    def parse_source(self):
        if self.accept("op", "("):
            sub = self.parse_query()
            self.expect("op", ")")
            self.accept("keyword", "as")
            if self.peek().kind == "ident":
                self.next()  # alias (one namespace: names already unique)
            return sub
        name = self.expect("ident").value
        df = self.ctes.get(name.lower())
        if df is None:
            df = self.session.table(name)
        self.accept("keyword", "as")
        if self.peek().kind == "ident" and not self.at_kw():
            self.next()
        return df

    def parse_joins(self, df):
        while True:
            how = None
            if self.at_kw("inner") or self.at_kw("join"):
                self.accept("keyword", "inner")
                how = "inner"
            elif self.at_kw("left"):
                self.next()
                if self.accept("keyword", "semi"):
                    how = "left_semi"
                elif self.accept("keyword", "anti"):
                    how = "left_anti"
                else:
                    self.accept("keyword", "outer")
                    how = "left"
            elif self.at_kw("right"):
                self.next()
                self.accept("keyword", "outer")
                how = "right"
            elif self.at_kw("full"):
                self.next()
                self.accept("keyword", "outer")
                how = "full"
            elif self.at_kw("cross"):
                self.next()
                how = "cross"
            else:
                return df
            self.expect("keyword", "join")
            right = self.parse_source()
            if how == "cross":
                df = df.cross_join(right)
            elif self.accept("keyword", "using"):
                self.expect("op", "(")
                cols = [self.expect("ident").value]
                while self.accept("op", ","):
                    cols.append(self.expect("ident").value)
                self.expect("op", ")")
                df = df.join(right, on=cols, how=how)
            else:
                self.expect("keyword", "on")
                from spark_rapids_tpu_torch.dataframe import Column
                df = df.join(right, on=Column(self.parse_expr()), how=how)

    # -- expressions --------------------------------------------------------

    def parse_expr(self) -> Expression:
        return self.parse_or()

    def parse_or(self) -> Expression:
        from spark_rapids_tpu_torch.exprs.predicates import Or
        e = self.parse_and()
        while self.accept("keyword", "or"):
            e = Or(e, self.parse_and())
        return e

    def parse_and(self) -> Expression:
        from spark_rapids_tpu_torch.exprs.predicates import And
        e = self.parse_not()
        while self.accept("keyword", "and"):
            e = And(e, self.parse_not())
        return e

    def parse_not(self) -> Expression:
        from spark_rapids_tpu_torch.exprs.predicates import Not
        if self.accept("keyword", "not"):
            return Not(self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> Expression:
        from spark_rapids_tpu_torch.exprs import predicates as P
        from spark_rapids_tpu_torch.exprs.nullexprs import IsNotNull, IsNull
        from spark_rapids_tpu_torch.exprs.strings import Like
        e = self.parse_additive()
        while True:
            if self.accept("keyword", "is"):
                neg = bool(self.accept("keyword", "not"))
                self.expect("keyword", "null")
                e = IsNotNull(e) if neg else IsNull(e)
                continue
            neg = False
            save = self.i
            if self.accept("keyword", "not"):
                if self.at_kw("in", "like", "between"):
                    neg = True
                else:
                    self.i = save
                    return e
            if self.accept("keyword", "in"):
                self.expect("op", "(")
                opts = [self.parse_expr()]
                while self.accept("op", ","):
                    opts.append(self.parse_expr())
                self.expect("op", ")")
                e = P.In(e, opts)
                if neg:
                    e = P.Not(e)
                continue
            if self.accept("keyword", "like"):
                e = Like(e, self.expect("string").value)
                if neg:
                    e = P.Not(e)
                continue
            if self.accept("keyword", "between"):
                lo = self.parse_additive()
                self.expect("keyword", "and")
                hi = self.parse_additive()
                e = P.And(P.GreaterThanOrEqual(e, lo),
                          P.LessThanOrEqual(e, hi))
                if neg:
                    e = P.Not(e)
                continue
            op = self.peek()
            if op.kind == "op" and op.value in ("=", "==", "<>", "!=", "<",
                                               "<=", ">", ">="):
                self.next()
                rhs = self.parse_additive()
                cls = {"=": P.Equals, "==": P.Equals, "<>": P.NotEquals,
                       "!=": P.NotEquals, "<": P.LessThan,
                       "<=": P.LessThanOrEqual, ">": P.GreaterThan,
                       ">=": P.GreaterThanOrEqual}[op.value]
                e = cls(e, rhs)
                continue
            return e

    def parse_additive(self) -> Expression:
        from spark_rapids_tpu_torch.exprs.arithmetic import Add, Subtract
        e = self.parse_multiplicative()
        while True:
            if self.accept("op", "+"):
                e = Add(e, self.parse_multiplicative())
            elif self.accept("op", "-"):
                e = Subtract(e, self.parse_multiplicative())
            elif self.accept("op", "||"):
                _not_ported("string concatenation (||)")
            else:
                return e

    def parse_multiplicative(self) -> Expression:
        from spark_rapids_tpu_torch.exprs.arithmetic import (
            Divide, Multiply, Remainder,
        )
        e = self.parse_unary()
        while True:
            if self.accept("op", "*"):
                e = Multiply(e, self.parse_unary())
            elif self.accept("op", "/"):
                e = Divide(e, self.parse_unary())
            elif self.accept("op", "%"):
                e = Remainder(e, self.parse_unary())
            else:
                return e

    def parse_unary(self) -> Expression:
        from spark_rapids_tpu_torch.exprs.arithmetic import (
            UnaryMinus, UnaryPositive,
        )
        if self.accept("op", "-"):
            return UnaryMinus(self.parse_unary())
        if self.accept("op", "+"):
            return UnaryPositive(self.parse_unary())
        return self.parse_primary()

    def parse_primary(self) -> Expression:
        t = self.peek()
        if self.accept("op", "("):
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        if t.kind == "number":
            self.next()
            txt = t.value
            if "." in txt or "e" in txt.lower():
                return Literal(float(txt))
            return Literal(int(txt))
        if t.kind == "string":
            self.next()
            return Literal(t.value)
        if self.accept("keyword", "true"):
            return Literal(True)
        if self.accept("keyword", "false"):
            return Literal(False)
        if self.accept("keyword", "null"):
            return Literal(None)
        if self.accept("keyword", "case"):
            return self.parse_case()
        if self.accept("keyword", "cast"):
            self.expect("op", "(")
            e = self.parse_expr()
            self.expect("keyword", "as")
            tname = self.next().value
            self.expect("op", ")")
            from spark_rapids_tpu_torch.exprs.cast import Cast
            return Cast(e, T.type_from_name(tname))
        if t.kind == "ident":
            self.next()
            if self.peek().kind == "op" and self.peek().value == "(":
                return self.parse_function(t.value)
            # qualified name a.b -> column b (one namespace)
            if self.accept("op", "."):
                return ColumnRef(self.next().value)
            return ColumnRef(t.value)
        raise SyntaxError(f"unexpected token {t.value!r} at {t.pos}")

    def parse_case(self) -> Expression:
        from spark_rapids_tpu_torch.exprs.conditional import CaseWhen
        from spark_rapids_tpu_torch.exprs.predicates import Equals
        operand = None
        if not self.at_kw("when"):
            operand = self.parse_expr()
        branches = []
        while self.accept("keyword", "when"):
            cond = self.parse_expr()
            if operand is not None:
                cond = Equals(operand, cond)
            self.expect("keyword", "then")
            branches.append((cond, self.parse_expr()))
        default = None
        if self.accept("keyword", "else"):
            default = self.parse_expr()
        self.expect("keyword", "end")
        return CaseWhen(branches, default)

    def parse_function(self, name: str) -> Expression:
        self.expect("op", "(")
        name_l = name.lower()
        distinct = bool(self.accept("keyword", "distinct"))
        args: List[Expression] = []
        star = False
        if self.accept("op", "*"):
            star = True
        elif not (self.peek().kind == "op" and self.peek().value == ")"):
            args.append(self.parse_expr())
            while self.accept("op", ","):
                args.append(self.parse_expr())
        self.expect("op", ")")
        e = _build_function(name_l, args, star, distinct)
        if self.accept("keyword", "over"):
            e = self.parse_over(e)
        return e

    def parse_over(self, fn: Expression) -> Expression:
        """OVER ([PARTITION BY ...] [ORDER BY ...] [frame])."""
        from spark_rapids_tpu_torch.exprs.windows import WindowFrame
        self.expect("op", "(")
        part, orders, frame = [], [], None
        if self.accept("keyword", "partition"):
            self.expect("keyword", "by")
            part.append(self.parse_expr())
            while self.accept("op", ","):
                part.append(self.parse_expr())
        if self.accept("keyword", "order"):
            self.expect("keyword", "by")
            orders.append(self.parse_sort_item())
            while self.accept("op", ","):
                orders.append(self.parse_sort_item())
        if self.at_kw("rows", "range"):
            kind = self.next().value
            self.expect("keyword", "between")
            lo = self._frame_bound()
            self.expect("keyword", "and")
            hi = self._frame_bound()
            frame = WindowFrame(kind, lo, hi)
        self.expect("op", ")")
        return WindowExpression(fn, part, orders, frame)

    def _frame_bound(self):
        """UNBOUNDED PRECEDING|FOLLOWING (None), CURRENT ROW (0) or
        n PRECEDING|FOLLOWING (-n or n)."""
        if self.accept("keyword", "unbounded"):
            self.next()
            return None
        if self.accept("keyword", "current"):
            self.expect("keyword", "row")
            return 0
        n = int(self.expect("number").value)
        return -n if self.next().value == "preceding" else n


# Functions the JAX package's SQL front end knows whose expressions the
# port does not have yet.
_UNPORTED_FUNCTIONS = frozenset("""
    upper ucase lower
    initcap hex lcase length char_length trim ltrim rtrim hour minute second
    substring_index split corr covar_pop covar_samp
    concat replace regexp_replace split_part
    concat_ws lpad rpad unix_timestamp to_unix_timestamp date_format
    from_unixtime shiftleft shiftright shiftrightunsigned size
    array_contains array_min array_max sort_array array_position explode
    explode_outer posexplode array element_at
""".split())


def _build_function(name: str, args: List[Expression], star: bool,
                    distinct: bool) -> Expression:
    from spark_rapids_tpu_torch.exprs import datetime as D
    from spark_rapids_tpu_torch.exprs import nullexprs as N
    if name == "count":
        if star or not args:
            return A.count_star()
        if distinct:
            if len(args) != 1:
                raise NotImplementedError(
                    "COUNT(DISTINCT a, b, ...) over multiple columns is "
                    "not supported")
            return A.CountDistinct(args[0])
        return A.Count(args[0])
    if distinct:
        raise NotImplementedError(
            f"{name.upper()}(DISTINCT ...) is not supported; only "
            "COUNT(DISTINCT x)")
    from spark_rapids_tpu_torch.exprs import mathexprs as M
    from spark_rapids_tpu_torch.exprs import windows as W
    simple = {"sum": A.Sum, "avg": A.Average, "mean": A.Average,
              "min": A.Min, "max": A.Max, "first": A.First,
              "last": A.Last, "isnull": N.IsNull,
              "isnan": N.IsNan, "stddev": A.StddevSamp,
              "stddev_samp": A.StddevSamp, "std": A.StddevSamp,
              "stddev_pop": A.StddevPop, "variance": A.VarianceSamp,
              "var_samp": A.VarianceSamp, "var_pop": A.VariancePop,
              "sqrt": M.Sqrt, "exp": M.Exp, "ln": M.Log, "log": M.Log,
              "log2": M.Log2, "log10": M.Log10, "floor": M.Floor,
              "ceil": M.Ceil, "ceiling": M.Ceil, "sin": M.Sin,
              "cos": M.Cos, "tan": M.Tan, "asin": M.Asin, "acos": M.Acos,
              "atan": M.Atan, "signum": M.Signum, "sign": M.Signum,
              "sinh": M.Sinh, "cosh": M.Cosh, "tanh": M.Tanh,
              "asinh": M.Asinh, "acosh": M.Acosh, "atanh": M.Atanh,
              "cot": M.Cot}
    if name == "log" and len(args) == 2:
        return M.Logarithm(args[0], args[1])
    if name == "percentile":
        if len(args) != 2 or not isinstance(args[1], Literal) \
                or isinstance(args[1].value, bool) \
                or not isinstance(args[1].value, (int, float)):
            raise SyntaxError(
                "percentile(expr, p) needs a numeric literal percentage")
        return A.Percentile(args[0], float(args[1].value))
    if name in simple:
        return simple[name](*args)
    if name in ("pow", "power"):
        return M.Pow(args[0], args[1])
    if name == "round":
        return M.Round(args[0], args[1].value if len(args) > 1 else 0)
    if name == "hash":
        from spark_rapids_tpu_torch.exprs.hashing import Murmur3Hash
        return Murmur3Hash(*args)
    if name == "to_date":
        if len(args) == 1:
            return D.ToDate(args[0])
        if len(args) == 2 and isinstance(args[1], Literal):
            return D.ToDate(args[0], str(args[1].value))
        raise SyntaxError("to_date(expr[, fmt]) needs a literal format")
    if name == "grouping_id":
        return A.GroupingID()
    ranking = {"row_number": W.RowNumber, "rank": W.Rank,
               "dense_rank": W.DenseRank}
    if name in ranking:
        return ranking[name]()
    if name in ("lag", "lead"):
        off = args[1].value if len(args) > 1 else 1
        d = args[2] if len(args) > 2 else None
        return (W.Lag if name == "lag" else W.Lead)(args[0], off, d)
    if name == "abs":
        from spark_rapids_tpu_torch.exprs.arithmetic import Abs
        return Abs(args[0])
    dates = {"year": D.Year, "month": D.Month, "day": D.DayOfMonth,
             "dayofmonth": D.DayOfMonth, "dayofweek": D.DayOfWeek,
             "dayofyear": D.DayOfYear, "quarter": D.Quarter,
             "weekday": D.WeekDay, "date_add": D.DateAdd,
             "date_sub": D.DateSub, "datediff": D.DateDiff}
    if name in dates:
        return dates[name](*args)
    if name in ("substr", "substring"):
        from spark_rapids_tpu_torch.exprs.strings import Substring
        pos = args[1].value
        ln = args[2].value if len(args) > 2 else None
        return Substring(args[0], pos, ln)
    if name == "coalesce":
        return N.Coalesce(*args)
    if name == "nvl":
        return N.Coalesce(args[0], args[1])
    if name == "if":
        from spark_rapids_tpu_torch.exprs.conditional import If
        return If(args[0], args[1], args[2])
    if name in _UNPORTED_FUNCTIONS:
        _not_ported(f"the function {name}()")
    raise SyntaxError(f"unknown function {name}")


def _contains_agg(e: Expression) -> bool:
    """True where ``e`` holds a grouping aggregate.  A window expression
    is opaque: ``avg(x) OVER (...)`` is a window over plain rows, and does
    not turn the select into an aggregation."""
    if isinstance(e, WindowExpression):
        return False
    if isinstance(e, A.AggregateFunction):
        return True
    return any(_contains_agg(c) for c in e.children)


def _collect_aggs(e: Expression):
    if isinstance(e, A.AggregateFunction):
        return [e]
    out = []
    for c in e.children:
        out.extend(_collect_aggs(c))
    return out


def _replace_aggs(e: Expression, agg_map, key_map) -> Expression:
    if isinstance(e, A.AggregateFunction):
        return ColumnRef(agg_map[e.fingerprint()])
    if e.fingerprint() in key_map:
        return ColumnRef(key_map[e.fingerprint()])
    new_children = [_replace_aggs(c, agg_map, key_map) for c in e.children]
    if new_children and any(a is not b for a, b in
                            zip(new_children, e.children)):
        return e.with_children(new_children)
    return e


def _replace_keys(e: Expression, key_map) -> Expression:
    if e.fingerprint() in key_map:
        return ColumnRef(key_map[e.fingerprint()])
    new_children = [_replace_keys(c, key_map) for c in e.children]
    if new_children and any(a is not b for a, b in
                            zip(new_children, e.children)):
        return e.with_children(new_children)
    return e


def _default_name(e: Expression, idx: int) -> str:
    if isinstance(e, ColumnRef):
        return e.column
    if isinstance(e, Alias):
        return e.alias_name
    return f"_c{idx}"


def parse_sql(sql: str, session):
    return Parser(tokenize(sql), session).parse_statement()
