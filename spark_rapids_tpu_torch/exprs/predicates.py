"""Comparison and boolean predicates (port of
``spark_rapids_tpu/exprs/predicates.py``).

Comparisons are NULL when either side is NULL; ``And``, ``Or`` and ``Not``
implement Kleene three-valued logic exactly as Spark does (FALSE AND NULL is
FALSE, TRUE OR NULL is TRUE); ``<=>`` is never NULL.  A DATE
compared with an integer literal compares as INT days since the epoch, the
type :func:`types.promote` gives the pair, as in the JAX package (TPC-H
Q1's ``l_shipdate <= 10471``).  String equality compares both 32-bit row
hashes and the lengths (the stringHash kernel on CUDA), as the JAX package
does; string ordering comparisons are not ported yet
(:meth:`_Comparison.gpu_supported`).  ``IN`` over a string column with
literal options hashes the column once (one stringHash launch) and compares
each row's words with every literal's, hashed on the host; any other ``IN``
is the JAX package's OR of ``Equals``.  ``cpu_eval`` is the JAX package's
host twin: strings compare as Python strings, ordering included.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import (
    BinaryExpression, CpuVal, DevVal, Expression, Literal, UnaryExpression,
    promote_cpu, promote_dev,
)


def _string_eq_dev(a: DevVal, b: DevVal):
    from spark_rapids_tpu_torch.exprs.strings import (
        string_hash2, string_lengths,
    )
    ha1, ha2 = string_hash2(a)
    hb1, hb2 = string_hash2(b)
    return (ha1 == hb1) & (ha2 == hb2) & \
        (string_lengths(a) == string_lengths(b))


class _Comparison(BinaryExpression):
    def _resolve_type(self):
        self.dtype = T.BOOLEAN
        self.nullable = self.left.nullable or self.right.nullable

    def _compute(self, x, y):
        raise NotImplementedError

    def _supports_string(self) -> bool:
        return False

    def gpu_supported(self, conf):
        if self.left.dtype.is_string or self.right.dtype.is_string:
            if not self._supports_string():
                return f"{self.name}: string comparisons are not ported yet"
            if not (self.left.dtype.is_string and
                    self.right.dtype.is_string):
                return f"{self.name}: a string compared with a non-string"
        return None

    def _compute_string_dev(self, a: DevVal, b: DevVal):
        raise NotImplementedError

    def gpu_eval(self, ctx) -> DevVal:
        lv, rv = self.left.gpu_eval(ctx), self.right.gpu_eval(ctx)
        if lv.dtype.is_string:
            return DevVal(T.BOOLEAN, self._compute_string_dev(lv, rv),
                          lv.validity & rv.validity)
        a, b, _ = promote_dev(lv, rv)
        return DevVal(T.BOOLEAN, self._compute(a.data, b.data),
                      a.validity & b.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        lv, rv = self.left.cpu_eval(ctx), self.right.cpu_eval(ctx)
        if lv.dtype.is_string:
            x = np.array([str(v) for v in lv.values], dtype=object)
            y = np.array([str(v) for v in rv.values], dtype=object)
            return CpuVal(T.BOOLEAN,
                          np.asarray(self._compute(x, y), dtype=np.bool_),
                          lv.validity & rv.validity)
        a, b, _ = promote_cpu(lv, rv)
        return CpuVal(T.BOOLEAN,
                      np.asarray(self._compute(a.values, b.values),
                                 dtype=np.bool_),
                      a.validity & b.validity)


class Equals(_Comparison):
    def _supports_string(self):
        return True

    def _compute(self, x, y):
        return x == y

    def _compute_string_dev(self, a, b):
        return _string_eq_dev(a, b)


class NotEquals(_Comparison):
    def _supports_string(self):
        return True

    def _compute(self, x, y):
        return x != y

    def _compute_string_dev(self, a, b):
        return ~_string_eq_dev(a, b)


class LessThan(_Comparison):
    def _compute(self, x, y):
        return x < y


class LessThanOrEqual(_Comparison):
    def _compute(self, x, y):
        return x <= y


class GreaterThan(_Comparison):
    def _compute(self, x, y):
        return x > y


class GreaterThanOrEqual(_Comparison):
    def _compute(self, x, y):
        return x >= y


class EqualNullSafe(BinaryExpression):
    """<=>: never NULL; NULL <=> NULL is TRUE."""

    def _resolve_type(self):
        self.dtype = T.BOOLEAN
        self.nullable = False

    def gpu_supported(self, conf):
        if self.left.dtype.is_string != self.right.dtype.is_string:
            return f"{self.name}: a string compared with a non-string"
        return None

    def gpu_eval(self, ctx) -> DevVal:
        lv, rv = self.left.gpu_eval(ctx), self.right.gpu_eval(ctx)
        if lv.dtype.is_string:
            eq = _string_eq_dev(lv, rv)
        else:
            lv, rv, _ = promote_dev(lv, rv)
            eq = lv.data == rv.data
        both_null = ~lv.validity & ~rv.validity
        data = both_null | (eq & lv.validity & rv.validity)
        return DevVal(T.BOOLEAN, data, torch.ones_like(data))

    def cpu_eval(self, ctx) -> CpuVal:
        lv, rv = self.left.cpu_eval(ctx), self.right.cpu_eval(ctx)
        if lv.dtype.is_string:
            eq = np.array([str(a) == str(b)
                           for a, b in zip(lv.values, rv.values)],
                          dtype=np.bool_)
        else:
            a, b, _ = promote_cpu(lv, rv)
            eq = a.values == b.values
        both_null = ~lv.validity & ~rv.validity
        data = np.where(both_null, True, eq & lv.validity & rv.validity)
        return CpuVal(T.BOOLEAN, data.astype(np.bool_),
                      np.ones(len(data), dtype=np.bool_))


class And(BinaryExpression):
    def _resolve_type(self):
        self.dtype = T.BOOLEAN
        self.nullable = self.left.nullable or self.right.nullable

    def gpu_eval(self, ctx) -> DevVal:
        a, b = self.left.gpu_eval(ctx), self.right.gpu_eval(ctx)
        x = a.data & a.validity  # NULL is "not definitely true"
        y = b.data & b.validity
        false_a = a.validity & ~a.data
        false_b = b.validity & ~b.data
        validity = (a.validity & b.validity) | false_a | false_b
        return DevVal(T.BOOLEAN, x & y, validity)

    def cpu_eval(self, ctx) -> CpuVal:
        a, b = self.left.cpu_eval(ctx), self.right.cpu_eval(ctx)
        av, bv = a.values.astype(np.bool_), b.values.astype(np.bool_)
        false_a = a.validity & ~av
        false_b = b.validity & ~bv
        validity = (a.validity & b.validity) | false_a | false_b
        return CpuVal(T.BOOLEAN, (av & a.validity) & (bv & b.validity),
                      validity)


class Or(BinaryExpression):
    def _resolve_type(self):
        self.dtype = T.BOOLEAN
        self.nullable = self.left.nullable or self.right.nullable

    def gpu_eval(self, ctx) -> DevVal:
        a, b = self.left.gpu_eval(ctx), self.right.gpu_eval(ctx)
        true_a = a.validity & a.data
        true_b = b.validity & b.data
        validity = (a.validity & b.validity) | true_a | true_b
        return DevVal(T.BOOLEAN, true_a | true_b, validity)

    def cpu_eval(self, ctx) -> CpuVal:
        a, b = self.left.cpu_eval(ctx), self.right.cpu_eval(ctx)
        true_a = a.validity & a.values.astype(np.bool_)
        true_b = b.validity & b.values.astype(np.bool_)
        validity = (a.validity & b.validity) | true_a | true_b
        return CpuVal(T.BOOLEAN, true_a | true_b, validity)


class Not(UnaryExpression):
    def _resolve_type(self):
        self.dtype = T.BOOLEAN
        self.nullable = self.child.nullable

    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        return DevVal(T.BOOLEAN, ~v.data.to(torch.bool), v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        return CpuVal(T.BOOLEAN, ~v.values.astype(np.bool_), v.validity)


class In(Expression):
    """value IN (options...): the OR of ``value = option`` (Kleene: NULL
    when no option matches and a side was NULL)."""

    def __init__(self, value: Expression, options):
        opts = tuple(o if isinstance(o, Expression) else Literal(o)
                     for o in options)
        self.children = (value,) + opts
        self.dtype = T.BOOLEAN
        self.nullable = value.nullable

    def with_children(self, children):
        return In(children[0], children[1:])

    def _as_or(self) -> Expression:
        value = self.children[0]
        expr: Expression = Equals(value, self.children[1])
        for opt in self.children[2:]:
            expr = Or(expr, Equals(value, opt))
        return expr

    def _string_literals(self):
        """The options' strings when the value is a string and every
        option a non-NULL string literal, else None."""
        opts = self.children[1:]
        if not self.children[0].dtype.is_string or not all(
                isinstance(o, Literal) and o.dtype.is_string and
                o.value is not None for o in opts):
            return None
        return [str(o.value) for o in opts]

    def gpu_supported(self, conf):
        value = self.children[0]
        for opt in self.children[1:]:
            reason = Equals(value, opt).gpu_supported(conf)
            if reason:
                return f"{self.name}: {reason}"
        return None

    def cpu_eval(self, ctx) -> CpuVal:
        return self._as_or().cpu_eval(ctx)

    def gpu_eval(self, ctx) -> DevVal:
        words = self._string_literals()
        if words is None:
            return self._as_or().gpu_eval(ctx)
        from spark_rapids_tpu_torch.exprs.strings import (
            hash_literal2, string_hash2, string_lengths,
        )
        v = self.children[0].gpu_eval(ctx)
        h1, h2 = string_hash2(v)
        lengths = string_lengths(v)
        hit = torch.zeros_like(v.validity)
        for w in words:
            e1, e2 = hash_literal2(w)
            hit = hit | ((h1 == e1) & (h2 == e2) &
                         (lengths == len(w.encode("utf-8"))))
        return DevVal(T.BOOLEAN, hit, v.validity)
