"""Comparison and boolean predicates (port of
``spark_rapids_tpu/exprs/predicates.py``).

Comparisons are NULL when either side is NULL; ``And`` implements Kleene
three-valued logic exactly as Spark does (FALSE AND NULL is FALSE).  A DATE
compared with an integer literal compares as INT days since the epoch, the
type :func:`types.promote` gives the pair, as in the JAX package (TPC-H
Q1's ``l_shipdate <= 10471``).  String equality compares both 32-bit row
hashes and the lengths (the stringHash kernel on CUDA), as the JAX package
does; string ordering comparisons are not ported yet
(:meth:`_Comparison.gpu_supported`).
"""

from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import (
    BinaryExpression, DevVal, promote_dev,
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

    def gpu_eval(self, ctx) -> DevVal:
        lv, rv = self.left.gpu_eval(ctx), self.right.gpu_eval(ctx)
        if lv.dtype.is_string:
            return DevVal(T.BOOLEAN, _string_eq_dev(lv, rv),
                          lv.validity & rv.validity)
        a, b, _ = promote_dev(lv, rv)
        return DevVal(T.BOOLEAN, self._compute(a.data, b.data),
                      a.validity & b.validity)


class Equals(_Comparison):
    def _supports_string(self):
        return True

    def _compute(self, x, y):
        return x == y


class LessThan(_Comparison):
    def _compute(self, x, y):
        return x < y


class LessThanOrEqual(_Comparison):
    def _compute(self, x, y):
        return x <= y


class GreaterThan(_Comparison):
    def _compute(self, x, y):
        return x > y


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
