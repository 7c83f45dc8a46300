"""NULL-handling expressions (port of ``spark_rapids_tpu/exprs/nullexprs.py``:
``IsNull``, ``IsNotNull``, ``IsNan``, ``Coalesce`` (the key projection of a
full outer USING join), ``NaNvl`` and ``AtLeastNNonNulls``), each with
the JAX package's host twin ``cpu_eval``."""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import (
    CpuVal, DevVal, Expression, UnaryExpression, cast_cpu, cast_dev,
)


class _NullTest(UnaryExpression):
    def _resolve_type(self):
        self.dtype = T.BOOLEAN
        self.nullable = False


class IsNull(_NullTest):
    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        return DevVal(T.BOOLEAN, ~v.validity, torch.ones_like(v.validity))

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        return CpuVal(T.BOOLEAN, ~v.validity,
                      np.ones(len(v.validity), np.bool_))


class IsNotNull(_NullTest):
    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        return DevVal(T.BOOLEAN, v.validity.clone(),
                      torch.ones_like(v.validity))

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        return CpuVal(T.BOOLEAN, v.validity.copy(),
                      np.ones(len(v.validity), np.bool_))


class IsNan(_NullTest):
    def gpu_supported(self, conf):
        if self.child.dtype.is_string:
            return "IsNan: the input is a string"
        return None

    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        return DevVal(T.BOOLEAN, torch.isnan(v.data) & v.validity,
                      torch.ones_like(v.validity))

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        data = np.isnan(v.values.astype(np.float64)) & v.validity
        return CpuVal(T.BOOLEAN, data, np.ones(len(v.validity), np.bool_))


class Coalesce(Expression):
    """The first non-NULL child, row by row.  Over strings it is refused,
    as in the JAX package's device path."""

    def __init__(self, *children: Expression):
        if not children:
            raise ValueError("coalesce needs at least one child")
        self.children = tuple(children)
        self.dtype = children[0].dtype
        for c in children[1:]:
            self.dtype = T.promote(self.dtype, c.dtype)
        self.nullable = all(c.nullable for c in children)

    def with_children(self, children):
        return Coalesce(*children)

    def gpu_supported(self, conf):
        if self.dtype.is_string:
            return "Coalesce: coalesce over strings is not ported yet"
        return None

    def gpu_eval(self, ctx) -> DevVal:
        acc = cast_dev(self.children[0].gpu_eval(ctx), self.dtype)
        data, validity = acc.data, acc.validity
        for c in self.children[1:]:
            v = cast_dev(c.gpu_eval(ctx), self.dtype)
            data = torch.where(validity, data, v.data)
            validity = validity | v.validity
        return DevVal(self.dtype, data, validity)

    def cpu_eval(self, ctx) -> CpuVal:
        acc = self.children[0].cpu_eval(ctx)
        if self.dtype.is_string:
            values = acc.values.copy()
            validity = acc.validity.copy()
            for c in self.children[1:]:
                v = c.cpu_eval(ctx)
                take = ~validity & v.validity
                values[take] = v.values[take]
                validity |= v.validity
            return CpuVal(self.dtype, values, validity)
        acc = cast_cpu(acc, self.dtype)
        data, validity = acc.values.copy(), acc.validity.copy()
        for c in self.children[1:]:
            v = cast_cpu(c.cpu_eval(ctx), self.dtype)
            data = np.where(validity, data, v.values)
            validity = validity | v.validity
        return CpuVal(self.dtype, data.astype(self.dtype.np_dtype), validity)


class NaNvl(Expression):
    """nanvl(a, b): b where a is NaN, else a (as DOUBLE)."""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)
        self.dtype = T.DOUBLE
        self.nullable = left.nullable or right.nullable

    def with_children(self, children):
        return NaNvl(*children)

    def gpu_eval(self, ctx) -> DevVal:
        a = cast_dev(self.children[0].gpu_eval(ctx), T.DOUBLE)
        b = cast_dev(self.children[1].gpu_eval(ctx), T.DOUBLE)
        nan = torch.isnan(a.data)
        return DevVal(T.DOUBLE, torch.where(nan, b.data, a.data),
                      torch.where(nan, b.validity, a.validity))

    def cpu_eval(self, ctx) -> CpuVal:
        a = cast_cpu(self.children[0].cpu_eval(ctx), T.DOUBLE)
        b = cast_cpu(self.children[1].cpu_eval(ctx), T.DOUBLE)
        nan = np.isnan(a.values)
        return CpuVal(T.DOUBLE, np.where(nan, b.values, a.values),
                      np.where(nan, b.validity, a.validity).astype(np.bool_))


class AtLeastNNonNulls(Expression):
    """TRUE where at least ``n`` children are non-NULL (and, for floats,
    not NaN): the predicate behind ``dropna``."""

    def __init__(self, n: int, *children: Expression):
        self.n = int(n)
        self.children = tuple(children)
        self.dtype = T.BOOLEAN
        self.nullable = False

    def with_children(self, children):
        return AtLeastNNonNulls(self.n, *children)

    def gpu_eval(self, ctx) -> DevVal:
        total = torch.zeros(ctx.capacity, dtype=torch.int32,
                            device=ctx.device)
        for c in self.children:
            v = c.gpu_eval(ctx)
            valid = v.validity
            if c.dtype in (T.FLOAT, T.DOUBLE):
                valid = valid & ~torch.isnan(v.data.masked_fill(~valid, 0))
            total = total + valid.to(torch.int32)
        return DevVal(T.BOOLEAN, total >= self.n,
                      torch.ones(ctx.capacity, dtype=torch.bool,
                                 device=ctx.device))

    def cpu_eval(self, ctx) -> CpuVal:
        total = np.zeros(ctx.num_rows, dtype=np.int32)
        for c in self.children:
            v = c.cpu_eval(ctx)
            valid = v.validity
            if c.dtype in (T.FLOAT, T.DOUBLE):
                valid = valid & ~np.isnan(np.where(valid, v.values, 0.0))
            total = total + valid.astype(np.int32)
        return CpuVal(T.BOOLEAN, total >= self.n,
                      np.ones(ctx.num_rows, dtype=np.bool_))
