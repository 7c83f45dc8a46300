"""Conditional expressions: IF and CASE WHEN (port of
``spark_rapids_tpu/exprs/conditional.py``).  A NULL predicate selects the
next branch (Spark semantics).  String branches run on the host twin
``cpu_eval`` only, as in the JAX package."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import (
    CpuVal, DevVal, Expression, cast_cpu, cast_dev,
)


def _common_type(exprs: Sequence[Expression]) -> T.DataType:
    out = exprs[0].dtype
    for e in exprs[1:]:
        out = T.promote(out, e.dtype)
    return out


def _truth(p: DevVal) -> torch.Tensor:
    return p.data.to(torch.bool) & p.validity


class If(Expression):
    def __init__(self, predicate: Expression, if_true: Expression,
                 if_false: Expression):
        self.children = (predicate, if_true, if_false)
        self.dtype = _common_type([if_true, if_false])
        self.nullable = if_true.nullable or if_false.nullable or \
            predicate.nullable

    def with_children(self, children):
        return If(*children)

    def gpu_eval(self, ctx) -> DevVal:
        cond = _truth(self.children[0].gpu_eval(ctx))
        a = cast_dev(self.children[1].gpu_eval(ctx), self.dtype)
        b = cast_dev(self.children[2].gpu_eval(ctx), self.dtype)
        return DevVal(self.dtype, torch.where(cond, a.data, b.data),
                      torch.where(cond, a.validity, b.validity))

    def cpu_eval(self, ctx) -> CpuVal:
        p = self.children[0].cpu_eval(ctx)
        av = self.children[1].cpu_eval(ctx)
        bv = self.children[2].cpu_eval(ctx)
        cond = p.values.astype(np.bool_) & p.validity
        if self.dtype.is_string:
            values = np.where(cond, av.values, bv.values)
            validity = np.where(cond, av.validity, bv.validity)
            return CpuVal(self.dtype, values.astype(object),
                          validity.astype(np.bool_))
        a, b = cast_cpu(av, self.dtype), cast_cpu(bv, self.dtype)
        data = np.where(cond, a.values, b.values)
        validity = np.where(cond, a.validity, b.validity)
        return CpuVal(self.dtype, data.astype(self.dtype.np_dtype),
                      validity.astype(np.bool_))


class CaseWhen(Expression):
    """CASE WHEN p1 THEN v1 [WHEN p2 THEN v2 ...] [ELSE e] END."""

    def __init__(self, branches: Sequence[Tuple[Expression, Expression]],
                 else_value: Optional[Expression] = None):
        self.branches = [tuple(b) for b in branches]
        self.else_value = else_value
        flat: List[Expression] = []
        for p, v in self.branches:
            flat.extend((p, v))
        if else_value is not None:
            flat.append(else_value)
        self.children = tuple(flat)
        values = [v for _, v in self.branches]
        if else_value is not None:
            values.append(else_value)
        self.dtype = _common_type(values)
        self.nullable = (else_value is None or else_value.nullable
                         or any(v.nullable for v in values))

    def with_children(self, children):
        n = len(self.branches)
        branches = [(children[2 * i], children[2 * i + 1]) for i in range(n)]
        else_value = children[2 * n] if len(children) > 2 * n else None
        return CaseWhen(branches, else_value)

    def gpu_eval(self, ctx) -> DevVal:
        cap, dev = ctx.capacity, ctx.device
        data = torch.zeros(cap, dtype=self.dtype.torch_dtype, device=dev)
        validity = torch.zeros(cap, dtype=torch.bool, device=dev)
        if self.else_value is not None:
            ev = cast_dev(self.else_value.gpu_eval(ctx), self.dtype)
            data, validity = ev.data, ev.validity
        # in reverse, so that the first branch that holds wins
        for pred, value in reversed(self.branches):
            cond = _truth(pred.gpu_eval(ctx))
            v = cast_dev(value.gpu_eval(ctx), self.dtype)
            data = torch.where(cond, v.data, data)
            validity = torch.where(cond, v.validity, validity)
        return DevVal(self.dtype, data, validity)

    def cpu_eval(self, ctx) -> CpuVal:
        n = ctx.num_rows
        if self.dtype.is_string:
            values = np.array([""] * n, dtype=object)
        else:
            values = np.zeros(n, dtype=self.dtype.np_dtype)
        validity = np.zeros(n, dtype=np.bool_)
        if self.else_value is not None:
            ev = self.else_value.cpu_eval(ctx)
            if not self.dtype.is_string:
                ev = cast_cpu(ev, self.dtype)
            values, validity = ev.values.copy(), ev.validity.copy()
        decided = np.zeros(n, dtype=np.bool_)
        for pred, value in self.branches:
            p = pred.cpu_eval(ctx)
            v = value.cpu_eval(ctx)
            if not self.dtype.is_string:
                v = cast_cpu(v, self.dtype)
            cond = p.values.astype(np.bool_) & p.validity & ~decided
            values = np.where(cond, v.values, values)
            validity = np.where(cond, v.validity, validity)
            decided |= cond
        values = values.astype(object) if self.dtype.is_string else \
            values.astype(self.dtype.np_dtype)
        return CpuVal(self.dtype, values, validity.astype(np.bool_))
