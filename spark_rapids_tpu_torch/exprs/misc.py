"""Array construction (port of ``CreateArray`` from
``spark_rapids_tpu/exprs/misc.py``).

``array(e1, ..., ek)`` gives each row a k-element array.  On the device
the elements ride the varlen layout (``batch.py``): a flat ``[cap * k]``
buffer, row-major, with offsets ``r * k`` clamped at the live rows' total,
so they stay constant past ``num_rows``.  Element NULLs have no device
layout: an array of nullable inputs, or of strings, is built on the host,
one list a row.  The other array expressions are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import element_value
from spark_rapids_tpu_torch.exprs.base import (
    CpuVal, DevVal, Expression, cast_cpu,
)


class CreateArray(Expression):
    """array(e1, e2, ...) -> array<the inputs' common type>, never NULL."""

    def __init__(self, *children: Expression):
        if not children:
            raise ValueError("array() needs at least one element")
        elem = children[0].dtype
        for c in children[1:]:
            elem = T.promote(elem, c.dtype)
        self.children = tuple(children)
        self.dtype = T.ArrayType(elem)
        self.nullable = False

    def with_children(self, children):
        return CreateArray(*children)

    def gpu_supported(self, conf):
        if self.dtype.element.is_string:
            return ("CreateArray: array<string> has variable-length "
                    "elements, which only the host holds")
        if any(c.nullable for c in self.children):
            return ("CreateArray: nullable inputs can make NULL elements, "
                    "which only the host holds")
        return None

    def gpu_eval(self, ctx) -> DevVal:
        elem = self.dtype.element
        k = len(self.children)
        cap = ctx.capacity
        vals = [c.gpu_eval(ctx).data.to(elem.torch_dtype)
                for c in self.children]
        data = torch.stack(vals, dim=1).reshape(-1)  # row-major [cap * k]
        total = ctx.batch.num_rows.to(torch.int32) * k
        offsets = torch.minimum(
            torch.arange(cap + 1, dtype=torch.int32, device=ctx.device) * k,
            total)
        return DevVal(self.dtype, data,
                      torch.ones(cap, dtype=torch.bool, device=ctx.device),
                      offsets)

    def cpu_eval(self, ctx) -> CpuVal:
        elem = self.dtype.element
        n = ctx.num_rows
        vals = [cast_cpu(c.cpu_eval(ctx), elem) if not elem.is_string
                else c.cpu_eval(ctx) for c in self.children]
        cols = [[None if not ok else element_value(elem, x)
                 for x, ok in zip(v.values, v.validity)] for v in vals]
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = [c[i] for c in cols]
        return CpuVal(self.dtype, out, np.ones(n, dtype=np.bool_))

