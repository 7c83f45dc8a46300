"""NULL-handling expressions (port of the ``Coalesce`` of
``spark_rapids_tpu/exprs/nullexprs.py``, the key projection of a full
outer USING join)."""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import DevVal, Expression, cast_dev


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
