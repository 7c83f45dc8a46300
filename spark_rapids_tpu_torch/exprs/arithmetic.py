"""Arithmetic expressions (port of ``spark_rapids_tpu/exprs/arithmetic.py``,
the multiply the slice needs).

Spark non-ANSI semantics: integral overflow wraps (java semantics), which
matches torch's fixed-width integer arithmetic; a NULL operand gives NULL.
"""

from __future__ import annotations

from spark_rapids_tpu_torch.exprs.base import (
    BinaryExpression, DevVal, promote_dev,
)


class _BinaryArithmetic(BinaryExpression):
    def _compute(self, x, y):
        raise NotImplementedError

    def gpu_eval(self, ctx) -> DevVal:
        a, b, out = promote_dev(self.left.gpu_eval(ctx),
                                self.right.gpu_eval(ctx))
        data = self._compute(a.data, b.data)
        return DevVal(out, data.to(out.torch_dtype), a.validity & b.validity)


class Multiply(_BinaryArithmetic):
    def _compute(self, x, y):
        return x * y
