"""Declarative aggregate functions (port of
``spark_rapids_tpu/exprs/aggregates.py``: sum, count, avg, min, max).

Each aggregate declares per-group buffers and three kernels:
``segment_update`` folds raw rows into buffers, ``segment_merge`` folds
partial buffers, ``finalize`` projects the result.  ``jax.ops.segment_*``
becomes ``index_add_`` (sums, counts) or ``scatter_reduce_`` (min, max) into
an output that starts at the reduction's identity, so empty segments hold
exactly what the JAX package's segment ops give them.  Torch's scatters take
indices in any order, so the JAX package's ``unsorted_segment_ids`` switch
(a lowering contract of TPU scatters) has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import DevVal, Expression, Literal


def segment_sum(x: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = torch.zeros(num_segments, dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg_ids, x)


def _seg_any_valid(valid, seg_ids, num_segments, live_mask):
    return segment_sum((valid & live_mask).to(torch.int32), seg_ids,
                       num_segments) > 0


def _ones(num_segments: int, device) -> torch.Tensor:
    return torch.ones(num_segments, dtype=torch.bool, device=device)


def _sum_result_type(dt: T.DataType) -> T.DataType:
    return T.LONG if dt.is_integral else T.DOUBLE


@dataclasses.dataclass
class AggBufferSpec:
    dtype: T.DataType


class AggregateFunction(Expression):
    """Base: declares buffers + segment kernels.  Not columnar-evaluable."""

    def __init__(self, child: Expression):
        self.children = (child,)
        self._resolve_type()

    @property
    def child(self):
        return self.children[0]

    def _resolve_type(self):
        raise NotImplementedError

    def buffers(self) -> List[AggBufferSpec]:
        raise NotImplementedError

    def segment_update(self, v: DevVal, seg_ids, num_segments: int,
                       live_mask) -> List[DevVal]:
        raise NotImplementedError

    def segment_merge(self, buffers: List[DevVal], seg_ids,
                      num_segments: int, live_mask) -> List[DevVal]:
        raise NotImplementedError

    def finalize(self, buffers: List[DevVal]) -> DevVal:
        raise NotImplementedError

    def gpu_supported(self, conf):
        from spark_rapids_tpu_torch.config import VARIABLE_FLOAT_AGG
        if self.child.dtype.is_string:
            return f"{self.name} over strings is not ported yet"
        if self.child.dtype.is_fractional and \
                not VARIABLE_FLOAT_AGG.get(conf) and \
                type(self) in (Sum, Average):
            return (f"{self.name} over floats can produce non-deterministic "
                    "results; set spark.rapids.sql.variableFloatAgg.enabled")
        return None


class Sum(AggregateFunction):
    def _resolve_type(self):
        self.dtype = _sum_result_type(self.child.dtype)
        self.nullable = True

    def buffers(self):
        return [AggBufferSpec(self.dtype), AggBufferSpec(T.BOOLEAN)]

    def segment_update(self, v, seg_ids, num_segments, live_mask):
        x = v.data.to(self.dtype.torch_dtype)
        use = v.validity & live_mask
        s = segment_sum(x.masked_fill(~use, 0), seg_ids, num_segments)
        any_v = _seg_any_valid(v.validity, seg_ids, num_segments, live_mask)
        ones = _ones(num_segments, x.device)
        return [DevVal(self.dtype, s, ones), DevVal(T.BOOLEAN, any_v, ones)]

    def segment_merge(self, buffers, seg_ids, num_segments, live_mask):
        s, has = buffers
        total = segment_sum(s.data.masked_fill(~live_mask, 0), seg_ids,
                            num_segments)
        any_v = _seg_any_valid(has.data.to(torch.bool), seg_ids,
                               num_segments, live_mask)
        ones = _ones(num_segments, total.device)
        return [DevVal(self.dtype, total, ones),
                DevVal(T.BOOLEAN, any_v, ones)]

    def finalize(self, buffers):
        s, has = buffers
        return DevVal(self.dtype, s.data, has.data.to(torch.bool))


class Count(AggregateFunction):
    def _resolve_type(self):
        self.dtype = T.LONG
        self.nullable = False

    def gpu_supported(self, conf):
        return None

    def buffers(self):
        return [AggBufferSpec(T.LONG)]

    def segment_update(self, v, seg_ids, num_segments, live_mask):
        use = v.validity & live_mask
        c = segment_sum(use.to(torch.int64), seg_ids, num_segments)
        return [DevVal(T.LONG, c, _ones(num_segments, c.device))]

    def segment_merge(self, buffers, seg_ids, num_segments, live_mask):
        c = segment_sum(buffers[0].data.masked_fill(~live_mask, 0), seg_ids,
                        num_segments)
        return [DevVal(T.LONG, c, _ones(num_segments, c.device))]

    def finalize(self, buffers):
        d = buffers[0].data
        return DevVal(T.LONG, d, torch.ones_like(d, dtype=torch.bool))


class _MinMax(AggregateFunction):
    _is_min = True

    def _resolve_type(self):
        self.dtype = self.child.dtype
        self.nullable = True

    def gpu_supported(self, conf):
        if self.child.dtype.is_string:
            return f"{self.name} over strings is not ported yet"
        return None

    def buffers(self):
        return [AggBufferSpec(self.dtype), AggBufferSpec(T.BOOLEAN)]

    def _ident(self):
        if self.dtype.is_fractional:
            return float("inf") if self._is_min else float("-inf")
        if self.dtype == T.BOOLEAN:
            return self._is_min
        info = torch.iinfo(self.dtype.torch_dtype)
        return info.max if self._is_min else info.min

    def _seg_reduce(self, x, seg_ids, num_segments):
        if x.dtype == torch.bool:  # scatter_reduce has no bool kernels
            return self._seg_reduce(x.to(torch.uint8), seg_ids,
                                    num_segments).to(torch.bool)
        out = torch.full((num_segments,), self._ident(), dtype=x.dtype,
                         device=x.device)
        return out.scatter_reduce_(0, seg_ids.to(torch.int64), x,
                                   "amin" if self._is_min else "amax",
                                   include_self=True)

    def segment_update(self, v, seg_ids, num_segments, live_mask):
        use = v.validity & live_mask
        x = v.data.to(self.dtype.torch_dtype).masked_fill(~use, self._ident())
        m = self._seg_reduce(x, seg_ids, num_segments)
        any_v = _seg_any_valid(v.validity, seg_ids, num_segments, live_mask)
        ones = _ones(num_segments, m.device)
        return [DevVal(self.dtype, m, ones), DevVal(T.BOOLEAN, any_v, ones)]

    def segment_merge(self, buffers, seg_ids, num_segments, live_mask):
        m, has = buffers
        use = has.data.to(torch.bool) & live_mask
        x = m.data.masked_fill(~use, self._ident())
        total = self._seg_reduce(x, seg_ids, num_segments)
        any_v = _seg_any_valid(has.data.to(torch.bool), seg_ids,
                               num_segments, live_mask)
        ones = _ones(num_segments, total.device)
        return [DevVal(self.dtype, total, ones),
                DevVal(T.BOOLEAN, any_v, ones)]

    def finalize(self, buffers):
        m, has = buffers
        return DevVal(self.dtype, m.data, has.data.to(torch.bool))


class Min(_MinMax):
    _is_min = True


class Max(_MinMax):
    _is_min = False


class Average(AggregateFunction):
    def _resolve_type(self):
        self.dtype = T.DOUBLE
        self.nullable = True

    def buffers(self):
        return [AggBufferSpec(T.DOUBLE), AggBufferSpec(T.LONG)]

    def segment_update(self, v, seg_ids, num_segments, live_mask):
        use = v.validity & live_mask
        x = v.data.to(torch.float64).masked_fill(~use, 0.0)
        s = segment_sum(x, seg_ids, num_segments)
        c = segment_sum(use.to(torch.int64), seg_ids, num_segments)
        ones = _ones(num_segments, s.device)
        return [DevVal(T.DOUBLE, s, ones), DevVal(T.LONG, c, ones)]

    def segment_merge(self, buffers, seg_ids, num_segments, live_mask):
        s, c = buffers
        st = segment_sum(s.data.masked_fill(~live_mask, 0.0), seg_ids,
                         num_segments)
        ct = segment_sum(c.data.masked_fill(~live_mask, 0), seg_ids,
                         num_segments)
        ones = _ones(num_segments, st.device)
        return [DevVal(T.DOUBLE, st, ones), DevVal(T.LONG, ct, ones)]

    def finalize(self, buffers):
        s, c = buffers
        nonzero = c.data > 0
        data = s.data / c.data.masked_fill(~nonzero, 1).to(torch.float64)
        return DevVal(T.DOUBLE, data, nonzero)


@dataclasses.dataclass
class AggregateExpression:
    """An aggregate call in an output position: fn + output name."""

    fn: AggregateFunction
    output_name: str

    @property
    def dtype(self):
        return self.fn.dtype


def count_star() -> Count:
    return Count(Literal(1, T.INT))
