"""Declarative aggregate functions (port of
``spark_rapids_tpu/exprs/aggregates.py``: sum, count, avg, min, max,
first and last, the central moments (stddev, variance and their
population forms), and count(DISTINCT), percentile, corr, covar_pop,
covar_samp and grouping_id(), which the DataFrame layer rewrites away).

Each aggregate declares per-group buffers and three kernels:
``segment_update`` folds raw rows into buffers, ``segment_merge`` folds
partial buffers, ``finalize`` projects the result.  ``jax.ops.segment_*``
becomes ``index_add_`` (sums, counts) or ``scatter_reduce_`` (min, max) into
an output that starts at the reduction's identity, so empty segments hold
exactly what the JAX package's segment ops give them.  Torch's scatters take
indices in any order, so the JAX package's ``unsorted_segment_ids`` switch
(a lowering contract of TPU scatters) has no counterpart here.

The host twin is ``cpu_reduce_groups``: it reduces every group of a host
aggregate at once, each group's rows contiguous and in row order, and
gives for every group what the JAX package's ``cpu_reduce`` gives for the
group alone: integer sums and counts by one ``reduceat``, float sums and
averages as one ``np.sum`` a group gives them (numpy's pairwise order,
so the bits are the JAX twin's; groups of up to 128 rows summed together,
``_np_group_sums``), min and max by ``reduceat`` except where a float
group holds a NaN or a zero, where Python's ``min``/``max`` order decides
as in the JAX twin, string min and max by Python's, and the moments by one
``np.var`` a group.  ``cpu_reduce`` is its one-group case.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
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


def _group_sums(x: np.ndarray, starts: np.ndarray) -> np.ndarray:
    if not len(x):  # no rows: every group empty
        return np.zeros(len(starts), dtype=x.dtype)
    return np.add.reduceat(x, starts) if len(starts) else x[:0]


def _valid_runs(validity: np.ndarray, starts: np.ndarray):
    """Each group's valid rows: (indices of the valid rows, the groups'
    starts among them, each group's valid count)."""
    counts = _group_sums(validity.astype(np.int64), starts)
    keep = np.flatnonzero(validity)
    vstarts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    return keep, vstarts, counts


def _np_group_sums(vals: np.ndarray, starts: np.ndarray,
                   counts: np.ndarray) -> np.ndarray:
    """Each group's ``np.sum`` (f64), bit for bit, groups of up to 128 rows
    at once: numpy starts from 0.0 and adds a pairwise sum, which under 8
    rows is one running sum and up to 128 rows eight running sums over
    rows i mod 8, combined ((0+1)+(2+3))+((4+5)+(6+7)), then the rest
    one by one.  Larger groups call ``np.sum`` each."""
    out = np.zeros(len(starts), dtype=np.float64)
    few = np.flatnonzero((counts > 0) & (counts < 8))
    s, c = starts[few], counts[few]
    acc = np.zeros(len(few))
    for j in range(7):
        m = c > j
        acc[m] += vals[s[m] + j]
    out[few] = 0.0 + acc
    mid = np.flatnonzero((counts >= 8) & (counts <= 128))
    s, c = starts[mid], counts[mid]
    full = c - c % 8
    lanes = [vals[s + k] for k in range(8)]
    for i in range(8, 128, 8):
        m = i < full
        if not m.any():
            break
        for k in range(8):
            lanes[k][m] += vals[s[m] + i + k]
    acc = ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3])) + \
        ((lanes[4] + lanes[5]) + (lanes[6] + lanes[7]))
    for j in range(7):
        m = full + j < c
        acc[m] += vals[s[m] + full[m] + j]
    out[mid] = 0.0 + acc
    for g in np.flatnonzero(counts > 128):
        out[g] = np.sum(vals[starts[g]:starts[g] + counts[g]])
    return out


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

    def cpu_reduce_groups(self, values: np.ndarray, validity: np.ndarray,
                          starts: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """(values, validity) of every group: ``values``/``validity`` hold
        the groups' rows back to back, group g from ``starts[g]``."""
        raise NotImplementedError

    def cpu_reduce(self, values: np.ndarray, validity: np.ndarray):
        """The value of one group of rows, None for NULL: the one-group
        case of :meth:`cpu_reduce_groups` (the JAX twin's interface)."""
        out, ok = self.cpu_reduce_groups(values, validity,
                                         np.zeros(1, dtype=np.int64))
        return out[0] if ok[0] else None

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

    def cpu_reduce_groups(self, values, validity, starts):
        has = _group_sums(validity.astype(np.int64), starts) > 0
        if self.dtype == T.LONG:
            x = np.where(validity, values, 0).astype(np.int64)
            with np.errstate(over="ignore"):
                out = _group_sums(x, starts)
            return np.where(has, out, 0), has
        keep, vstarts, counts = _valid_runs(validity, starts)
        vals = values[keep].astype(np.float64)
        return _np_group_sums(vals, vstarts, counts), has


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

    def cpu_reduce_groups(self, values, validity, starts):
        out = _group_sums(validity.astype(np.int64), starts)
        return out, np.ones(len(out), dtype=np.bool_)


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

    def cpu_reduce_groups(self, values, validity, starts):
        keep, vstarts, counts = _valid_runs(validity, starts)
        has = counts > 0
        if self.dtype.is_string:
            pick = min if self._is_min else max
            vals = values[keep]
            return np.array([pick(str(v) for v in vals[a:a + c]) if c
                             else "" for a, c in zip(vstarts, counts)],
                            dtype=object), has
        vals = values[keep].astype(self.dtype.np_dtype)
        ufunc = np.minimum if self._is_min else np.maximum
        out = np.zeros(len(starts), dtype=self.dtype.np_dtype)
        if has.any():
            out[has] = ufunc.reduceat(vals, vstarts[has])
        if self.dtype.is_fractional and len(vals):
            # NaN and signed zeros: Python's comparison order decides
            tricky = np.isnan(vals) | (vals == 0)
            hit = _group_sums(np.concatenate([tricky.astype(np.int64),
                                              [0]]), vstarts)[:len(starts)]
            pick = min if self._is_min else max
            for g in np.flatnonzero(has & (hit > 0)):
                run = vals[vstarts[g]:vstarts[g] + counts[g]]
                out[g] = pick(run)
        return out, has


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

    def cpu_reduce_groups(self, values, validity, starts):
        keep, vstarts, counts = _valid_runs(validity, starts)
        vals = values[keep].astype(np.float64)
        has = counts > 0
        sums = _np_group_sums(vals, vstarts, counts)
        return np.where(has, sums / np.maximum(counts, 1), 0.0), has


class CountDistinct(AggregateFunction):
    """count(DISTINCT x).  Never executed: ``GroupedData.agg`` rewrites an
    aggregation that holds it into two stacked aggregations (group by the
    keys and the value, then by the keys), Spark's distinct-aggregate
    rewrite."""

    def _resolve_type(self):
        self.dtype = T.LONG
        self.nullable = False

    def gpu_supported(self, conf):
        return None

    def buffers(self):
        raise AssertionError(
            "CountDistinct must be rewritten before execution")


class GroupingID(AggregateFunction):
    """grouping_id(): the bitmask of the grouping keys a ROLLUP, CUBE or
    GROUPING SETS row masked out.  A marker: the grouping-sets rewrite
    (``GroupingSetsData.agg``) replaces it by ``min(__grouping_id)``, so
    reaching execution means it was used outside grouping sets."""

    def __init__(self):
        super().__init__(Literal(0, T.INT))

    def with_children(self, children):
        return GroupingID()

    def _resolve_type(self):
        self.dtype = T.INT
        self.nullable = False

    def gpu_supported(self, conf):
        return None

    def buffers(self):
        raise AssertionError(
            "grouping_id() is only valid under rollup/cube/grouping sets")


class _CentralMoment(AggregateFunction):
    """The stddev and variance family over three DOUBLE buffers: the
    valid count n, the sum (n times the mean) and m2, the sum of squared
    deviations from the group mean.

    The update is two-pass: the group mean is gathered back to every row
    by ``seg_ids`` before the squared deviations are summed (never the
    cancelling sum of squares minus the squared sum over n).  Partials
    merge by the deviation form of Chan's combine, m2 = sum(m2_i) +
    sum(n_i * (mean_i - mean)^2).  Spark's results: NULL over no row, NaN
    for one row of a sample variant (0/0), m2 clamped at 0."""

    _sample = True   # ddof 1
    _sqrt = False    # stddev, not variance

    def _resolve_type(self):
        self.dtype = T.DOUBLE
        self.nullable = True

    def buffers(self):
        return [AggBufferSpec(T.DOUBLE), AggBufferSpec(T.DOUBLE),
                AggBufferSpec(T.DOUBLE)]

    def segment_update(self, v, seg_ids, num_segments, live_mask):
        use = v.validity & live_mask
        x = v.data.to(torch.float64).masked_fill(~use, 0.0)
        n = segment_sum(use.to(torch.float64), seg_ids, num_segments)
        s1 = segment_sum(x, seg_ids, num_segments)
        mean = s1 / n.clamp(min=1.0)
        d = torch.where(use, x - mean[seg_ids], 0.0)
        m2 = segment_sum(d * d, seg_ids, num_segments)
        ones = _ones(num_segments, n.device)
        return [DevVal(T.DOUBLE, n, ones), DevVal(T.DOUBLE, s1, ones),
                DevVal(T.DOUBLE, m2, ones)]

    def segment_merge(self, buffers, seg_ids, num_segments, live_mask):
        n_i, nm_i, m2_i = (b.data for b in buffers)
        live = live_mask.to(torch.float64)
        s0 = segment_sum(n_i * live, seg_ids, num_segments)
        s1 = segment_sum(nm_i * live, seg_ids, num_segments)
        mean = s1 / s0.clamp(min=1.0)
        dev = nm_i / n_i.clamp(min=1.0) - mean[seg_ids]
        m2 = segment_sum((m2_i + n_i * dev * dev) * live, seg_ids,
                         num_segments)
        ones = _ones(num_segments, s0.device)
        return [DevVal(T.DOUBLE, s0, ones), DevVal(T.DOUBLE, s1, ones),
                DevVal(T.DOUBLE, m2, ones)]

    def finalize(self, buffers):
        n, _, m2 = (b.data for b in buffers)
        m2 = m2.clamp(min=0.0)  # negative rounding residue
        out = m2 / (n - 1.0 if self._sample else n)  # one row, sample: NaN
        if self._sqrt:
            out = torch.sqrt(out)
        return DevVal(T.DOUBLE, out, n > 0)

    def cpu_reduce_groups(self, values, validity, starts):
        """Each group by ``np.var`` over its valid rows, as the JAX twin's
        ``cpu_reduce`` reduces one group (a sample variant's one-row
        group is NaN without it)."""
        keep, vstarts, counts = _valid_runs(validity, starts)
        vals = values[keep].astype(np.float64)
        out = np.zeros(len(starts), dtype=np.float64)
        if self._sample:
            out[counts == 1] = np.nan
        ddof = 1 if self._sample else 0
        with np.errstate(all="ignore"):
            for g in np.flatnonzero(counts > ddof):
                var = float(np.var(vals[vstarts[g]:vstarts[g] + counts[g]],
                                   ddof=ddof))
                out[g] = float(np.sqrt(var)) if self._sqrt else var
        return out, counts > 0


class StddevSamp(_CentralMoment):
    _sample, _sqrt = True, True


class StddevPop(_CentralMoment):
    _sample, _sqrt = False, True


class VarianceSamp(_CentralMoment):
    _sample, _sqrt = True, False


class VariancePop(_CentralMoment):
    _sample, _sqrt = False, False


_FAR = 1 << 62  # past every row index


class _FirstLast(AggregateFunction):
    """first(x) / last(x) [ignoring NULLs]: the value of the group's row
    with the smallest (largest) input index.  The buffers are the value,
    its validity and that row's LONG index, so partials merge by index.

    The exec hands the update each row's global input index
    (``row_index``): the row's position in its batch plus its partition
    and batch ordinals above bit 31 (``ops/gpu_exec.py``
    ``input_index_base``), so the pick is the group's first (last) row in
    input order, partitions then batches then rows, on the device as on
    the host, whose twin takes it from each group's rows in row order.
    The JAX package's device path keeps the batch-local position instead,
    so where one group spans partitions its merge compares positions of
    different batches; wherever each group lives in one batch the two
    agree."""

    _is_first = True
    #: segment_update takes the rows' input indices
    takes_row_index = True

    def __init__(self, child: Expression, ignore_nulls: bool = False):
        self.ignore_nulls = bool(ignore_nulls)
        super().__init__(child)

    def with_children(self, children):
        return type(self)(children[0], self.ignore_nulls)

    def _resolve_type(self):
        self.dtype = self.child.dtype
        self.nullable = True

    def buffers(self):
        return [AggBufferSpec(self.dtype), AggBufferSpec(T.BOOLEAN),
                AggBufferSpec(T.LONG)]

    def _pick(self, data, valid, idx, seg_ids, num_segments, live_mask):
        dev = data.device
        cand = live_mask & valid if self.ignore_nulls else live_mask
        far = _FAR if self._is_first else -_FAR
        key = torch.where(cand, idx, far)
        best = torch.full((num_segments,), far, dtype=torch.int64,
                          device=dev).scatter_reduce_(
            0, seg_ids.to(torch.int64), key,
            "amin" if self._is_first else "amax", include_self=True)
        # indices are unique, so each group has at most one winner
        winner = cand & (best[seg_ids] == key)
        slot = torch.where(winner, seg_ids, num_segments)
        out = torch.zeros(num_segments + 1, dtype=data.dtype, device=dev)
        out.index_put_((slot,), data)
        ok = torch.zeros(num_segments + 1, dtype=torch.bool, device=dev)
        ok.index_put_((slot,), valid & winner)
        has = best != far
        return out[:num_segments], ok[:num_segments] & has, \
            torch.where(has, best, 0)

    def segment_update(self, v, seg_ids, num_segments, live_mask,
                       row_index=None):
        if row_index is None:
            row_index = torch.arange(int(v.data.shape[0]),
                                     dtype=torch.int64, device=v.data.device)
        val, ok, idx = self._pick(v.data.to(self.dtype.torch_dtype),
                                  v.validity, row_index.to(torch.int64),
                                  seg_ids, num_segments, live_mask)
        ones = _ones(num_segments, val.device)
        return [DevVal(self.dtype, val, ones), DevVal(T.BOOLEAN, ok, ones),
                DevVal(T.LONG, idx, ones)]

    def segment_merge(self, buffers, seg_ids, num_segments, live_mask):
        val, ok, idx = buffers
        nv, nok, nidx = self._pick(val.data, ok.data.to(torch.bool),
                                   idx.data, seg_ids, num_segments,
                                   live_mask)
        ones = _ones(num_segments, nv.device)
        return [DevVal(self.dtype, nv, ones), DevVal(T.BOOLEAN, nok, ones),
                DevVal(T.LONG, nidx, ones)]

    def finalize(self, buffers):
        val, ok, _ = buffers
        return DevVal(self.dtype, val.data, ok.data.to(torch.bool))

    def cpu_reduce_groups(self, values, validity, starts):
        n = len(validity)
        counts = np.diff(np.append(starts, n)).astype(np.int64)
        rows = np.arange(n, dtype=np.int64)
        if self.ignore_nulls:
            pos = np.where(validity, rows, n if self._is_first else -1)
        else:
            pos = rows
        has = counts > 0
        pick = np.zeros(len(starts), dtype=np.int64)
        if has.any():
            ufunc = np.minimum if self._is_first else np.maximum
            pick[has] = ufunc.reduceat(pos, starts[has]) if len(pos) else 0
        found = has & (pick >= 0) & (pick < n)
        pick = np.where(found, pick, 0)
        if self.dtype.is_string:
            out = np.array([str(values[p]) if ok else "" for p, ok in
                            zip(pick, found)], dtype=object)
        else:
            out = np.where(found, values[pick] if n else 0, 0) \
                .astype(self.dtype.np_dtype)
        return out, found & (validity[pick] if n else found)


class First(_FirstLast):
    _is_first = True


class Last(_FirstLast):
    _is_first = False


class Percentile(AggregateFunction):
    """percentile(x, p): Spark's exact percentile, interpolating linearly
    between the two closest ranks.  Never executed itself:
    ``GroupedData.agg`` rewrites it into ``row_number`` and ``count``
    windows and one SUM of interpolation weights
    (``GroupedData._agg_with_percentile``)."""

    def __init__(self, child: Expression, percentage: float):
        if not 0.0 <= float(percentage) <= 1.0:
            raise ValueError(
                f"percentile percentage must be in [0, 1]: {percentage}")
        self.percentage = float(percentage)
        super().__init__(child)

    def with_children(self, children):
        return Percentile(children[0], self.percentage)

    def _resolve_type(self):
        dt = self.child.dtype
        if dt != T.NULL and not dt.is_numeric:  # NULL: not resolved yet
            raise TypeError(f"percentile needs a numeric input, got {dt}")
        self.dtype = T.DOUBLE
        self.nullable = True

    def gpu_supported(self, conf):
        return None

    def buffers(self):
        raise AssertionError(
            "Percentile must be rewritten before execution")


class _BinaryStatMarker(AggregateFunction):
    """corr / covar_pop / covar_samp: two inputs, never executed itself.
    ``GroupedData.agg`` rewrites each into window means over the rows
    where both inputs are non-NULL, SUMs of centered products and a
    projection of their ratio (``GroupedData._agg_with_binary_stats``),
    since every aggregation path takes one input."""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)
        self._resolve_type()

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def _resolve_type(self):
        for c in self.children:
            if c.dtype != T.NULL and not c.dtype.is_numeric:
                raise TypeError(f"{type(self).__name__} needs numeric "
                                f"inputs, got {c.dtype}")
        self.dtype = T.DOUBLE
        self.nullable = True

    def gpu_supported(self, conf):
        return None

    def buffers(self):
        raise AssertionError(
            f"{type(self).__name__} must be rewritten before execution")


class CovarPop(_BinaryStatMarker):
    pass


class CovarSamp(_BinaryStatMarker):
    pass


class Corr(_BinaryStatMarker):
    pass


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
