"""Window execs (port of ``spark_rapids_tpu/ops/window.py``): sort once,
then segmented scans (design notes in ``exprs/windows.py``).

:class:`GpuWindowExec` runs the JAX package's device math as torch ops:
the partition is concatenated into one batch (gatherScatter), sorted by
(partition keys, order keys) with the string keys hashed once for the sort
and for the segment and peer tests (stringHash), then every function is a
prefix sum, a scan, a gather or a sparse-table lookup over the sorted rows.
Float frame sums are differences of an inclusive ``cumsum``, as in the JAX
package, so their last bits follow the scan's summation order; a
whole-partition sum is one segment sum (the JAX package's difference of
running sums there loses the digits of a small partition sorted after
large ones: the means of the corr/covar rewrite).

:class:`CpuWindowExec` is the host twin, vectorised in numpy where the JAX
twin loops over Python rows; its rows are the JAX twin's: rows in the
order of ``(str of each partition key, the order keys)``, partitions
grouped by value equality (a NaN key its own partition, -0.0 with 0.0),
peers by Python's tuple equality (a NaN order key a peer of nothing),
integer sums, counts, ranks, offsets, min and max exact; a whole-partition
float sum is one ``np.sum`` a partition, so its bits are the JAX twin's,
and other float frame sums are differences of a per-partition ``cumsum``
(the JAX twin sums each frame anew), except that a frame holding a NaN or
an infinity is summed anew.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import (
    ColumnBatch, DeviceColumn, HostBatch, HostColumn,
)
from spark_rapids_tpu_torch.exprs.aggregates import (
    AggregateFunction, Average, Count, Max, Min, Sum, segment_sum,
)
from spark_rapids_tpu_torch.exprs.base import (
    CpuEvalCtx, DevVal, GpuEvalCtx,
)
from spark_rapids_tpu_torch.exprs.windows import (
    DenseRank, Lag, Lead, Rank, RowNumber, WindowExpression, WindowFrame,
)
from spark_rapids_tpu_torch.kernels.layout import (
    _gather_string_column, gather_rows,
)
from spark_rapids_tpu_torch.kernels.sort import argsort_batch
from spark_rapids_tpu_torch.kernels.sortkeys import (
    keys_equal_prev, string_key_hashes,
)
from spark_rapids_tpu_torch.ops.cpu_exec import (
    _concat, _string_codes, group_ids, sort_key_words,
)
from spark_rapids_tpu_torch.ops.gpu_exec import _concat_all
from spark_rapids_tpu_torch.plan.physical import (
    CpuExec, GpuExec, PhysicalOp, host_timer,
)

_I64 = np.iinfo(np.int64)


# ---------------------------------------------------------------------------
# Device window math
# ---------------------------------------------------------------------------


def _prefix_incl(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0)


def _range_sum(prefix: torch.Tensor, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
    """sum x[a..b] inclusive from an inclusive prefix sum (0 when b < a)."""
    last = prefix.shape[0] - 1
    hi = prefix[b.clamp(0, last)]
    lo = torch.where(a > 0, prefix[(a - 1).clamp(0, last)],
                     torch.zeros_like(hi))
    return torch.where(b >= a, hi - lo, torch.zeros_like(hi))


def _range_minmax(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  is_min: bool) -> torch.Tensor:
    """Sliding min/max over [a, b] through a log-doubling sparse table,
    ``[levels, cap]``.  The level is the frame length's bit length less
    one (the JAX package takes it from a float ``log2``; any level that
    covers the frame gives the same answer)."""
    if x.dtype == torch.bool:
        return _range_minmax(x.to(torch.uint8), a, b, is_min).to(torch.bool)
    cap = int(x.shape[0])
    levels = max(1, cap.bit_length())
    pick = torch.minimum if is_min else torch.maximum
    sp = [x]
    for j in range(1, levels):
        half = 1 << (j - 1)
        prev = sp[-1]
        shifted = torch.cat([prev[half:], prev[-1:].expand(half)])
        sp.append(pick(prev, shifted))
    table = torch.stack(sp)
    length = (b - a + 1).clamp(min=1)
    k = (torch.frexp(length.to(torch.float64)).exponent - 1).to(torch.int64)
    k = k.clamp(0, levels - 1)
    i1 = a.clamp(0, cap - 1)
    i2 = (b - (torch.ones_like(k) << k) + 1).clamp(0, cap - 1)
    return pick(table[k, i1], table[k, i2])


class _Segments:
    """Row-position structure of the sorted batch: each row's partition
    (segment) bounds and peer-block bounds, int64 positions."""

    def __init__(self, cap: int, live, seg_start, peers_change):
        pos = torch.arange(cap, dtype=torch.int64, device=live.device)
        self.pos = pos
        self.live = live
        # a block's start is the first position of its run of the
        # starts' running count, its end the position before the next
        # run: searchsorted over the count (a scan with indices, as
        # cummax and cummin take, costs ~25 ms at 6M rows)
        seg_count = torch.cumsum(seg_start.to(torch.int64), 0)
        self.seg_start_pos = torch.searchsorted(seg_count, seg_count)
        self.seg_ids = (seg_count - 1).clamp(0, cap - 1)
        seg_len = segment_sum(live.to(torch.int64), self.seg_ids, cap)
        self.seg_end_pos = self.seg_start_pos + \
            (seg_len[self.seg_ids] - 1).clamp(min=0)
        change = seg_start | peers_change
        peer_count = torch.cumsum(change.to(torch.int64), 0)
        self.peer_start_pos = torch.searchsorted(peer_count, peer_count)
        nxt_change = torch.searchsorted(peer_count, peer_count, right=True)
        self.peer_end_pos = torch.minimum(nxt_change - 1, self.seg_end_pos)
        self.change = change


def _search_boundary(keys, target, lo0, hi0, strict: bool):
    """Vectorised binary search: the first position p in [lo0, hi0 + 1)
    with keys[p] > target (strict) or >= target; hi0 + 1 when none.  keys
    must ascend within each row's [lo0, hi0] span."""
    cap = int(keys.shape[0])
    lo = lo0.clone()
    hi = hi0 + 1
    for _ in range(cap.bit_length() + 1):
        active = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        kv = keys[mid.clamp(0, cap - 1)]
        pred = (kv > target) if strict else (kv >= target)
        hi = torch.where(active & pred, mid, hi)
        lo = torch.where(active & ~pred, mid + 1, lo)
    return lo


def _saturating_add(k: torch.Tensor, off: int) -> torch.Tensor:
    """k + off, saturated at the int64 range (a wrapped target would flip
    the search's order and empty the frame)."""
    if k.dtype != torch.int64:
        return k + off
    off = int(off)
    if off >= 0:
        return torch.where(k > _I64.max - off,
                           torch.full_like(k, _I64.max), k + off)
    return torch.where(k < _I64.min - off, torch.full_like(k, _I64.min),
                       k + off)


def _bounded_range_bounds(frame: WindowFrame, segs: _Segments, okey: DevVal,
                          ascending: bool, nulls_first: bool):
    """Value RANGE frame bounds: the rows whose single numeric order key
    lies in [k + start, k + end].  NULL and NaN keys frame over their peer
    block; the search span leaves those blocks out so the keys ascend.
    An UNBOUNDED bound reaches the partition edge, NULL and NaN blocks
    included."""
    integral = okey.dtype.is_integral or okey.dtype in (T.DATE, T.TIMESTAMP)
    kd = okey.data.to(torch.int64 if integral else torch.float64)
    if not ascending and integral:
        # -INT64_MIN wraps: INT64_MIN and INT64_MIN + 1 become frame peers
        kd = torch.where(kd == _I64.min, torch.full_like(kd, _I64.min + 1),
                         kd)
    keys = kd if ascending else -kd
    is_nan = torch.isnan(keys) if okey.dtype.is_fractional else \
        torch.zeros_like(okey.validity)
    finite = okey.validity & ~is_nan
    cap = int(segs.pos.shape[0])

    def seg_count(mask):
        return segment_sum((mask & segs.live).to(torch.int64), segs.seg_ids,
                           cap)[segs.seg_ids]

    nulls_in_seg = seg_count(~okey.validity)
    nans_in_seg = seg_count(is_nan)
    # NULLs sit at the edge nulls_first says; NaN sorts past every value
    lo0 = segs.seg_start_pos + (nulls_in_seg if nulls_first else 0)
    hi0 = segs.seg_end_pos - (0 if nulls_first else nulls_in_seg)
    if ascending:
        hi0 = hi0 - nans_in_seg
    else:
        lo0 = lo0 + nans_in_seg
    if frame.start is None:
        a = segs.seg_start_pos
    else:
        a = _search_boundary(keys, _saturating_add(keys, frame.start), lo0,
                             hi0, strict=False)
    if frame.end is None:
        b = segs.seg_end_pos
    else:
        b = _search_boundary(keys, _saturating_add(keys, frame.end), lo0,
                             hi0, strict=True) - 1
    a = torch.where(finite, a, segs.peer_start_pos)
    b = torch.where(finite, b, segs.peer_end_pos)
    return a, b


def _frame_bounds(frame: WindowFrame, segs: _Segments, okeys=None,
                  order_by=None):
    """(a, b): each row's inclusive frame bounds, row positions."""
    if frame.is_unbounded_whole:
        return segs.seg_start_pos, segs.seg_end_pos
    if frame.kind == "range":
        if frame.is_running:
            return segs.seg_start_pos, segs.peer_end_pos
        # one numeric order key (WindowExpression.gpu_supported)
        assert okeys is not None and len(okeys) == 1, \
            "bounded RANGE frame needs exactly one order key"
        o = order_by[0]
        return _bounded_range_bounds(frame, segs, okeys[0], o.ascending,
                                     o.nulls_first)
    a = segs.seg_start_pos if frame.start is None else \
        torch.maximum(segs.pos + frame.start, segs.seg_start_pos)
    b = segs.seg_end_pos if frame.end is None else \
        torch.minimum(segs.pos + frame.end, segs.seg_end_pos)
    return a, b


def _shifted_strings(v: DevVal, target: torch.Tensor, keep: torch.Tensor,
                     cap: int) -> DevVal:
    """Row r of ``v`` moved from row ``target[r]`` where ``keep``, an
    empty NULL elsewhere.  The kept sources are distinct rows, so the
    bytes fit the input's byte capacity."""
    col = _gather_string_column(v.to_column(), target.clamp(0, cap - 1),
                                keep, cap, int(v.data.shape[0]))
    return DevVal(v.dtype, col.data, col.validity, col.offsets)


def _eval_window_fn(w: WindowExpression, segs: _Segments, cap: int,
                    ctx: GpuEvalCtx, sorted_okeys=None) -> DevVal:
    fn = w.function
    live = segs.live
    if isinstance(fn, RowNumber):
        out = segs.pos - segs.seg_start_pos + 1
        return DevVal(T.INT, out.to(torch.int32), live)
    if isinstance(fn, Rank):
        out = segs.peer_start_pos - segs.seg_start_pos + 1
        return DevVal(T.INT, out.to(torch.int32), live)
    if isinstance(fn, DenseRank):
        c = torch.cumsum(segs.change.to(torch.int64), 0)
        out = c - c[segs.seg_start_pos] + 1
        return DevVal(T.INT, out.to(torch.int32), live)
    if isinstance(fn, Lag):
        direction = 1 if isinstance(fn, Lead) else -1
        target = segs.pos + direction * fn.offset
        in_seg = (target >= segs.seg_start_pos) & \
            (target <= segs.seg_end_pos)
        v = fn.children[0].gpu_eval(ctx)
        if v.dtype.is_string:
            # a string default is placed on the host (gpu_supported)
            return _shifted_strings(v, target, in_seg & live, cap)
        tgt = target.clamp(0, cap - 1)
        data = v.data[tgt]
        validity = in_seg & v.validity[tgt]
        if len(fn.children) > 1:
            d = fn.children[1].gpu_eval(ctx)
            data = torch.where(in_seg, data, d.data.to(data.dtype))
            validity = torch.where(in_seg, validity, d.validity)
        return DevVal(v.dtype, data, validity & live)
    if isinstance(fn, AggregateFunction):
        v = fn.child.gpu_eval(ctx)
        a, b = _frame_bounds(w.frame, segs, sorted_okeys, w.order_by)
        valid = v.validity & live
        frame_cnt = _range_sum(_prefix_incl(valid.to(torch.int64)), a, b)
        if isinstance(fn, Count):
            return DevVal(T.LONG, frame_cnt, live)
        has = (frame_cnt > 0) & live
        if isinstance(fn, (Sum, Average)):
            acc = torch.float64 if (v.dtype.is_fractional or
                                    isinstance(fn, Average)) else torch.int64
            x = v.data.to(acc).masked_fill(~valid, 0)
            if w.frame.is_unbounded_whole:
                # one sum a partition: a difference of running sums would
                # carry the rounding of every partition sorted before it
                total = segment_sum(x, segs.seg_ids, cap)[segs.seg_ids]
            else:
                total = _range_sum(_prefix_incl(x), a, b)
            if isinstance(fn, Average):
                out = total.to(torch.float64) / \
                    frame_cnt.clamp(min=1).to(torch.float64)
                return DevVal(T.DOUBLE, out, has)
            return DevVal(fn.dtype, total.to(fn.dtype.torch_dtype), has)
        if isinstance(fn, (Min, Max)):
            fn_min = isinstance(fn, Min)
            tdt = fn.dtype.torch_dtype
            if fn.dtype.is_fractional:
                ident = float("inf") if fn_min else float("-inf")
            elif fn.dtype == T.BOOLEAN:
                ident = fn_min
            else:
                info = torch.iinfo(tdt)
                ident = info.max if fn_min else info.min
            x = v.data.to(tdt).masked_fill(~valid, ident)
            return DevVal(fn.dtype, _range_minmax(x, a, b, fn_min), has)
    raise NotImplementedError(f"window function {fn.name}")


class GpuWindowExec(GpuExec):
    """The window functions of one (partition, order) spec over each
    partition, concatenated into one batch first: output rows sorted by
    (partition keys, order keys), the child's columns and then one column
    per window expression."""

    def __init__(self, window_exprs: List[WindowExpression],
                 output_names: List[str], child: PhysicalOp,
                 schema: T.Schema):
        super().__init__([child], schema)
        self.window_exprs = window_exprs
        self.output_names = output_names
        w0 = window_exprs[0]
        self.part_keys = w0.partition_by
        self.order_by = w0.order_by
        for w in window_exprs[1:]:
            assert repr(w.partition_by) == repr(self.part_keys) and \
                repr(w.order_by) == repr(self.order_by), \
                "one Window exec handles one (partition, order) spec"

    def describe(self):
        return f"GpuWindow({', '.join(self.output_names)})"

    def _compute(self, batch: ColumnBatch) -> ColumnBatch:
        cap, dev = batch.capacity, batch.device
        ctx0 = GpuEvalCtx(batch)
        pkeys = [e.gpu_eval(ctx0) for e in self.part_keys]
        okeys = [o.child.gpu_eval(ctx0) for o in self.order_by]
        all_vals = pkeys + okeys
        pos = torch.arange(cap, dtype=torch.int64, device=dev)
        live = pos < batch.num_rows
        if all_vals:
            # one stringHash launch for every string key: the sort's, and
            # moved by the permutation, the segment and peer tests'
            hashes = string_key_hashes(all_vals)
            perm = argsort_batch(
                all_vals, [True] * len(pkeys) +
                [o.ascending for o in self.order_by],
                [True] * len(pkeys) + [o.nulls_first for o in self.order_by],
                batch.num_rows,
                groupings=[True] * len(pkeys) + [False] * len(okeys),
                hashes=hashes)
            moved = [None if h is None else (h[0][perm], h[1][perm])
                     for h in hashes]
        else:
            perm, moved = pos, []
        sorted_batch = gather_rows(batch, perm, batch.num_rows)
        ctx = GpuEvalCtx(sorted_batch)
        sorted_pkeys = [e.gpu_eval(ctx) for e in self.part_keys]
        sorted_okeys = [o.child.gpu_eval(ctx) for o in self.order_by]
        np_ = len(pkeys)
        if sorted_pkeys:
            seg_start = live & ~keys_equal_prev(sorted_pkeys, moved[:np_])
        else:
            seg_start = live & (pos == 0)
        if sorted_okeys:
            peers_change = live & ~keys_equal_prev(sorted_okeys, moved[np_:])
        else:
            peers_change = torch.zeros(cap, dtype=torch.bool, device=dev)
        segs = _Segments(cap, live, seg_start, peers_change)
        cols = list(sorted_batch.columns)
        for w in self.window_exprs:
            v = _eval_window_fn(w, segs, cap, ctx, sorted_okeys)
            cols.append(DeviceColumn(v.dtype, v.data, v.validity, v.offsets))
        return ColumnBatch(self.output_schema, cols, batch.num_rows, cap)

    def partitions(self, ctx):
        child_schema = self.children[0].output_schema

        def gen(part):
            merged = _concat_all(list(part), child_schema)
            if merged is not None:
                yield self._compute(merged)

        return [gen(p) for p in self.children[0].partitions(ctx)]


# ---------------------------------------------------------------------------
# Host twin
# ---------------------------------------------------------------------------


def _str_rank(col: HostColumn) -> np.ndarray:
    """Dense ranks of ``str(value)`` in Python's string order (the JAX
    twin orders partitions by ``(value is None, str(value))``); 0 for a
    NULL row."""
    if col.dtype.is_string:
        codes = _string_codes(col)
    else:
        if col.dtype.is_fractional or col.dtype == T.BOOLEAN:
            text = np.array([str(x) for x in col.values.tolist()],
                            dtype=object)
        else:
            text = col.values.astype(np.int64).astype(str)
        codes = np.unique(text.astype(str), return_inverse=True)[1] \
            .reshape(-1)
    return np.where(col.validity, codes.astype(np.int64) + 1, 0)


def _peer_equal_prev(cols: List[HostColumn]) -> np.ndarray:
    """bool[n]: row i's order-key tuple equals row i-1's by Python's
    ``==`` (NULL equals NULL, a NaN equals nothing, -0.0 equals 0.0);
    False at row 0."""
    n = len(cols[0]) if cols else 0
    eq = np.ones(n, dtype=np.bool_)
    for col in cols:
        if col.dtype.is_string:
            vals = _string_codes(col)
        else:
            vals = col.values
        same = np.zeros(n, dtype=np.bool_)
        both_null = ~col.validity[1:] & ~col.validity[:-1]
        both_valid = col.validity[1:] & col.validity[:-1]
        with np.errstate(invalid="ignore"):
            same[1:] = both_null | (both_valid & (vals[1:] == vals[:-1]))
        eq &= same
    if n:
        eq[0] = False
    return eq


def _first_true(pred, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Per row, the first position p in [lo, hi + 1) where ``pred(p, rows)``
    holds (it must hold on a suffix of the span); hi + 1 when none."""
    lo = lo.astype(np.int64).copy()
    hi = hi.astype(np.int64) + 1
    rows = np.arange(len(lo))
    last = max(len(lo) - 1, 0)
    span = int((hi - lo).max()) if len(lo) else 0
    for _ in range(max(span, 1).bit_length() + 1):
        active = lo < hi
        mid = (lo + hi) // 2
        ok = pred(np.clip(mid, 0, last), rows)
        hi = np.where(active & ok, mid, hi)
        lo = np.where(active & ~ok, mid + 1, lo)
    return lo


def _saturating(k: np.ndarray, off: int) -> np.ndarray:
    """k + off, for int64 keys saturated at the int64 range (where Python
    ints, which do not wrap, give a bound past every key)."""
    if k.dtype.kind == "f":
        return k + off
    off = int(off)
    with np.errstate(over="ignore"):
        if off >= 0:
            return np.where(k > _I64.max - off, _I64.max, k + off)
        return np.where(k < _I64.min - off, _I64.min, k + off)


def _runs(new: np.ndarray):
    """(start, end) of each position's run, runs starting where ``new``
    holds (``new[0]`` must)."""
    pos = np.arange(len(new), dtype=np.int64)
    ends = np.flatnonzero(np.append(new[1:], True))
    return (np.maximum.accumulate(np.where(new, pos, 0)),
            ends[np.cumsum(new) - 1])


class _HostSegments:
    """The sorted rows of a host window: ``order`` (row indices in the
    output's order), ``srt`` (the same rows with each partition's rows
    together, in output order), each srt position's partition start and
    end and peer-block start and end."""

    def __init__(self, w0: WindowExpression, hb: HostBatch):
        n = hb.num_rows
        cctx = CpuEvalCtx(hb)
        pcols = [e.cpu_eval(cctx).to_column() for e in w0.partition_by]
        ocols = [o.child.cpu_eval(cctx).to_column() for o in w0.order_by]
        lex = []
        for col in pcols:
            lex.extend([~col.validity, _str_rank(col)])
        lex.extend(sort_key_words(ocols, w0.order_by))
        self.order = np.lexsort(lex[::-1]) if lex else np.arange(n)
        gid = group_ids(pcols, n)[0] if pcols else np.zeros(n, np.int64)
        self.srt = self.order[np.argsort(gid[self.order], kind="stable")]
        g = gid[self.srt]
        new = np.ones(n, dtype=np.bool_)
        new[1:] = g[1:] != g[:-1]
        self.pos = np.arange(n, dtype=np.int64)
        self.seg_start, self.seg_end = _runs(new)
        self.sorted_ocols = [c.take(self.srt) for c in ocols]
        self.change = new | ~_peer_equal_prev(self.sorted_ocols) \
            if ocols else new
        self.peer_start, self.peer_end = _runs(self.change)


def _bounded_range_host(frame: WindowFrame, w: WindowExpression,
                        segs: _HostSegments):
    """(a, b) of a value RANGE frame in srt positions, as the JAX twin's
    ``_bounds`` gives them: a NULL or NaN key frames over its contiguous
    block of its kind; a finite key over the first to the last finite
    key inside [k + start, k + end] (descending: [k - end, k - start]),
    an UNBOUNDED bound the partition edge, an empty frame past it."""
    if len(w.order_by) != 1:
        raise ValueError("a bounded RANGE frame requires exactly one "
                         "ORDER BY expression")
    o = w.order_by[0]
    col = segs.sorted_ocols[0]
    kd = col.dtype
    if not kd.is_numeric and kd not in (T.DATE, T.TIMESTAMP):
        raise ValueError(f"bounded RANGE frames need a numeric order key, "
                         f"got {kd}")
    n = len(col)
    pos, s0, s1 = segs.pos, segs.seg_start, segs.seg_end
    if not n:
        return s0, s1
    fractional = kd.is_fractional
    v = col.values.astype(np.float64 if fractional else np.int64)
    is_nan = np.isnan(v) if fractional else np.zeros(n, np.bool_)
    finite = col.validity & ~is_nan
    null = ~col.validity

    def block(kind: np.ndarray):
        """Each row's contiguous run of ``kind`` rows in its partition."""
        run_new = np.ones(n, dtype=np.bool_)
        run_new[1:] = (kind[1:] != kind[:-1]) | (s0[1:] != s0[:-1])
        return _runs(run_new)

    # each partition's finite keys, [fs, fe], must be contiguous and
    # monotone for the search; a partition whose rows came from two sort
    # runs (-0.0 and 0.0 partition keys) is framed row by row
    starts = np.flatnonzero(pos == s0)
    seg_of = np.cumsum(pos == s0) - 1

    def per_partition(x, ufunc=np.add):
        return ufunc.reduceat(x, starts)[seg_of]

    fs = per_partition(np.where(finite, pos, n), np.minimum)
    fe = fs + per_partition(finite.astype(np.int64)) - 1
    with np.errstate(invalid="ignore", over="ignore"):
        step = np.diff(v)
        back = (step < 0) if o.ascending else (step > 0)
    bad = finite & ((pos < fs) | (pos > fe))
    bad[1:] |= back & finite[1:] & finite[:-1] & (s0[1:] == s0[:-1])
    seg_bad = per_partition(bad.astype(np.int64)) > 0
    if o.ascending:  # keys ascend: [k + start, k + end]
        low = None if frame.start is None else _saturating(v, frame.start)
        high = None if frame.end is None else _saturating(v, frame.end)
        first = fs if low is None else _first_true(
            lambda p, r: v[p] >= low[r], fs, fe)
        last = fe if high is None else _first_true(
            lambda p, r: v[p] > high[r], fs, fe) - 1
    else:  # keys descend: [k - end, k - start]
        low = None if frame.end is None else _saturating(v, -frame.end)
        high = None if frame.start is None else _saturating(v, -frame.start)
        first = fs if high is None else _first_true(
            lambda p, r: v[p] <= high[r], fs, fe)
        last = fe if low is None else _first_true(
            lambda p, r: v[p] < low[r], fs, fe) - 1
    hit = first <= last
    a = s0 if frame.start is None else np.where(hit, first, s1 + 1)
    b = s1 if frame.end is None else np.where(hit, last, s0 - 1)
    nan_s, nan_e = block(is_nan)
    null_s, null_e = block(null)
    a = np.where(is_nan, nan_s, np.where(null, null_s, a))
    b = np.where(is_nan, nan_e, np.where(null, null_e, b))
    for i in np.flatnonzero(seg_bad & finite):
        a[i], b[i] = _bounds_by_row(frame, o.ascending, v, finite, i,
                                    s0[i], s1[i])
    return a, b


def _bounds_by_row(frame: WindowFrame, ascending: bool, v, finite, i, s0,
                   s1):
    """The JAX twin's frame of one finite row, by its own loop."""
    sgn = 1 if ascending else -1
    k = v[i].item()
    lo_v = None if frame.start is None else k + sgn * frame.start
    hi_v = None if frame.end is None else k + sgn * frame.end
    hits = []
    for p in range(s0, s1 + 1):
        x = v[p].item()
        if not finite[p]:
            continue
        if lo_v is not None and sgn * x < sgn * lo_v:
            continue
        if hi_v is not None and sgn * x > sgn * hi_v:
            continue
        hits.append(p)
    a = s0 if frame.start is None else (hits[0] if hits else s1 + 1)
    b = s1 if frame.end is None else (hits[-1] if hits else s0 - 1)
    return a, b


def _host_frame(w: WindowExpression, segs: _HostSegments):
    """(a, b): each srt position's inclusive frame, srt positions."""
    frame = w.frame
    if frame.is_unbounded_whole:
        return segs.seg_start, segs.seg_end
    if frame.kind == "range":
        if frame.is_running:
            return segs.seg_start, segs.peer_end
        return _bounded_range_host(frame, w, segs)
    a = segs.seg_start if frame.start is None else \
        np.maximum(segs.pos + frame.start, segs.seg_start)
    b = segs.seg_end if frame.end is None else \
        np.minimum(segs.pos + frame.end, segs.seg_end)
    return a, b


def _host_prefix_diff(x: np.ndarray, a, b, segs: _HostSegments
                      ) -> np.ndarray:
    """Frame sums of ``x`` (0 where invalid) from each partition's own
    inclusive ``cumsum``."""
    out = np.zeros(len(x), dtype=x.dtype)
    starts = np.flatnonzero(segs.pos == segs.seg_start)
    prefix = np.empty_like(x)
    for s in starts:
        e = segs.seg_end[s] + 1
        prefix[s:e] = np.cumsum(x[s:e])
    bc = np.clip(b, 0, max(len(x) - 1, 0))
    ac = np.clip(a - 1, 0, max(len(x) - 1, 0))
    hi = prefix[bc] if len(x) else out
    lo = np.where(a > segs.seg_start, prefix[ac], 0) if len(x) else out
    with np.errstate(over="ignore"):
        out = np.where(b >= a, hi - lo, 0).astype(x.dtype)
    return out


def _host_window_fn(w: WindowExpression, segs: _HostSegments,
                    hb_sorted: HostBatch) -> HostColumn:
    """One window expression over the srt-ordered rows."""
    fn = w.function
    n = hb_sorted.num_rows
    pos, s0, s1 = segs.pos, segs.seg_start, segs.seg_end
    ones = np.ones(n, dtype=np.bool_)
    if isinstance(fn, RowNumber):
        return HostColumn(T.INT, (pos - s0 + 1).astype(np.int32), ones)
    if isinstance(fn, Rank):
        return HostColumn(T.INT, (segs.peer_start - s0 + 1)
                          .astype(np.int32), ones)
    if isinstance(fn, DenseRank):
        c = np.cumsum(segs.change.astype(np.int64))
        return HostColumn(T.INT, (c - c[s0] + 1).astype(np.int32), ones)
    cctx = CpuEvalCtx(hb_sorted)
    if isinstance(fn, Lag):
        v = fn.children[0].cpu_eval(cctx)
        direction = 1 if isinstance(fn, Lead) else -1
        target = pos + direction * fn.offset
        in_seg = (target >= s0) & (target <= s1)
        tgt = np.clip(target, 0, max(n - 1, 0))
        values = np.asarray(v.values)[tgt] if n else np.asarray(v.values)
        validity = in_seg & v.validity[tgt] if n else v.validity
        if len(fn.children) > 1:
            d = fn.children[1].cpu_eval(cctx)
            dv = np.asarray(d.values)
            if not v.dtype.is_string:
                dv = dv.astype(v.dtype.np_dtype)
            values = np.where(in_seg, values, dv)
            validity = np.where(in_seg, validity, d.validity)
        if v.dtype.is_string:
            values = np.where(validity, values, "").astype(object)
        return HostColumn(v.dtype, values, validity)
    if isinstance(fn, AggregateFunction):
        v = fn.child.cpu_eval(cctx)
        a, b = _host_frame(w, segs)
        valid = v.validity
        cnt_prefix = np.concatenate([[0], np.cumsum(valid.astype(np.int64))])
        frame_cnt = np.where(b >= a, cnt_prefix[np.clip(b + 1, 0, n)] -
                             cnt_prefix[np.clip(a, 0, n)], 0)
        has = frame_cnt > 0
        if isinstance(fn, Count):
            return HostColumn(T.LONG, frame_cnt.astype(np.int64), ones)
        values = np.asarray(v.values)
        if isinstance(fn, (Sum, Average)) and not v.dtype.is_string:
            fractional = v.dtype.is_fractional or isinstance(fn, Average)
            x = np.where(valid, values, 0).astype(
                np.float64 if fractional else np.int64)
            if w.frame.is_unbounded_whole and fractional:
                # one np.sum a partition, the JAX twin's bits
                total = np.zeros(n, dtype=np.float64)
                for s in np.flatnonzero(pos == s0):
                    e = s1[s] + 1
                    total[s:e] = np.sum(x[s:e][valid[s:e]])
            else:
                total = _host_prefix_diff(x, a, b, segs)
                if fractional:
                    # a NaN or an infinity poisons a running sum past its
                    # frame: those frames are summed anew
                    odd = valid & ~np.isfinite(x)
                    op = np.concatenate([[0], np.cumsum(odd)])
                    hit = (b >= a) & (op[np.clip(b + 1, 0, n)] -
                                      op[np.clip(a, 0, n)] > 0)
                    for i in np.flatnonzero(hit):
                        sel = valid[a[i]:b[i] + 1]
                        total[i] = np.sum(x[a[i]:b[i] + 1][sel])
            if isinstance(fn, Average):
                with np.errstate(all="ignore"):
                    out = total / np.maximum(frame_cnt, 1)
                return HostColumn(T.DOUBLE, np.where(has, out, 0.0), has)
            return HostColumn(fn.dtype, np.where(has, total, 0)
                              .astype(fn.dtype.np_dtype), has)
        if isinstance(fn, (Min, Max)) and not v.dtype.is_string:
            return _host_minmax(fn, values, valid, a, b, has)
        # any other aggregate: the JAX twin's cpu_reduce over each frame
        out = [fn.cpu_reduce(values[a[i]:b[i] + 1], valid[a[i]:b[i] + 1])
               if b[i] >= a[i] else fn.cpu_reduce(values[:0], valid[:0])
               for i in range(n)]
        return HostColumn.from_list(fn.dtype, out)
    raise NotImplementedError(f"window function {fn.name}")


def _host_minmax(fn, values, valid, a, b, has) -> HostColumn:
    """Frame min/max through a sparse table; where a float frame holds a
    NaN or a zero, Python's ``min``/``max`` order decides, as in the JAX
    twin (``cpu_reduce``)."""
    n = len(values)
    fn_min = isinstance(fn, Min)
    dt = fn.dtype.np_dtype
    if fn.dtype.is_fractional:
        ident = np.inf if fn_min else -np.inf
    elif fn.dtype == T.BOOLEAN:
        ident = fn_min
    else:
        info = np.iinfo(dt)
        ident = info.max if fn_min else info.min
    x = np.where(valid, values, ident).astype(dt)
    pick = np.minimum if fn_min else np.maximum
    levels = max(1, n.bit_length())
    table = [x]
    for j in range(1, levels):
        half = 1 << (j - 1)
        prev = table[-1]
        table.append(pick(prev, np.concatenate(
            [prev[half:], np.repeat(prev[-1:], half)])))
    length = np.maximum(b - a + 1, 1)
    k = np.clip(np.frexp(length.astype(np.float64))[1] - 1, 0, levels - 1)
    stacked = np.stack(table) if n else np.zeros((1, 0), dt)
    i1 = np.clip(a, 0, max(n - 1, 0))
    i2 = np.clip(b - (1 << k) + 1, 0, max(n - 1, 0))
    out = pick(stacked[k, i1], stacked[k, i2]) if n else x
    if fn.dtype.is_fractional and n:
        tricky = valid & (np.isnan(values) | (values == 0))
        tp = np.concatenate([[0], np.cumsum(tricky.astype(np.int64))])
        hit = (b >= a) & (tp[np.clip(b + 1, 0, n)] - tp[np.clip(a, 0, n)]
                          > 0)
        for i in np.flatnonzero(hit):
            out[i] = fn.cpu_reduce(values[a[i]:b[i] + 1],
                                   valid[a[i]:b[i] + 1])
    return HostColumn(fn.dtype, np.where(has, out, 0).astype(dt), has)


class CpuWindowExec(CpuExec):
    """The host twin of :class:`GpuWindowExec`: each partition's rows
    concatenated, sorted as the JAX twin sorts them, and every window
    expression computed over the grouped rows."""

    def __init__(self, window_exprs: List[WindowExpression],
                 output_names: List[str], child: PhysicalOp,
                 schema: T.Schema):
        super().__init__([child], schema)
        self.window_exprs = window_exprs
        self.output_names = output_names

    def describe(self):
        return f"CpuWindow({', '.join(self.output_names)})"

    def _compute(self, hb: HostBatch) -> HostBatch:
        segs = _HostSegments(self.window_exprs[0], hb)
        sorted_hb = HostBatch(hb.schema, [c.take(segs.srt)
                                          for c in hb.columns])
        extra = [_host_window_fn(w, segs, sorted_hb)
                 for w in self.window_exprs]
        # back from the grouped order to the output order
        back = np.empty(len(segs.srt), dtype=np.int64)
        back[segs.srt] = np.arange(len(segs.srt))
        at = back[segs.order]
        cols = [c.take(segs.order) for c in hb.columns] + \
            [c.take(at) for c in extra]
        return HostBatch(self.output_schema, cols)

    def partitions(self, ctx):
        child_schema = self.children[0].output_schema

        def gen(part):
            batches = list(part)
            if not batches:
                return
            with host_timer(ctx, self):
                hb = _concat(batches, child_schema)
                out = self._compute(hb) if hb.num_rows else None
            if out is not None:
                yield out

        return [gen(p) for p in self.children[0].partitions(ctx)]
