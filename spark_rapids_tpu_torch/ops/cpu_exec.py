"""Host operators: the planner's per-operator fallback (port of
``spark_rapids_tpu/ops/cpu_exec.py``).

The planner places an operator here when its tags say the device cannot
run it or a conf switches it off (``plan/overrides.py``); nothing else
moves an operator to the host.  Each exec works on host batches in numpy
with Spark's CPU semantics and gives, row for row and bit for bit, what the
JAX package's twin gives, whose loops over Python rows are vectorised
here:

* groups come out in first-seen order; a group's rows are reduced in row
  order with the numpy reduction the JAX twin applies to them
  (``AggregateFunction.cpu_reduce_groups``), so float sums keep their bits;
  a NaN key is a group of its own (Python's ``nan != nan``), -0.0 groups
  and joins with 0.0;
* a sort is stable, NULLs where ``nulls_first`` puts them, NaN above every
  number, strings by code point;
* a hash join emits each left row's matches in build order, then the
  unmatched rows (left, then right); a nested-loop join emits a left row's
  NULL-padded row in its place;
* an expand emits every input batch once per projection list; an
  explode repeats each row once per element of its array; the window
  exec is ``ops/window.py``.

A string column may arrive as bytes and offsets (a device batch copied
back, a file scan); the execs gather it in that form, and an expression
that reads it decodes one ``str`` a row (``exprs/base.py:CpuVal``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import (
    HostBatch, HostColumn, _string_host_to_buffers,
)
from spark_rapids_tpu_torch.exprs.aggregates import AggregateExpression
from spark_rapids_tpu_torch.exprs.base import (
    Alias, ColumnRef, CpuEvalCtx, Expression, SortOrder,
)
from spark_rapids_tpu_torch.plan.physical import (
    CpuExec, PhysicalOp, host_timer,
)

#: pairs a nested-loop join evaluates its condition over at once
_NLJ_PAIRS_PER_STEP = 1 << 20


def _from_rows(schema: T.Schema, rows: List[tuple]) -> HostBatch:
    return HostBatch(schema, [
        HostColumn.from_list(f.dtype, [r[i] for r in rows])
        for i, f in enumerate(schema.fields)])


def _concat(batches: List[HostBatch], schema: T.Schema) -> HostBatch:
    if not batches:
        return HostBatch(schema, [
            HostColumn(f.dtype, np.zeros(0, dtype=object if f.dtype.is_string
                                         else f.dtype.np_dtype),
                       np.zeros(0, dtype=np.bool_)) for f in schema.fields])
    return batches[0] if len(batches) == 1 else HostBatch.concat(batches)


def _take(batch: HostBatch, index: np.ndarray,
          schema: Optional[T.Schema] = None) -> HostBatch:
    return HostBatch(schema or batch.schema,
                     [c.take(index) for c in batch.columns])


def _null_column(dtype: T.DataType, n: int) -> HostColumn:
    values = np.array([""] * n, dtype=object) if dtype.is_string else \
        np.zeros(n, dtype=dtype.np_dtype)
    return HostColumn(dtype, values, np.zeros(n, dtype=np.bool_))


def _concat_columns(parts: List[HostColumn]) -> HostColumn:
    parts = [p for p in parts if len(p)] or parts[:1]
    if len(parts) == 1:
        return parts[0]
    f = T.Field("c", parts[0].dtype)
    return HostBatch.concat([HostBatch(T.Schema([f]), [p])
                             for p in parts]).columns[0]


def _key_column(e: Expression, batch: HostBatch) -> HostColumn:
    """A key's host column: a column reference keeps the batch's column
    (a string one in the form it came in), anything else is evaluated."""
    while isinstance(e, Alias):
        e = e.children[0]
    if isinstance(e, ColumnRef):
        return batch.column(e.column)
    return e.cpu_eval(CpuEvalCtx(batch)).to_column()


#: a key whose values span fewer integers than this, and fewer than
#: four a row, is coded through a table of that size (no sort); sparser
#: ones by a sort
_DENSE_SPAN = 1 << 22


def _dense(values: np.ndarray) -> np.ndarray:
    """Dense int64 codes of integer values in value order, equal values
    one code: through a presence table when they span few integers,
    else by ``np.unique``."""
    if not len(values):
        return np.zeros(0, dtype=np.int64)
    lo, hi = int(values.min()), int(values.max())
    if hi - lo < min(_DENSE_SPAN, 4 * len(values)):
        shifted = (values - lo).astype(np.int64) if lo else \
            values.astype(np.int64, copy=False)
        present = np.zeros(hi - lo + 1, dtype=np.int64)
        present[shifted] = 1
        return (np.cumsum(present) - 1)[shifted]
    return np.unique(values, return_inverse=True)[1].reshape(-1) \
        .astype(np.int64)


def _small_sort(codes: np.ndarray, span: int) -> np.ndarray:
    """Stable argsort of codes in [0, span): a radix sort through the
    smallest unsigned type that holds them."""
    for dt in (np.uint8, np.uint16, np.uint32):
        if span <= np.iinfo(dt).max + 1:
            return np.argsort(codes.astype(dt), kind="stable")
    return np.argsort(codes, kind="stable")


def _runs_codes(keys: List[np.ndarray]) -> np.ndarray:
    """Dense codes of rows keyed by several integer columns, in the
    lexicographic order of the columns (the first one primary)."""
    order = np.lexsort(keys[::-1])
    new = np.zeros(len(order), dtype=np.bool_)
    for k in keys:
        sk = k[order]
        new[1:] |= sk[1:] != sk[:-1]
    codes = np.empty(len(order), dtype=np.int64)
    codes[order] = np.cumsum(new)
    return codes


def _string_codes(col: HostColumn) -> np.ndarray:
    """Dense codes of a string column's values, equal strings one code,
    in code-point (UTF-8 byte) order: each row's bytes, zero-padded, read
    as big-endian words of up to 8 bytes, then its length (which tells "a"
    from "a\\0"), coded word by word."""
    if col.offsets is not None:
        data, offsets = col.values, col.offsets
    else:
        offsets, data = _string_host_to_buffers(np.asarray(col.values),
                                                col.validity)
    starts = offsets[:-1].astype(np.int64)
    lengths = np.diff(offsets.astype(np.int64))
    width = int(lengths.max()) if len(lengths) else 0
    codes = None
    for w in range(0, width, 8):
        k = min(8, width - w)  # the last word holds only k bytes
        word = np.zeros(len(lengths), dtype=np.uint64)
        for j in range(k):
            has = lengths > w + j
            byte = data[np.where(has, starts + w + j, 0)]
            word |= np.where(has, byte, 0).astype(np.uint64) << \
                np.uint64(8 * (k - 1 - j))
        codes = _then(codes, _dense(word))
    return _then(codes, _dense(lengths))


def _then(codes: Optional[np.ndarray], minor: np.ndarray) -> np.ndarray:
    """Dense codes ordered by ``codes``, then by ``minor``."""
    return minor if codes is None else _combine_codes([codes, minor])


def _value_codes(col: HostColumn):
    """(codes, usable): equal values one code (-0.0 with 0.0); a NULL row
    and a NaN row are not usable as a key value (the caller codes them
    apart).  Codes are dense from 0 in value order."""
    usable = col.validity.copy()
    if col.dtype.is_string:
        return _string_codes(col), usable
    values = col.values
    if col.dtype.is_fractional:
        values = values.astype(np.float64) + 0.0  # -0.0 -> 0.0
        nan = np.isnan(values)
        usable &= ~nan
        values = np.where(nan, 0.0, values)
        return np.unique(values, return_inverse=True)[1].reshape(-1) \
            .astype(np.int64), usable
    return _dense(values.astype(np.int64)), usable


def _combine_codes(code_cols: List[np.ndarray]) -> np.ndarray:
    """One dense int64 code a row for several dense code columns, in the
    lexicographic order of the columns."""
    if not code_cols:
        return np.zeros(0, dtype=np.int64)
    out = _dense(code_cols[0])
    for c in code_cols[1:]:
        span = int(c.max()) + 1 if len(c) else 1
        if len(out) and int(out.max()) < (1 << 62) // max(span, 1):
            out = _dense(out * span + c)
        else:
            out = _runs_codes([out, c])
    return out.astype(np.int64)


def group_ids(key_cols: List[HostColumn], n: int):
    """(group id a row, first row of each group, stable row order by group
    id), groups numbered in first-seen order, as the JAX twin's dict of
    key tuples numbers them: a NULL is one key value, each NaN row a
    group of its own."""
    if not key_cols:
        return (np.zeros(n, dtype=np.int64), np.zeros(min(n, 1), np.int64),
                np.arange(n))
    parts = []
    for col in key_cols:
        codes, usable = _value_codes(col)
        codes = np.where(usable, codes + 2, 0)
        if col.dtype.is_fractional:
            nan = col.validity & ~usable
            if nan.any():  # every NaN row its own code past the values
                codes = np.where(nan, int(codes.max(initial=0)) + 1 +
                                 np.arange(n, dtype=np.int64), codes)
        parts.append(np.where(~col.validity, 1, codes))
    gid = _combine_codes(parts)  # dense, in value order
    k = int(gid.max()) + 1 if n else 0
    by_value = _small_sort(gid, k)
    starts = np.concatenate([[0], np.cumsum(np.bincount(gid,
                                                        minlength=k))[:-1]])
    first = by_value[starts]  # each value's first row
    seen = np.argsort(first, kind="stable")
    rank = np.empty(k, dtype=np.int64)
    rank[seen] = np.arange(k)
    gid = rank[gid]
    return gid, first[seen], _small_sort(gid, k)


def sort_indices(batch: HostBatch, orders: List[SortOrder],
                 key_ordinals: List[int]) -> np.ndarray:
    """The JAX twin's stable row order (its ``sort_key_fn``): NULLs per
    ``nulls_first``, NaN above every number, strings by their bytes,
    descending keys reversed."""
    lex = sort_key_words([batch.columns[i] for i in key_ordinals], orders)
    if not lex:
        return np.arange(batch.num_rows)
    return np.lexsort(lex[::-1])


def sort_key_words(cols: List[HostColumn], orders: List[SortOrder]
                   ) -> List[np.ndarray]:
    """The int64 words whose lexicographic order (the first word
    primary) is ``sort_key_fn``'s over ``cols``: a NULL-class word and a
    rank word per key."""
    keys = []
    for o, col in zip(orders, cols):
        if col.dtype.is_string:
            rank = _string_codes(col)
        elif col.dtype.is_fractional:
            values = col.values.astype(np.float64)
            rank = np.unique(values, return_inverse=True)[1].reshape(-1)
            # np.unique ranks NaN last, as the JAX key does
        else:
            rank = np.unique(col.values, return_inverse=True)[1].reshape(-1)
        rank = rank.astype(np.int64)
        if not o.ascending:
            rank = -rank
        null_cls = 0 if o.nulls_first else 1
        cls = np.where(col.validity, 1 - null_cls, null_cls)
        rank = np.where(col.validity, rank, 0)
        keys.append(cls)
        keys.append(rank)
    return keys


class CpuInMemoryScanExec(CpuExec):
    """Hands out host batches, dealt round-robin over the partitions."""

    def __init__(self, batches: List[HostBatch], schema: T.Schema,
                 num_partitions: int):
        super().__init__([], schema)
        self.batches = batches
        self._n = max(1, num_partitions)

    def partitions(self, ctx):
        parts: List[List[HostBatch]] = [[] for _ in range(self._n)]
        for i, b in enumerate(self.batches):
            parts[i % self._n].append(b)
        return [iter(p) for p in parts]


class CpuRangeExec(CpuExec):
    """``session.range`` on the host: one LONG batch a partition."""

    def __init__(self, start, end, step, num_partitions, schema):
        super().__init__([], schema)
        self.start, self.end, self.step = start, end, step
        self._n = max(1, num_partitions)

    def describe(self):
        return f"CpuRange({self.start}, {self.end}, {self.step})"

    def partitions(self, ctx):
        total = max(0, -(-(self.end - self.start) // self.step))
        per = -(-total // self._n)

        def gen(p):
            lo = self.start + p * per * self.step
            hi = min(self.start + (p + 1) * per * self.step, self.end) \
                if self.step > 0 else max(
                    self.start + (p + 1) * per * self.step, self.end)
            vals = np.arange(lo, hi, self.step, dtype=np.int64)
            if len(vals):
                yield HostBatch(self.output_schema, [
                    HostColumn(T.LONG, vals, np.ones(len(vals), np.bool_))])

        return [gen(p) for p in range(self._n)]


class CpuProjectExec(CpuExec):
    def __init__(self, exprs: List[Expression], child: PhysicalOp,
                 schema: T.Schema):
        super().__init__([child], schema)
        self.exprs = exprs

    def describe(self):
        return f"CpuProject({', '.join(f.name for f in self.output_schema)})"

    def _column(self, e: Expression, hb: HostBatch, cctx) -> HostColumn:
        inner = e
        while isinstance(inner, Alias):
            inner = inner.children[0]
        if isinstance(inner, ColumnRef):  # pass the column on as it is
            return hb.column(inner.column)
        return e.cpu_eval(cctx).to_column()

    def partitions(self, ctx):
        def gen(pi, part):
            base = 0
            for hb in part:
                with host_timer(ctx, self):
                    cctx = CpuEvalCtx(hb, pi, base)
                    out = HostBatch(self.output_schema,
                                    [self._column(e, hb, cctx)
                                     for e in self.exprs])
                base += hb.num_rows
                yield out

        return [gen(pi, p) for pi, p in
                enumerate(self.children[0].partitions(ctx))]


class CpuExpandExec(CpuExec):
    """Grouping-sets expansion on the host: every input batch once per
    projection list, a column reference passed on as it is."""

    def __init__(self, projections: List[List[Expression]],
                 child: PhysicalOp, schema: T.Schema):
        super().__init__([child], schema)
        self.projections = projections

    def describe(self):
        return f"CpuExpand({len(self.projections)} projections)"

    def partitions(self, ctx):
        def gen(part):
            for hb in part:
                with host_timer(ctx, self):
                    outs = [HostBatch(self.output_schema,
                                      [_key_column(e, hb) for e in proj])
                            for proj in self.projections]
                yield from outs

        return [gen(p) for p in self.children[0].partitions(ctx)]


class CpuFilterExec(CpuExec):
    def __init__(self, condition: Expression, child: PhysicalOp):
        super().__init__([child], child.output_schema)
        self.condition = condition

    def describe(self):
        return f"CpuFilter({self.condition!r})"

    def partitions(self, ctx):
        def gen(pi, part):
            base = 0
            for hb in part:
                with host_timer(ctx, self):
                    v = self.condition.cpu_eval(CpuEvalCtx(hb, pi, base))
                    keep = np.flatnonzero(v.validity &
                                          v.values.astype(bool))
                    out = _take(hb, keep) if len(keep) else None
                base += hb.num_rows
                if out is not None:
                    yield out

        return [gen(pi, p) for pi, p in
                enumerate(self.children[0].partitions(ctx))]


class CpuUnionExec(CpuExec):
    def __init__(self, children: List[PhysicalOp], schema: T.Schema):
        super().__init__(children, schema)

    def partitions(self, ctx):
        out = []
        for c in self.children:
            for p in c.partitions(ctx):
                out.append(self._rename(p))
        return out

    def _rename(self, part):
        for hb in part:
            yield HostBatch(self.output_schema, hb.columns)


class CpuLocalLimitExec(CpuExec):
    def __init__(self, n: int, child: PhysicalOp):
        super().__init__([child], child.output_schema)
        self.n = n

    def describe(self):
        return f"CpuLocalLimit({self.n})"

    def partitions(self, ctx):
        def gen(part):
            left = self.n
            for hb in part:
                if left <= 0:
                    break
                if hb.num_rows > left:
                    hb = hb.slice(0, left)
                left -= hb.num_rows
                yield hb

        return [gen(p) for p in self.children[0].partitions(ctx)]


class CpuSortExec(CpuExec):
    def __init__(self, orders: List[SortOrder], key_ordinals: List[int],
                 child: PhysicalOp):
        super().__init__([child], child.output_schema)
        self.orders = orders
        self.key_ordinals = key_ordinals

    def describe(self):
        return f"CpuSort({len(self.orders)} keys)"

    def partitions(self, ctx):
        def gen(part):
            batches = list(part)
            with host_timer(ctx, self):
                hb = _concat(batches, self.output_schema)
                out = _take(hb, sort_indices(hb, self.orders,
                                             self.key_ordinals)) \
                    if hb.num_rows else None
            if out is not None:
                yield out

        return [gen(p) for p in self.children[0].partitions(ctx)]


class CpuAggregateExec(CpuExec):
    """The whole aggregation on the host, after an exchange has put each
    key's rows in one partition: groups in first-seen order, each group's
    values reduced in row order (``cpu_reduce_groups``).  Without keys an
    empty input still gives the one row of SQL defaults."""

    def __init__(self, key_exprs: List[Expression],
                 aggs: List[AggregateExpression], child: PhysicalOp,
                 schema: T.Schema):
        super().__init__([child], schema)
        self.key_exprs = key_exprs
        self.aggs = aggs

    def describe(self):
        return f"CpuAggregate(keys={len(self.key_exprs)})"

    def _aggregate(self, hb: HostBatch) -> Optional[HostBatch]:
        n = hb.num_rows
        if not n and self.key_exprs:
            return None
        fields = self.output_schema.fields
        if not n:  # the one row of SQL defaults
            empty = np.zeros(0)
            return _from_rows(self.output_schema, [tuple(
                a.fn.cpu_reduce(empty, empty.astype(np.bool_))
                for a in self.aggs)])
        key_cols = [_key_column(e, hb) for e in self.key_exprs]
        gid, first, perm = group_ids(key_cols, n)
        counts = np.bincount(gid, minlength=len(first))
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]]) \
            .astype(np.int64)
        cols = [c.take(first) for c in key_cols]
        cctx = CpuEvalCtx(hb)
        for f, a in zip(fields[len(key_cols):], self.aggs):
            v = a.fn.child.cpu_eval(cctx)
            values, validity = a.fn.cpu_reduce_groups(
                np.asarray(v.values)[perm], v.validity[perm], starts)
            cols.append(HostColumn(f.dtype, values, validity))
        return HostBatch(self.output_schema, cols)

    def partitions(self, ctx):
        child_schema = self.children[0].output_schema
        refs = {e.column for x in self.key_exprs +
                [a.fn.child for a in self.aggs]
                for e in x.collect(lambda e: isinstance(e, ColumnRef))}
        # a column to carry the row count when nothing is read (count(*))
        keep = [i for i, f in enumerate(child_schema.fields)
                if f.name in refs] or list(range(len(child_schema)))[:1]
        schema = T.Schema([child_schema.fields[i] for i in keep])

        def gen(part):
            # only the columns the keys and the aggregates read
            batches = [HostBatch(schema, [hb.columns[i] for i in keep])
                       for hb in part]
            with host_timer(ctx, self):
                out = self._aggregate(_concat(batches, schema))
            if out is not None:
                yield out

        return [gen(p) for p in self.children[0].partitions(ctx)]


class CpuSampleExec(CpuExec):
    """Bernoulli sample: partition p draws ``rng.rand(rows) < fraction``
    a batch from ``np.random.RandomState(seed + p)``."""

    def __init__(self, fraction: float, seed: int, child: PhysicalOp):
        super().__init__([child], child.output_schema)
        self.fraction = fraction
        self.seed = seed

    def describe(self):
        return f"CpuSample({self.fraction}, seed={self.seed})"

    def partitions(self, ctx):
        def gen(pi, part):
            rng = np.random.RandomState(self.seed + pi)
            for hb in part:
                keep = np.flatnonzero(rng.rand(hb.num_rows) < self.fraction)
                if len(keep):
                    yield _take(hb, keep)

        return [gen(pi, p) for pi, p in
                enumerate(self.children[0].partitions(ctx))]


class CpuGenerateExec(CpuExec):
    """explode / posexplode on the host, and their outer forms: each
    input row repeated once per element of its array (an outer explode
    keeps an empty or NULL array's row once, with NULL ``pos`` and
    element), vectorised by one ``np.repeat`` by the arrays' lengths; the
    JAX twin walks the rows in Python and gives the same rows."""

    def __init__(self, column: str, alias: str, pos: bool, outer: bool,
                 child: PhysicalOp, schema: T.Schema):
        super().__init__([child], schema)
        self.column = column
        self.alias = alias
        self.pos = pos
        self.outer = outer

    def describe(self):
        kind = "posexplode" if self.pos else "explode"
        return f"CpuGenerate({kind}{'_outer' if self.outer else ''}" \
            f"({self.column}))"

    def _explode(self, hb: HostBatch) -> Optional[HostBatch]:
        ci = hb.schema.index_of(self.column)
        arr = hb.columns[ci]
        lists = [x if ok else [] for x, ok in zip(arr.values, arr.validity)]
        lengths = np.fromiter((len(x) for x in lists), dtype=np.int64,
                              count=len(lists))
        reps = np.maximum(lengths, 1) if self.outer else lengths
        total = int(reps.sum())
        if not total:
            return None
        parent = np.repeat(np.arange(hb.num_rows, dtype=np.int64), reps)
        # an element's place in its array; -1 on an outer row of nothing
        starts = np.cumsum(reps) - reps
        pos = np.arange(total, dtype=np.int64) - np.repeat(starts, reps)
        has = np.repeat(lengths > 0, reps)
        pos = np.where(has, pos, -1)
        cols = [c.take(parent) for i, c in enumerate(hb.columns) if i != ci]
        if self.pos:
            cols.append(HostColumn(T.INT, np.maximum(pos, 0).astype(np.int32),
                                   pos >= 0))
        elem = self.output_schema.fields[-1].dtype
        flat = [e for x in lists for e in x]
        valid = np.zeros(total, dtype=np.bool_)
        valid[has] = [e is not None for e in flat]
        if elem.is_string:
            values = np.full(total, "", dtype=object)
            values[has] = [str(e) if e is not None else "" for e in flat]
        else:
            values = np.zeros(total, dtype=elem.np_dtype)
            values[has] = np.asarray([e if e is not None else 0
                                      for e in flat], dtype=elem.np_dtype)
        cols.append(HostColumn(elem, values, valid))
        return HostBatch(self.output_schema, cols)

    def partitions(self, ctx):
        def gen(part):
            for hb in part:
                with host_timer(ctx, self):
                    out = self._explode(hb)
                if out is not None:
                    yield out

        return [gen(p) for p in self.children[0].partitions(ctx)]


def _pair_condition(condition: Expression, left: HostBatch,
                    right: HostBatch, li: np.ndarray,
                    ri: np.ndarray) -> np.ndarray:
    """The residual condition over joined pairs, TRUE only: NULL drops
    the pair.  Only the columns it names are gathered (left ones first),
    as on the device."""
    refs = {e.column for e in condition.collect(
        lambda e: isinstance(e, ColumnRef))}
    fields, cols = [], []
    for side, idx in ((left, li), (right, ri)):
        for f, c in zip(side.schema.fields, side.columns):
            if f.name in refs:
                fields.append(f)
                cols.append(c.take(idx))
    pairs = HostBatch(T.Schema(fields), cols)
    pairs.num_rows = len(li)
    v = condition.cpu_eval(CpuEvalCtx(pairs))
    return v.validity & v.values.astype(bool)


def _join_output(schema: T.Schema, how: str, left: HostBatch,
                 right: HostBatch, li: np.ndarray,
                 ri: np.ndarray) -> HostBatch:
    """Output rows: left row ``li[k]`` beside right row ``ri[k]``, -1 for
    a NULL-padded side; semi and anti joins keep only the left side."""
    if how in ("left_semi", "left_anti"):
        return _take(left, li, schema)
    cols = []
    for side, idx in ((left, li), (right, ri)):
        pad = idx < 0
        if not pad.any():
            cols.extend(c.take(idx) for c in side.columns)
            continue
        # the real rows, then the NULL rows, put back in output order
        keep = np.flatnonzero(~pad)
        order = np.argsort(np.concatenate([keep, np.flatnonzero(pad)]),
                           kind="stable")
        for c in side.columns:
            both = _concat_columns([c.take(idx[keep]),
                                    _null_column(c.dtype, int(pad.sum()))])
            cols.append(both.take(order))
    return HostBatch(schema, cols)


class CpuHashJoinExec(CpuExec):
    """Equi-join on the host, all six join types, with the residual
    condition.  Rows whose key holds a NULL (or a NaN) match nothing."""

    def __init__(self, left: PhysicalOp, right: PhysicalOp,
                 left_keys: List[Expression], right_keys: List[Expression],
                 how: str, condition: Optional[Expression],
                 schema: T.Schema):
        super().__init__([left, right], schema)
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.how = how
        self.condition = condition

    def describe(self):
        return f"CpuHashJoin({self.how})"

    def _codes(self, lb: HostBatch, rb: HostBatch):
        """(left codes, right codes), equal keys one code; -1 where a key
        is NULL or NaN."""
        nl, parts, usable = lb.num_rows, [], None
        for le, re_ in zip(self.left_keys, self.right_keys):
            lc, rc = _key_column(le, lb), _key_column(re_, rb)
            if lc.dtype != rc.dtype and not (lc.dtype.is_string or
                                             rc.dtype.is_string):
                to = T.promote(lc.dtype, rc.dtype)
                lc = HostColumn(to, lc.values.astype(to.np_dtype),
                                lc.validity)
                rc = HostColumn(to, rc.values.astype(to.np_dtype),
                                rc.validity)
            both = _concat_columns([lc, rc])
            codes, ok = _value_codes(both)
            parts.append(codes)
            usable = ok if usable is None else usable & ok
        code = _combine_codes(parts)
        code = np.where(usable, code, -1)
        return code[:nl], code[nl:]

    def _pairs(self, lcode: np.ndarray, rcode: np.ndarray):
        """Every (left, right) match, by left row, then right row."""
        order = np.argsort(rcode, kind="stable")
        sorted_codes = rcode[order]
        lo = np.searchsorted(sorted_codes, lcode, side="left")
        hi = np.searchsorted(sorted_codes, lcode, side="right")
        counts = np.where(lcode >= 0, hi - lo, 0)
        li = np.repeat(np.arange(len(lcode), dtype=np.int64), counts)
        starts = np.repeat(lo - np.concatenate([[0], np.cumsum(counts)[:-1]]),
                           counts)
        ri = order[np.arange(len(li), dtype=np.int64) + starts] \
            if len(li) else np.zeros(0, dtype=np.int64)
        return li, ri

    def partitions(self, ctx):
        lparts = self.children[0].partitions(ctx)
        rparts = self.children[1].partitions(ctx)
        if len(lparts) != len(rparts):
            raise ValueError(f"join partition mismatch {len(lparts)} vs "
                             f"{len(rparts)}")
        lsch = self.children[0].output_schema
        rsch = self.children[1].output_schema

        def gen(lp, rp):
            lbs, rbs = list(lp), list(rp)
            with host_timer(ctx, self):
                out = self._join(_concat(lbs, lsch), _concat(rbs, rsch))
            if out is not None:
                yield out

        return [gen(lp, rp) for lp, rp in zip(lparts, rparts)]

    def _join(self, lb: HostBatch, rb: HostBatch) -> Optional[HostBatch]:
        lcode, rcode = self._codes(lb, rb)
        li, ri = self._pairs(lcode, rcode)
        if self.condition is not None and len(li):
            ok = _pair_condition(self.condition, lb, rb, li, ri)
            li, ri = li[ok], ri[ok]
        l_matched = np.zeros(lb.num_rows, dtype=np.bool_)
        l_matched[li] = True
        if self.how == "left_semi":
            li = np.flatnonzero(l_matched)
        elif self.how == "left_anti":
            li = np.flatnonzero(~l_matched)
        else:
            if self.how in ("left", "full"):
                miss = np.flatnonzero(~l_matched)
                li = np.concatenate([li, miss])
                ri = np.concatenate([ri, np.full(len(miss), -1)])
            if self.how in ("right", "full"):
                r_matched = np.zeros(rb.num_rows, dtype=np.bool_)
                r_matched[ri[ri >= 0]] = True
                miss = np.flatnonzero(~r_matched)
                li = np.concatenate([li, np.full(len(miss), -1)])
                ri = np.concatenate([ri, miss])
        if not len(li):
            return None
        return _join_output(self.output_schema, self.how, lb, rb,
                            li.astype(np.int64), ri.astype(np.int64))


class CpuNestedLoopJoinExec(CpuExec):
    """Cross or conditioned join of every left row with every right row;
    the right side is materialized once.  A right or full join makes one
    pass over all left partitions; the other types keep the left side's
    partitions."""

    def __init__(self, left: PhysicalOp, right: PhysicalOp, how: str,
                 condition: Optional[Expression], schema: T.Schema):
        super().__init__([left, right], schema)
        self.how = how
        self.condition = condition

    def describe(self):
        return f"CpuNestedLoopJoin({self.how})"

    def _matches(self, lb: HostBatch, rb: HostBatch):
        """Every (left, right) pair the condition holds for, by left row,
        then right row, in steps of a bounded number of pairs."""
        nl, nr = lb.num_rows, rb.num_rows
        step = max(1, _NLJ_PAIRS_PER_STEP // max(nr, 1))
        lis, ris = [], []
        for a in range(0, nl, step):
            b = min(nl, a + step)
            li = np.repeat(np.arange(a, b, dtype=np.int64), nr)
            ri = np.tile(np.arange(nr, dtype=np.int64), b - a)
            if self.condition is not None and len(li):
                ok = _pair_condition(self.condition, lb, rb, li, ri)
                li, ri = li[ok], ri[ok]
            lis.append(li)
            ris.append(ri)
        if not lis:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(lis), np.concatenate(ris)

    def _rows_of(self, lb: HostBatch, rb: HostBatch, pad_left: bool):
        """(li, ri, right rows matched): a left row's matches in its
        place, or, where it has none and ``pad_left``, the row NULL-padded
        there; semi and anti joins keep left rows."""
        li, ri = self._matches(lb, rb)
        matched = np.zeros(lb.num_rows, dtype=np.bool_)
        matched[li] = True
        r_matched = np.zeros(rb.num_rows, dtype=np.bool_)
        r_matched[ri] = True
        if self.how == "left_semi":
            return np.flatnonzero(matched), None, r_matched
        if self.how == "left_anti":
            return np.flatnonzero(~matched), None, r_matched
        if pad_left:
            miss = np.flatnonzero(~matched)
            li = np.concatenate([li, miss])
            ri = np.concatenate([ri, np.full(len(miss), -1)])
            order = np.argsort(li, kind="stable")
            li, ri = li[order], ri[order]
        return li, ri, r_matched

    def partitions(self, ctx):
        rsch = self.children[1].output_schema
        lsch = self.children[0].output_schema
        rb = _concat([hb for p in self.children[1].partitions(ctx)
                      for hb in p], rsch)
        lparts = self.children[0].partitions(ctx)

        if self.how in ("right", "full"):
            def gen_all():
                lbs = [hb for p in lparts for hb in p]
                with host_timer(ctx, self):
                    lb = _concat(lbs, lsch)
                    li, ri, r_matched = self._rows_of(lb, rb,
                                                      self.how == "full")
                    miss = np.flatnonzero(~r_matched)
                    li = np.concatenate([li, np.full(len(miss), -1)])
                    ri = np.concatenate([ri, miss])
                    out = _join_output(
                        self.output_schema, self.how, lb, rb,
                        li.astype(np.int64), ri.astype(np.int64)) \
                        if len(li) else None
                if out is not None:
                    yield out

            return [gen_all()]

        def gen(lp):
            lbs = list(lp)
            with host_timer(ctx, self):
                lb = _concat(lbs, lsch)
                li, ri, _ = self._rows_of(lb, rb, self.how == "left")
                out = _join_output(self.output_schema, self.how, lb, rb,
                                   li.astype(np.int64),
                                   None if ri is None else
                                   ri.astype(np.int64)) if len(li) \
                    else None
            if out is not None:
                yield out

        return [gen(p) for p in lparts]
