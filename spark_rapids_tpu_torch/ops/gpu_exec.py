"""Device operators (port of ``spark_rapids_tpu/ops/tpu_exec.py``: range,
project, expand, filter, sort, hash aggregate, generate (explode), sample,
cached scan, union, local limit, the coalescing shuffle reader, the
shuffled and broadcast hash joins, and the nested-loop join; the window
exec is ``ops/window.py``).  Over split exchanges the merge aggregate,
the reader and the shuffled join act on the adaptive layer's plans
(``plan/adaptive.py``).

Each exec runs its per-batch work eagerly as torch ops on ``ctx.device``.
String columns ride every operator as offsets + bytes; string group keys
take the sort-based groupby (the slot aggregate needs integral keys).
Host syncs happen only where the JAX package takes them: to size an output
(:func:`shrink_to_fit`, :func:`_concat_all`, the host-driven join), to read
the slot aggregate's fallback flags, each as ONE ``.tolist()`` for all
batches, and once per fused join for its overflow flag.

Joins under a one-device mesh (``ctx.mesh_spmd_active()``) run fused: the
JAX package lowers them into its ``shard_map`` stage program; the port,
which runs eagerly and has no stage fusion, runs the same static-capacity
join (``kernels/join.py:hash_join_static``, the joinProbe kernel) per join
and reads its overflow flag once.  On overflow it discards the output,
reruns the join host-driven from the same input batches, and counts
``joinOverflowFallback``.  A join with a residual condition never runs
fused: the condition sizes its gathers on the host.  The JAX package
keeps a stage that holds a single-partition exchange (a LIMIT) out of mesh
fusion as a whole; the port decides join by join, with the same rows
either way.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import (
    ColumnBatch, DeviceColumn, device_scalar, empty_device_batch,
    fixed_row_bytes, host_sizes, round_up_capacity, varlen_byte_scales,
)
from spark_rapids_tpu_torch.config import (
    HASH_AGG_MXU_ENABLED, HASH_AGG_MXU_SLOTS, MESH_SPMD_JOIN_GROWTH,
    NLJ_PAIR_CAPACITY,
)
from spark_rapids_tpu_torch.exprs.aggregates import AggregateExpression
from spark_rapids_tpu_torch.exprs.base import (
    DevVal, Expression, GpuEvalCtx, SortOrder, bind_references,
)
from spark_rapids_tpu_torch.exprs.misc import is_nondeterministic
from spark_rapids_tpu_torch.kernels import cuda_tier
from spark_rapids_tpu_torch.kernels.groupby import groupby_aggregate
from spark_rapids_tpu_torch.kernels.hashagg import (
    hash_agg_capable, hash_group_aggregate,
)
from spark_rapids_tpu_torch.kernels.join import (
    hash_join, hash_join_static, nested_loop_join, nested_loop_join_streamed,
)
from spark_rapids_tpu_torch.mem.catalog import device_batch_bytes
from spark_rapids_tpu_torch.kernels.layout import (
    compact, concat_kway, gather_rows, row_slices, take_head,
)
from spark_rapids_tpu_torch.kernels.sort import sort_batch
from spark_rapids_tpu_torch.plan import adaptive
from spark_rapids_tpu_torch.plan.physical import (
    GpuExec, PhysicalOp, prefetch_spillables,
)


def shrink_to_fit(batch: ColumnBatch, sizes: Optional[tuple] = None
                  ) -> ColumnBatch:
    """Re-bucket a sparse batch down to its live-row count, so downstream
    kernels stop paying for padding.  ``sizes`` is a pre-fetched
    ``(num_rows, [string byte totals])`` pair from :func:`host_sizes`, so
    callers shrinking many batches pay one sync, not one per batch."""
    if sizes is None:
        sizes = host_sizes([batch])[0]
    n, str_totals = sizes
    cap = round_up_capacity(max(n, 1))
    if batch.capacity <= cap * 2:
        return batch
    byte_caps = [round_up_capacity(max(t, 16), minimum=16)
                 for t in str_totals]
    idx = torch.arange(cap, dtype=torch.int64, device=batch.device)
    return gather_rows(batch, idx, batch.num_rows, out_capacity=cap,
                       out_byte_caps=byte_caps or None)


def _concat_all(batches: List[ColumnBatch], schema: T.Schema,
                sizes: Optional[List[tuple]] = None
                ) -> Optional[ColumnBatch]:
    """Concatenate a partition's batches into one, sized by the live totals
    fetched in ONE sync for all batches; the k-way concat then writes
    every input once into a single output allocation."""
    if not batches:
        return None
    if len(batches) == 1:
        return batches[0]
    if sizes is None:
        sizes = host_sizes(batches)
    cap = round_up_capacity(max(sum(n for n, _ in sizes), 1))
    n_str = sum(1 for f in schema.fields if f.dtype.is_string)
    byte_caps = [round_up_capacity(max(sum(s[1][j] for s in sizes), 16),
                                   minimum=16) for j in range(n_str)]
    return concat_kway(batches, cap, out_byte_caps=byte_caps or None)


def _reserve_for(ctx, batches: List[ColumnBatch], factor: int = 2) -> None:
    """Budget headroom before a large concatenation: the spill catalog
    spills lower-priority handles so the input and the output fit (the
    JAX package's ``_reserve_for``).  Sizes from the buffers' shapes, no
    sync."""
    if batches:
        ctx.catalog.reserve(factor * sum(device_batch_bytes(b)
                                         for b in batches))


def concat_static(batches: List[ColumnBatch], schema: T.Schema
                  ) -> ColumnBatch:
    """Concatenation with no host sync (port of
    ``plan/pipeline.py:concat_static``): the output capacity is the sum of
    the input capacities, each string column's byte capacity the sum of
    the input byte capacities."""
    if len(batches) == 1:
        return batches[0]
    cap = round_up_capacity(sum(b.capacity for b in batches))
    byte_caps = [round_up_capacity(sum(int(b.columns[i].data.shape[0])
                                       for b in batches), minimum=16)
                 for i, f in enumerate(schema.fields) if f.dtype.is_string]
    return concat_kway(batches, cap, out_byte_caps=byte_caps or None)


def _coalesce_groups(ctx, op_id: str, child: PhysicalOp, lazy_parts):
    """The adaptive grouping of a shuffle's output partitions
    (``plan/adaptive.py``): (groups of partitions, each group's skew
    flag), from the sizes the split recorded when it did (nothing is
    fetched), else from one sync of the batches' row counts (grouped to
    the row target, no skew marks); None when coalescing is off or there
    is one partition."""
    if not adaptive.coalesce_enabled(ctx) or len(lazy_parts) <= 1:
        return None
    sizes, unit = adaptive.part_stats(child, len(lazy_parts))
    if sizes is not None:
        return adaptive.plan_groups(ctx, op_id, lazy_parts, sizes, unit)
    parts = [list(p) for p in lazy_parts]
    flat = [b for p in parts for b in p]
    rows = {id(b): s[0] for b, s in zip(flat, host_sizes(flat))}
    sizes = [sum(rows[id(b)] for b in p) for p in parts]
    groups = adaptive.group_by_target(parts, sizes, adaptive.target_rows(ctx))
    return groups, [False] * len(groups)


class GpuCoalescedShuffleReaderExec(GpuExec):
    """Post-shuffle partition coalescing as a plan operator (port of
    ``TpuCoalescedShuffleReaderExec``, GpuCustomShuffleReaderExec's
    role): adjacent small partitions of the exchange below are chained
    into one until each group reaches the adaptive target, a skewed one
    left alone.  The planner puts it above the exchanges under a window
    and a global sort.  ``coalescedTo`` counts the groups."""

    def __init__(self, child: PhysicalOp):
        super().__init__([child], child.output_schema)

    def describe(self):
        return "GpuCoalescedShuffleReader"

    def partitions(self, ctx):
        child = self.children[0]
        lazy_parts = child.partitions(ctx)
        planned = _coalesce_groups(ctx, self.op_id, child, lazy_parts)
        if planned is None:
            return lazy_parts
        groups = planned[0]
        ctx.metric(self.op_id, "coalescedTo").add(len(groups))
        return [itertools.chain(*g) for g in groups]


class GpuRangeExec(GpuExec):
    """``session.range`` on the device: ids made by one ``arange`` a
    batch of at most 2^20 rows, no host copy."""

    _MAX_BATCH = 1 << 20

    def __init__(self, start, end, step, num_partitions, schema: T.Schema):
        super().__init__([], schema)
        self.start, self.end, self.step = start, end, step
        self._n = max(1, num_partitions)

    def describe(self):
        return f"GpuRange({self.start}, {self.end}, {self.step})"

    def partitions(self, ctx):
        from spark_rapids_tpu_torch.batch import DeviceColumn
        total = max(0, -(-(self.end - self.start) // self.step))
        per = -(-total // self._n)

        def gen(p):
            lo = self.start + p * per * self.step
            count = max(0, min(per, total - p * per))
            done = 0
            while done < count:
                n = min(self._MAX_BATCH, count - done)
                cap = round_up_capacity(n)
                idx = torch.arange(cap, dtype=torch.int64, device=ctx.device)
                data = (lo + done * self.step) + idx * self.step
                col = DeviceColumn(T.LONG, data, idx < n)
                yield ColumnBatch(self.output_schema, [col],
                                  device_scalar(n, ctx.device), cap)
                done += n

        return [gen(p) for p in range(self._n)]


class GpuUnionExec(GpuExec):
    """UNION ALL: every child's partitions in turn, renamed to the
    output schema."""

    def __init__(self, children: List[PhysicalOp], schema: T.Schema):
        super().__init__(children, schema)

    def partitions(self, ctx):
        return [self._rename(p) for c in self.children
                for p in c.partitions(ctx)]

    def _rename(self, part):
        for b in part:
            yield ColumnBatch(self.output_schema, b.columns, b.num_rows,
                              b.capacity)


class GpuExpandExec(GpuExec):
    """Grouping-sets expansion: every input batch once per projection list
    (the JAX package's ``TpuExpandExec``), each copy at the batch's
    capacity and live-row count."""

    def __init__(self, projections: List[List[Expression]],
                 child: PhysicalOp, schema: T.Schema):
        super().__init__([child], schema)
        self.projections = [[bind_references(e, child.output_schema)
                             for e in proj] for proj in projections]

    def describe(self):
        return f"GpuExpand({len(self.projections)} projections)"

    def partitions(self, ctx):
        def gen(part):
            for batch in part:
                ectx = GpuEvalCtx(batch)
                for proj in self.projections:
                    yield ColumnBatch(
                        self.output_schema,
                        [e.gpu_eval(ectx).to_column() for e in proj],
                        batch.num_rows, batch.capacity)

        return [gen(p) for p in self.children[0].partitions(ctx)]


def _with_row_ids(run, parts):
    """``run(batch, partition_index, base_row_id)`` over every batch of
    ``parts``: the partition's ordinal, and its rows before the batch as
    a running 0-d int64 device sum (None for the first batch)."""
    def gen(pi, part):
        base = None
        for b in part:
            yield run(b, pi, base)
            n = b.num_rows.to(torch.int64)
            base = n if base is None else base + n

    return [gen(pi, p) for pi, p in enumerate(parts)]


class GpuProjectExec(GpuExec):
    def __init__(self, exprs: List[Expression], child: PhysicalOp,
                 schema: T.Schema):
        super().__init__([child], schema)
        self.exprs = [bind_references(e, child.output_schema) for e in exprs]
        self._row_ids = any(is_nondeterministic(e) for e in self.exprs)

    def describe(self):
        return f"GpuProject({', '.join(f.name for f in self.output_schema)})"

    def _run(self, batch: ColumnBatch, partition_index: int = 0,
             base_row_id=None) -> ColumnBatch:
        ctx = GpuEvalCtx(batch, partition_index, base_row_id)
        cols = [e.gpu_eval(ctx).to_column() for e in self.exprs]
        return ColumnBatch(self.output_schema, cols, batch.num_rows,
                           batch.capacity)

    def partitions(self, ctx):
        parts = self.children[0].partitions(ctx)
        if self._row_ids:
            return _with_row_ids(self._run, parts)
        return [map(self._run, p) for p in parts]


class GpuFilterExec(GpuExec):
    def __init__(self, condition: Expression, child: PhysicalOp):
        super().__init__([child], child.output_schema)
        self.condition = bind_references(condition, child.output_schema)
        self._row_ids = is_nondeterministic(self.condition)

    def describe(self):
        return f"GpuFilter({self.condition!r})"

    def _run(self, batch: ColumnBatch, partition_index: int = 0,
             base_row_id=None) -> ColumnBatch:
        v = self.condition.gpu_eval(GpuEvalCtx(batch, partition_index,
                                               base_row_id))
        return compact(batch, v.validity & v.data.to(torch.bool))

    def partitions(self, ctx):
        parts = self.children[0].partitions(ctx)
        if self._row_ids:
            return _with_row_ids(self._run, parts)
        return [map(self._run, p) for p in parts]


class GpuSortExec(GpuExec):
    """Whole-partition sort: concatenates the partition first (the
    RequireSingleBatch goal of a global sort)."""

    def __init__(self, orders: List[SortOrder], child: PhysicalOp):
        super().__init__([child], child.output_schema)
        self.orders = orders
        self.key_exprs = [bind_references(o.child, child.output_schema)
                          for o in orders]

    def describe(self):
        return f"GpuSort({len(self.orders)} keys)"

    def partitions(self, ctx):
        def gen(part):
            batches = list(part)
            _reserve_for(ctx, batches)
            merged = _concat_all(batches, self.output_schema)
            del batches
            if merged is None:
                return
            ectx = GpuEvalCtx(merged)
            vals = [e.gpu_eval(ectx) for e in self.key_exprs]
            yield sort_batch(merged, vals,
                             [o.ascending for o in self.orders],
                             [o.nulls_first for o in self.orders])

        return [gen(p) for p in self.children[0].partitions(ctx)]


_KEYLESS_SCHEMA = T.Schema([T.Field("__k", T.INT, False)])


def input_index_base(part: int, batch: int) -> int:
    """The input index of row 0 of a partition's batch: the partition
    ordinal above bit 47 and the batch ordinal above bit 31, so indices
    order rows by partition, then batch, then position."""
    if not (0 <= part < 1 << 16 and 0 <= batch < 1 << 16):
        raise ValueError(f"row index of partition {part}, batch {batch} "
                         "past 16 bits each")
    return (part << 47) | (batch << 31)


def _buffer_schema(key_names: List[str], keys: List[Expression],
                   aggs: List[AggregateExpression]) -> T.Schema:
    fields = [T.Field(n, e.dtype, e.nullable)
              for n, e in zip(key_names, keys)]
    for i, a in enumerate(aggs):
        for j, spec in enumerate(a.fn.buffers()):
            fields.append(T.Field(f"__buf_{i}_{j}", spec.dtype, True))
    return T.Schema(fields)


class GpuHashAggregateExec(GpuExec):
    """Two-mode groupby aggregation (the Partial/Final split).

    mode="update": each input batch -> one partial batch (group keys +
    agg buffers) through the slot aggregate; if any batch raises its
    fallback flag, every batch re-runs the exact sort path and the slot
    path stays off for this exec.  Partials are right-sized in one sync
    and handed on one per input batch, as the JAX package's fused stage
    does, so the merge concatenates every partial once.

    mode="merge": concatenate the partition's partials (the gatherScatter
    pack), merge them with the sort-based groupby, finalize.

    first/last pick by each row's input index: its position in its batch
    plus :func:`input_index_base` of its partition and batch ordinals."""

    def __init__(self, mode: str, key_exprs: List[Expression],
                 key_names: List[str], aggs: List[AggregateExpression],
                 child: PhysicalOp, schema: T.Schema):
        if mode not in ("update", "merge"):
            raise ValueError(f"unknown aggregate mode {mode!r}")
        super().__init__([child], schema)
        self.mode = mode
        self.aggs = aggs
        if mode == "update":
            in_schema = child.output_schema
            self.key_exprs = [bind_references(e, in_schema)
                              for e in key_exprs]
            self.agg_children = [bind_references(a.fn.child, in_schema)
                                 for a in aggs]
        else:  # the merge reads keys and buffers by position
            self.key_exprs, self.agg_children = list(key_exprs), []
        # an aggregation without keys groups by a synthetic one-slot key
        self.keyless = not key_exprs
        self.key_schema = _KEYLESS_SCHEMA if self.keyless else T.Schema(
            [T.Field(n, e.dtype, e.nullable)
             for n, e in zip(key_names, key_exprs)])
        self.buffer_schemas = [[s.dtype for s in a.fn.buffers()]
                               for a in aggs]
        self._hash_capable = hash_agg_capable(
            mode, [f.dtype for f in self.key_schema], [a.fn for a in aggs])
        self._hash_disabled = False  # sticky off after a flagged batch

    def describe(self):
        return f"GpuHashAggregate({self.mode}, keys={len(self.key_exprs)})"

    def _key_vals(self, batch: ColumnBatch, ectx) -> List[DevVal]:
        """The update's group keys over a batch: the key expressions, or
        without keys one constant key, so every row falls into one group."""
        if not self.keyless:
            return [e.gpu_eval(ectx) for e in self.key_exprs]
        cap, dev = batch.capacity, batch.device
        return [DevVal(T.INT, torch.zeros(cap, dtype=torch.int32, device=dev),
                       torch.ones(cap, dtype=torch.bool, device=dev))]

    def _output(self, group_keys: ColumnBatch, cols: List, capacity: int
                ) -> ColumnBatch:
        """Group keys, then ``cols``; without keys exactly one row, even
        over no input (the buffers' identities: SQL's NULL sum, 0
        count)."""
        if self.keyless:
            return ColumnBatch(self.output_schema, cols,
                               device_scalar(1, group_keys.device), capacity)
        return ColumnBatch(self.output_schema,
                           list(group_keys.columns) + cols,
                           group_keys.num_rows, capacity)

    def _aggregate_batch(self, batch: ColumnBatch,
                         row_base: int = 0) -> ColumnBatch:
        """Sort path, both modes."""
        if self.mode == "update":
            ectx = GpuEvalCtx(batch)
            key_vals = self._key_vals(batch, ectx)
            agg_inputs = [e.gpu_eval(ectx) for e in self.agg_children]
        else:  # partial batches: keys, then every buffer, by position
            nk = len(self.key_exprs)
            key_vals = self._key_vals(batch, None) if self.keyless else \
                [DevVal.from_column(c) for c in batch.columns[:nk]]
            agg_inputs = [DevVal.from_column(c) for c in batch.columns[nk:]]
        group_keys, buffers = groupby_aggregate(
            batch, key_vals, agg_inputs, [a.fn for a in self.aggs],
            self.mode == "merge", self.key_schema, self.buffer_schemas,
            row_base)
        if self.mode == "update":
            cols = [b.to_column() for bufs in buffers for b in bufs]
        else:
            cols = [a.fn.finalize(bufs).to_column()
                    for a, bufs in zip(self.aggs, buffers)]
        return self._output(group_keys, cols, batch.capacity)

    def _aggregate_batch_hash(self, batch: ColumnBatch, table: int,
                              row_base: int):
        """(partial batch, fallback flag) via the slot aggregate.  Without
        keys every live row of a chunk of 16,384 rows lands on one slot of
        its own chunk, so the scatters do not all contend for one
        address."""
        ectx = GpuEvalCtx(batch)
        group_keys, buffers, num_groups, flag = hash_group_aggregate(
            batch, self._key_vals(batch, ectx),
            [e.gpu_eval(ectx) for e in self.agg_children],
            [a.fn for a in self.aggs], self.key_schema,
            table=table, row_base=row_base)
        cols = [b.to_column() for bufs in buffers for b in bufs]
        return self._output(group_keys, cols, group_keys.capacity), flag

    def _update_partials(self, ctx, batches: Sequence[ColumnBatch],
                         part: int) -> List[ColumnBatch]:
        sizes = None
        bases = [input_index_base(part, j) for j in range(len(batches))]
        if self._hash_capable and not self._hash_disabled and \
                HASH_AGG_MXU_ENABLED.get(ctx.conf):
            table = HASH_AGG_MXU_SLOTS.get(ctx.conf)
            pairs = [self._aggregate_batch_hash(b, table, base)
                     for b, base in zip(batches, bases)]
            # one sync for every flag and every partial's row count
            fetched = torch.stack(
                [f.to(torch.int64) for _, f in pairs] +
                [p.num_rows.to(torch.int64) for p, _ in pairs]).tolist()
            if not any(fetched[:len(pairs)]):
                partials = [p for p, _ in pairs]
                sizes = [(n, []) for n in fetched[len(pairs):]]
            else:
                self._hash_disabled = True
        if sizes is None:
            partials = [self._aggregate_batch(b, base)
                        for b, base in zip(batches, bases)]
            sizes = host_sizes(partials)
        return [shrink_to_fit(p, s) for p, s in zip(partials, sizes)]

    def partitions(self, ctx):
        if self.mode == "update":
            def gen(p, part):
                batches = list(part)
                if batches:
                    yield from self._update_partials(ctx, batches, p)

            return [gen(p, part) for p, part in
                    enumerate(self.children[0].partitions(ctx))]
        child = self.children[0]

        def merge(part):
            batches = list(part)
            _reserve_for(ctx, batches)
            merged = _concat_all(batches, child.output_schema)
            del batches
            if merged is None and self.keyless:
                # no input at all: still the one row of SQL defaults
                merged = empty_device_batch(child.output_schema, ctx.device)
            if merged is not None:
                yield self._aggregate_batch(merged)

        parts = child.partitions(ctx)
        planned = _coalesce_groups(ctx, self.op_id, child, parts)
        if planned is not None:  # small shuffle partitions merged as one
            parts = [itertools.chain(*g) for g in planned[0]]
        return [merge(p) for p in parts]


class GpuSampleExec(GpuExec):
    """Bernoulli sample with the host twin's stream: partition p draws
    ``rng.rand(rows) < fraction`` a batch from
    ``np.random.RandomState(seed + p)`` (one row-count read a batch), and
    the device compacts the kept rows."""

    def __init__(self, fraction: float, seed: int, child: PhysicalOp):
        super().__init__([child], child.output_schema)
        self.fraction = fraction
        self.seed = seed

    def describe(self):
        return f"GpuSample({self.fraction}, seed={self.seed})"

    def partitions(self, ctx):
        def gen(pi, part):
            rng = np.random.RandomState(self.seed + pi)
            for db in part:
                n = int(db.num_rows)
                keep = torch.zeros(db.capacity, dtype=torch.bool,
                                   device=db.device)
                keep[:n] = torch.from_numpy(
                    rng.rand(n) < self.fraction).to(db.device)
                yield compact(db, keep)

        return [gen(pi, p) for pi, p in
                enumerate(self.children[0].partitions(ctx))]


#: rows of one explode output batch, at most (unless one input row alone
#: has more elements): a kept string column is gathered byte by byte, with
#: ~40 bytes of index temporaries per output byte, so the input is cut
#: into row slices whose outputs stay this small
GENERATE_OUT_ROWS = 1 << 22


class GpuGenerateExec(GpuExec):
    """explode / posexplode of a fixed-width array column (port of
    ``TpuGenerateExec``): the parent row of every element (one
    ``searchsorted`` over the array offsets) drives one gather of the kept
    columns (``layout.gather_rows``); the element buffer is the new
    column.  A kept string column grows (its rows repeat), so its byte
    capacity, and the output capacity, are sized on the host from one
    read of the totals.  An input batch with more than
    :data:`GENERATE_OUT_ROWS` elements is exploded in row slices
    (``layout.row_slices``).  The JAX package sizes its output by the
    static element capacity; the rows are the same."""

    def __init__(self, column: str, alias: str, pos: bool,
                 child: PhysicalOp, schema: T.Schema):
        super().__init__([child], schema)
        self.column = column
        self.alias = alias
        self.pos = pos

    def describe(self):
        kind = "posexplode" if self.pos else "explode"
        return f"GpuGenerate({kind}({self.column}))"

    def _pieces(self, batch: ColumnBatch):
        arr = batch.column(self.column)
        n, total = torch.stack([batch.num_rows.to(torch.int64),
                                arr.offsets[batch.num_rows].to(
                                    torch.int64)]).tolist()
        if total <= GENERATE_OUT_ROWS:
            return [batch]
        return row_slices(batch, n, max(1, n * GENERATE_OUT_ROWS // total))

    def _explode(self, batch: ColumnBatch) -> ColumnBatch:
        ci = batch.schema.index_of(self.column)
        arr = batch.columns[ci]
        dev, cap = batch.device, batch.capacity
        live_in = torch.arange(cap, dtype=torch.int32, device=dev) < \
            batch.num_rows
        counts = torch.where(live_in, arr.offsets[1:] - arr.offsets[:-1], 0)
        kept = [i for i in range(len(batch.schema)) if i != ci]
        # one read: the element total and each kept string's byte total
        # (its int32 offsets must hold it: GENERATE_OUT_ROWS rows of a
        # 24-byte string are ~100 MB, far below 2^31)
        sizes = [counts.to(torch.int64).sum()]
        for i in kept:
            c = batch.columns[i]
            if c.is_varlen:
                lens = (c.offsets[1:] - c.offsets[:-1]).to(torch.int64)
                sizes.append((lens * counts).sum())
        total, *byte_totals = torch.stack(sizes).tolist()
        if max(byte_totals, default=0) > 2 ** 31 - 1:
            raise ValueError(f"explode of {total} rows: a kept string "
                             "column passes 2^31 - 1 bytes")
        out_cap = round_up_capacity(max(total, 1))
        n_out = device_scalar(total, dev)
        live = torch.arange(out_cap, dtype=torch.int32, device=dev) < n_out
        parent = cuda_tier.rows_of_positions(arr.offsets, out_cap).clamp(
            0, cap - 1).to(torch.int64)
        kept_batch = ColumnBatch(
            T.Schema([batch.schema.fields[i] for i in kept]),
            [batch.columns[i] for i in kept], batch.num_rows, cap)
        g = gather_rows(kept_batch, parent, n_out, out_capacity=out_cap,
                        out_byte_caps=[round_up_capacity(max(t, 16), 16)
                                       for t in byte_totals] or None)
        cols = list(g.columns)
        if self.pos:
            pos = torch.arange(out_cap, dtype=torch.int32, device=dev) - \
                arr.offsets[parent]
            cols.append(DeviceColumn(T.INT, torch.where(live, pos, 0),
                                     live))
        m = min(out_cap, int(arr.data.shape[0]))
        elem = torch.zeros(out_cap, dtype=arr.data.dtype, device=dev)
        elem[:m] = arr.data[:m]
        cols.append(DeviceColumn(self.output_schema.fields[-1].dtype,
                                 torch.where(live, elem, 0),
                                 live & arr.validity[parent]))
        return ColumnBatch(self.output_schema, cols, n_out, out_cap)

    def partitions(self, ctx):
        def gen(part):
            for batch in part:
                for piece in self._pieces(batch):
                    yield self._explode(piece)

        return [gen(p) for p in self.children[0].partitions(ctx)]


class GpuCachedScanExec(GpuExec):
    """Reads (and on first run fills) a CacheHolder of spill-catalog
    handles: each batch is right-sized once and registered at
    ``PRIORITY_INPUT`` as it comes, so the cache can be larger than the
    device budget; a read drives the handles with one unspill in flight
    ahead of the consumer (``prefetch_spillables``)."""

    def __init__(self, holder, child: Optional[PhysicalOp],
                 schema: T.Schema):
        super().__init__([child] if child is not None else [], schema)
        self.holder = holder

    def describe(self):
        return "GpuCachedScan"

    def num_partitions(self, ctx):
        if self.holder.is_materialized:
            return len(self.holder.partitions)
        return self.children[0].num_partitions(ctx)

    def _materialize(self, ctx):
        catalog = ctx.catalog
        parts = []
        try:
            for p in self.children[0].partitions(ctx):
                handles = []
                parts.append(handles)
                for b in p:
                    handles.append(catalog.register(shrink_to_fit(b)))
        except BaseException:
            for h in (h for hs in parts for h in hs):
                h.close()
            raise
        self.holder.partitions = parts

    def partitions(self, ctx):
        if not self.holder.is_materialized:
            self._materialize(ctx)
        for part in self.holder.partitions:
            for h in part:
                if h.device != ctx.device:
                    raise ValueError(f"cached batches live on {h.device}, "
                                     f"the query runs on {ctx.device}")
        return [prefetch_spillables(p) for p in self.holder.partitions]


class GpuLocalLimitExec(GpuExec):
    """The first ``n`` rows of each partition: the live-row count is
    clamped (``take_head``), one host read per batch to know how many are
    left, and the partition stops once ``n`` rows went out."""

    def __init__(self, n: int, child: PhysicalOp):
        super().__init__([child], child.output_schema)
        self.n = n

    def describe(self):
        return f"GpuLocalLimit({self.n})"

    def partitions(self, ctx):
        def gen(part):
            left = self.n
            for batch in part:
                if left <= 0:
                    break
                batch = take_head(batch, left)
                got = int(batch.num_rows)
                left -= got
                if got:
                    yield batch

        return [gen(p) for p in self.children[0].partitions(ctx)]


def _eval_join_keys(exprs: Sequence[Expression], batch: ColumnBatch
                    ) -> List[DevVal]:
    """The equi-join key expressions evaluated against one side's batch
    (dictionary-encoded keys are not ported: strings arrive materialized)."""
    ectx = GpuEvalCtx(batch)
    return [e.gpu_eval(ectx) for e in exprs]


def _walk(op: PhysicalOp):
    yield op
    for c in op.children:
        yield from _walk(c)


class _HashJoinBase(GpuExec):
    """Shared by both hash joins: the host-driven join of one (left,
    right) pair, with the residual condition when there is one, and the
    fused static join with its overflow rerun.  The condition's column
    references stay by name: the join evaluates it over a batch of only
    the columns it reads."""

    def __init__(self, children, left_keys, right_keys, how: str,
                 condition: Optional[Expression], schema: T.Schema,
                 left_schema: T.Schema, right_schema: T.Schema):
        super().__init__(children, schema)
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.how = how
        self.condition = condition
        self.left_schema = left_schema
        self.right_schema = right_schema

    def _join_pair(self, lb: Optional[ColumnBatch],
                   rb: Optional[ColumnBatch], device
                   ) -> Optional[ColumnBatch]:
        """Host-driven join of one pair; None for a missing side where the
        join type can produce no rows from the other."""
        if lb is None and self.how in ("inner", "left", "left_semi",
                                       "left_anti"):
            return None
        if rb is None and self.how in ("inner", "right", "left_semi"):
            return None
        if lb is None:
            lb = empty_device_batch(self.left_schema, device)
        if rb is None:
            rb = empty_device_batch(self.right_schema, device)
        return hash_join(lb, _eval_join_keys(self.left_keys, lb), rb,
                         _eval_join_keys(self.right_keys, rb), self.how,
                         self.output_schema, condition=self.condition)

    def _join_fused(self, ctx, lbs: List[ColumnBatch],
                    rbs: List[ColumnBatch], rerun) -> List[ColumnBatch]:
        """The static join over both sides concatenated without a sync;
        the overflow flag is read once, and on overflow the output is
        discarded and ``rerun()`` gives the host-driven batches."""
        lb = concat_static(lbs, self.left_schema)
        rb = concat_static(rbs, self.right_schema)
        out, ovf = hash_join_static(
            lb, _eval_join_keys(self.left_keys, lb), rb,
            _eval_join_keys(self.right_keys, rb), self.how,
            self.output_schema, growth=MESH_SPMD_JOIN_GROWTH.get(ctx.conf))
        ctx.add_metric("meshJoinsFused")
        if not bool(ovf):
            return [out]
        ctx.add_metric("joinOverflowFallback")
        return list(rerun())


class GpuShuffledHashJoinExec(_HashJoinBase):
    """Equi-join of co-partitioned (left, right) pairs.  Host-driven by
    default; fused when a mesh is active and both children are mesh
    exchanges and the join has no residual condition.

    Over split exchanges the adaptive layer (``plan/adaptive.py``) acts
    here as in the JAX package: first the broadcast switch (the first
    legal build side whose exchange came in under
    ``spark.sql.autoBroadcastJoinThreshold`` actual bytes is broadcast to
    every partition of the other side, whose split is skipped when it has
    not run: ``replannedBroadcast``); else the pairs are grouped by their
    combined size, a skewed pair alone (never for a full join), and a
    skewed pair's stream side is joined piece by piece, a piece above the
    byte target in row slices (``skewSplitChunks``)."""

    _FUSABLE_HOWS = ("inner", "left", "right", "full", "left_semi",
                     "left_anti")

    def __init__(self, left: PhysicalOp, right: PhysicalOp,
                 left_keys: List[Expression], right_keys: List[Expression],
                 how: str, condition: Optional[Expression],
                 schema: T.Schema):
        super().__init__([left, right], left_keys, right_keys, how,
                         condition, schema, left.output_schema,
                         right.output_schema)

    def describe(self):
        return f"GpuShuffledHashJoin({self.how})"

    def _fusable(self, ctx) -> bool:
        from spark_rapids_tpu_torch.parallel.exchange import (
            GpuShuffleExchangeExec,
        )
        return ctx.mesh_spmd_active() and self.condition is None and \
            self.how in self._FUSABLE_HOWS and \
            all(isinstance(c, GpuShuffleExchangeExec) for c in self.children)

    def partitions(self, ctx):
        lchild, rchild = self.children
        if self.num_partitions(ctx) > 1:
            switched = self._try_broadcast_switch(ctx)
            if switched is not None:
                return switched
        lparts = lchild.partitions(ctx)
        rparts = rchild.partitions(ctx)
        if len(lparts) != len(rparts):
            raise ValueError(f"join sides have {len(lparts)} and "
                             f"{len(rparts)} partitions")
        skewed = [False] * len(lparts)
        if adaptive.coalesce_enabled(ctx) and len(lparts) > 1:
            lparts, rparts, skewed = self._group_pairs(ctx, lparts, rparts)
        fused = self._fusable(ctx)

        def host(lbs, rbs):
            _reserve_for(ctx, lbs + rbs)
            out = self._join_pair(_concat_all(lbs, self.left_schema),
                                  _concat_all(rbs, self.right_schema),
                                  ctx.device)
            return [] if out is None else [out]

        def gen(lp, rp, skew):
            lbs, rbs = list(lp), list(rp)
            if skew and self.how != "full":
                yield from self._join_skewed(ctx, lbs, rbs)
            elif fused and lbs and rbs:
                yield from self._join_fused(ctx, lbs, rbs,
                                            lambda: host(lbs, rbs))
            else:
                yield from host(lbs, rbs)

        return [gen(lp, rp, sk) for lp, rp, sk in zip(lparts, rparts, skewed)]

    def _group_pairs(self, ctx, lparts, rparts):
        """Co-partitioned pairs grouped by combined size: from the sizes
        both splits recorded, else from one sync of every batch's rows
        (then no skew marks count as free stats)."""
        lchild, rchild = self.children
        lsz, lunit = adaptive.part_stats(lchild, len(lparts))
        rsz, runit = adaptive.part_stats(rchild, len(rparts))
        if lsz is not None and rsz is not None and lunit == runit:
            sizes = [a + b for a, b in zip(lsz, rsz)]
            unit, record = lunit, True
        else:
            lparts = [list(p) for p in lparts]
            rparts = [list(p) for p in rparts]
            flat = [b for p in lparts + rparts for b in p]
            rows = {id(b): s[0] for b, s in zip(flat, host_sizes(flat))}
            sizes = [sum(rows[id(b)] for b in lp) +
                     sum(rows[id(b)] for b in rp)
                     for lp, rp in zip(lparts, rparts)]
            unit, record = "rows", False
        groups, skewed = adaptive.plan_groups(
            ctx, self.op_id, list(zip(lparts, rparts)), sizes, unit,
            record=record, detect_skew=self.how != "full")
        return ([itertools.chain(*(lp for lp, _ in g)) for g in groups],
                [itertools.chain(*(rp for _, rp in g)) for g in groups],
                skewed)

    def _try_broadcast_switch(self, ctx):
        """The first legal build side whose exchange materialized under
        the broadcast threshold becomes a broadcast build; the other
        side's split is skipped when it has not run.  None keeps the
        shuffled shape."""
        from spark_rapids_tpu_torch.parallel.exchange import (
            GpuShuffleExchangeExec,
        )
        if not adaptive.replan_joins_enabled(ctx):
            return None
        thr = adaptive.broadcast_threshold(ctx)
        if thr < 0:
            return None
        lchild, rchild = self.children
        for side in adaptive.broadcast_build_sides(self.how):
            build = rchild if side == "right" else lchild
            probe = lchild if side == "right" else rchild
            bparts = build.partitions(ctx)
            bbytes = getattr(build, "_last_part_bytes", None)
            if bbytes is None or len(bbytes) != len(bparts) or \
                    sum(bbytes) > thr:
                continue
            adaptive.record_stats(ctx, self.op_id, bbytes, "bytes")
            if isinstance(probe, GpuShuffleExchangeExec) and \
                    not probe.has_materialized_split(ctx):
                sparts = probe.bypass_partitions(ctx)
            else:
                sparts = probe.partitions(ctx)
            return self._broadcast_partitions(ctx, side, bparts, sparts)
        return None

    def _broadcast_partitions(self, ctx, side, build_parts, stream_parts):
        """Join every stream partition against the build side,
        concatenated once per query and runtime generation and registered
        in the spill catalog (fetched again per stream partition)."""
        key = (self.op_id, side)
        held = ctx.held.get(key)
        if held is None or held[0] != ctx.generation:
            bbs = [b for p in build_parts for b in p]
            _reserve_for(ctx, bbs)
            bc = _concat_all(bbs, self.right_schema if side == "right"
                             else self.left_schema)
            del bbs
            bh = None
            if bc is not None:
                bh = ctx.catalog.register(bc)
                ctx.defer_close(bh)
                del bc
            held = ctx.held[key] = (ctx.generation, bh)
        bh = held[1]
        ctx.metric(self.op_id, "replannedBroadcast").add(1)
        stream_schema = self.left_schema if side == "right" \
            else self.right_schema

        def gen(part):
            sbs = list(part)
            if not sbs:
                return
            _reserve_for(ctx, sbs)
            sb = _concat_all(sbs, stream_schema)
            build = bh.get() if bh is not None else None
            pair = (sb, build) if side == "right" else (build, sb)
            out = self._join_pair(*pair, ctx.device)
            if out is not None:
                yield out

        return [gen(p) for p in stream_parts]

    def _join_skewed(self, ctx, lbs, rbs):
        """A skewed pair: the stream side (the left one, the right one for
        a right join) joined per piece the split made against the whole
        build side, a piece above the byte target in row slices, so one
        join's pair space stays bounded.  A stream row is in one slice, so
        the stream side's outer rows come out once.  One sync sizes every
        piece."""
        split_left = self.how != "right"
        stream = lbs if split_left else rbs
        build = rbs if split_left else lbs
        stream_schema = self.left_schema if split_left else self.right_schema
        build_b = _concat_all(build, self.right_schema if split_left
                              else self.left_schema)
        frb = fixed_row_bytes(stream_schema)
        scales = varlen_byte_scales(stream_schema)
        target = max(adaptive.target_bytes(ctx), 1)
        plan, chunks = [], 0
        for piece, (rows, totals) in zip(
                stream, host_sizes(stream) if stream else []):
            if rows == 0:
                continue
            pbytes = rows * frb + sum(t * sc for t, sc in zip(totals, scales))
            n_chunks = max(1, min(rows, -(-pbytes // target)))
            rows_per = -(-rows // n_chunks)
            plan.append((piece, rows, rows_per))
            chunks += -(-rows // rows_per)
        ctx.metric(self.op_id, "skewSplitChunks").add(chunks)

        def pair(sb):
            return (sb, build_b) if split_left else (build_b, sb)

        if not plan:
            out = self._join_pair(*pair(None), ctx.device)
            if out is not None:
                yield out
            return
        for piece, rows, rows_per in plan:
            for sb in row_slices(piece, rows, rows_per):
                out = self._join_pair(*pair(sb), ctx.device)
                if out is not None:
                    yield out


class GpuBroadcastHashJoinExec(_HashJoinBase):
    """Equi-join against a broadcast build side: the build side is
    concatenated once per query and every stream batch joins against it,
    with no exchange on either side.  ``broadcast_side`` is "right" (inner,
    left, semi, anti) or "left" (inner, right): the planner never
    broadcasts a side whose unmatched rows the join must emit.  Fused under
    an active mesh when the join has no residual condition, the build
    subtree holds no exchange and it shares no node with the stream
    subtree: then each stream partition is joined whole, with static
    sizing.  The host path's build side, concatenated once, is registered
    in the spill catalog and fetched again per stream batch, so a spilled
    build side frees device memory between batches."""

    _FUSABLE_HOWS = {"right": ("inner", "left", "left_semi", "left_anti"),
                     "left": ("inner", "right")}

    def __init__(self, stream: PhysicalOp, broadcast: PhysicalOp,
                 left_keys: List[Expression], right_keys: List[Expression],
                 how: str, broadcast_side: str,
                 condition: Optional[Expression], schema: T.Schema):
        if broadcast_side == "right":
            lsch, rsch = stream.output_schema, broadcast.output_schema
        else:
            lsch, rsch = broadcast.output_schema, stream.output_schema
        super().__init__([stream, broadcast], left_keys, right_keys, how,
                         condition, schema, lsch, rsch)
        self.broadcast_side = broadcast_side
        self._bc_cache = None  # (weakref(ctx), generation, build side)

    def describe(self):
        return (f"GpuBroadcastHashJoin({self.how}, "
                f"bc={self.broadcast_side})")

    def _build_side(self, ctx) -> dict:
        """The build side, materialized once per query and runtime
        generation: its batches, and (on first use by the host path)
        their concatenation's spill-catalog handle."""
        import weakref
        cached = self._bc_cache
        if cached is not None and cached[0]() is ctx and \
                cached[1] == ctx.generation:
            return cached[2]
        build = {"batches": [b for p in self.children[1].partitions(ctx)
                             for b in p]}
        self._bc_cache = (weakref.ref(ctx), ctx.generation, build)
        return build

    def _build_handle(self, ctx, build: dict, keep_batches: bool):
        """The build side's concatenation registered in the catalog once
        (closed when the query ends); the batches go unless the fused path
        still wants them."""
        if "handle" not in build:
            batches = build["batches"]
            _reserve_for(ctx, batches)
            bc = _concat_all(batches, self.children[1].output_schema)
            build["handle"] = None
            if bc is not None:
                build["handle"] = ctx.catalog.register(bc)
                ctx.defer_close(build["handle"])
            if not keep_batches:
                build["batches"] = []
        return build["handle"]

    def _fusable(self, ctx) -> bool:
        from spark_rapids_tpu_torch.parallel.exchange import (
            GpuShuffleExchangeExec,
        )
        if not ctx.mesh_spmd_active() or self.condition is not None or \
                self.how not in self._FUSABLE_HOWS[self.broadcast_side]:
            return False
        bc_nodes = list(_walk(self.children[1]))
        if any(isinstance(o, GpuShuffleExchangeExec) for o in bc_nodes):
            return False
        stream_ids = {id(o) for o in _walk(self.children[0])}
        return not stream_ids & {id(o) for o in bc_nodes}

    def _pair(self, stream, build):
        return (stream, build) if self.broadcast_side == "right" \
            else (build, stream)

    def partitions(self, ctx):
        build = self._build_side(ctx)
        bc_schema = self.children[1].output_schema
        fused = self._fusable(ctx)

        def build_batch():
            h = self._build_handle(ctx, build, keep_batches=fused)
            return h.get() if h is not None else \
                empty_device_batch(bc_schema, ctx.device)

        def host(sbs):
            outs = (self._join_pair(*self._pair(sb, build_batch()),
                                    ctx.device) for sb in sbs)
            return [o for o in outs if o is not None]

        def gen(part):
            sbs = list(part)
            if fused and sbs and build["batches"]:
                yield from self._join_fused(
                    ctx, *self._pair(sbs, build["batches"]),
                    lambda: host(sbs))
            else:
                yield from host(sbs)

        return [gen(p) for p in self.children[0].partitions(ctx)]


class GpuNestedLoopJoinExec(GpuExec):
    """All-pairs join with an optional condition, every join type (the
    planner's choice for a cross join and a join without equi-keys).  The
    right side is materialized once per query as one device batch; a left
    batch whose pair space ``n_l * n_r`` exceeds
    ``spark.rapids.sql.nestedLoopJoin.pairCapacity`` is joined in slices
    of ``pairCapacity // n_r`` rows (``nljChunks`` counts them).  Inner,
    left, semi and anti joins are exact per slice, since a left row's
    outcome needs only the whole right side; right and full joins gather
    the whole left side into one partition and stream its slices,
    accumulating which right rows matched.  Never fused.  The right side
    is registered in the spill catalog once and fetched again for each
    join, so it can leave the device between left batches."""

    def __init__(self, left: PhysicalOp, right: PhysicalOp, how: str,
                 condition: Optional[Expression], schema: T.Schema):
        super().__init__([left, right], schema)
        self.how = how
        self.condition = condition

    def describe(self):
        return f"GpuNestedLoopJoin({self.how})"

    def partitions(self, ctx):
        budget = max(NLJ_PAIR_CAPACITY.get(ctx.conf), 1)
        lsch = self.children[0].output_schema
        rsch = self.children[1].output_schema
        rbatches = [b for p in self.children[1].partitions(ctx) for b in p]
        _reserve_for(ctx, rbatches)
        rb = _concat_all(rbatches, rsch)
        del rbatches
        n_r = int(rb.num_rows) if rb is not None else 0
        rh = None
        if rb is not None:
            rh = ctx.catalog.register(rb)
            ctx.defer_close(rh)
            del rb

        def rb_local():
            return rh.get() if rh is not None else \
                empty_device_batch(rsch, ctx.device)

        lparts = self.children[0].partitions(ctx)
        rows_per = max(1, budget // max(n_r, 1))

        def slice_rows(n_l: int) -> int:
            """Count ``n_l`` left rows' slices; the rows a slice holds."""
            ctx.metric(self.op_id, "nljChunks").add(-(-n_l // rows_per))
            return rows_per

        def join(lb):
            return nested_loop_join(lb, rb_local(), self.how,
                                    self.condition, self.output_schema)

        if self.how in ("right", "full"):
            def gen_all():
                lbatches = [b for p in lparts for b in p]
                _reserve_for(ctx, lbatches)
                lb = _concat_all(lbatches, lsch) or \
                    empty_device_batch(lsch, ctx.device)
                del lbatches
                n_l = int(lb.num_rows)
                if n_l * max(n_r, 1) <= budget:
                    yield join(lb)
                    return
                yield from nested_loop_join_streamed(
                    row_slices(lb, n_l, slice_rows(n_l)),
                    empty_device_batch(lsch, ctx.device), rb_local(),
                    self.how, self.condition, self.output_schema)

            return [gen_all()]

        def gen(part):
            for lb in part:
                n_l = int(lb.num_rows)
                if n_l * max(n_r, 1) <= budget:
                    yield join(lb)
                    continue
                for chunk in row_slices(lb, n_l, slice_rows(n_l)):
                    yield join(chunk)

        return [gen(p) for p in lparts]
