"""Device operators (port of ``spark_rapids_tpu/ops/tpu_exec.py``: project,
filter, sort, hash aggregate, cached scan, local limit, and the shuffled
and broadcast hash joins).

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
``joinOverflowFallback``.  The JAX package keeps a stage that holds a
single-partition exchange (a LIMIT) out of mesh fusion as a whole; the port
decides join by join, with the same rows either way.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import (
    ColumnBatch, empty_device_batch, host_sizes, round_up_capacity,
)
from spark_rapids_tpu_torch.config import (
    HASH_AGG_MXU_ENABLED, HASH_AGG_MXU_SLOTS, MESH_SPMD_JOIN_GROWTH,
)
from spark_rapids_tpu_torch.exprs.aggregates import AggregateExpression
from spark_rapids_tpu_torch.exprs.base import (
    DevVal, Expression, GpuEvalCtx, SortOrder, bind_references,
)
from spark_rapids_tpu_torch.kernels.groupby import groupby_aggregate
from spark_rapids_tpu_torch.kernels.hashagg import (
    hash_agg_capable, hash_group_aggregate,
)
from spark_rapids_tpu_torch.kernels.join import (
    hash_join, hash_join_static,
)
from spark_rapids_tpu_torch.kernels.layout import (
    compact, concat_kway, gather_rows, take_head,
)
from spark_rapids_tpu_torch.kernels.sort import sort_batch
from spark_rapids_tpu_torch.plan.physical import GpuExec, PhysicalOp


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


class GpuProjectExec(GpuExec):
    def __init__(self, exprs: List[Expression], child: PhysicalOp,
                 schema: T.Schema):
        super().__init__([child], schema)
        self.exprs = [bind_references(e, child.output_schema) for e in exprs]

    def describe(self):
        return f"GpuProject({', '.join(f.name for f in self.output_schema)})"

    def _run(self, batch: ColumnBatch) -> ColumnBatch:
        ctx = GpuEvalCtx(batch)
        cols = [e.gpu_eval(ctx).to_column() for e in self.exprs]
        return ColumnBatch(self.output_schema, cols, batch.num_rows,
                           batch.capacity)

    def partitions(self, ctx):
        return [map(self._run, p) for p in self.children[0].partitions(ctx)]


class GpuFilterExec(GpuExec):
    def __init__(self, condition: Expression, child: PhysicalOp):
        super().__init__([child], child.output_schema)
        self.condition = bind_references(condition, child.output_schema)

    def describe(self):
        return f"GpuFilter({self.condition!r})"

    def _run(self, batch: ColumnBatch) -> ColumnBatch:
        v = self.condition.gpu_eval(GpuEvalCtx(batch))
        return compact(batch, v.validity & v.data.to(torch.bool))

    def partitions(self, ctx):
        return [map(self._run, p) for p in self.children[0].partitions(ctx)]


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
            merged = _concat_all(list(part), self.output_schema)
            if merged is None:
                return
            ectx = GpuEvalCtx(merged)
            vals = [e.gpu_eval(ectx) for e in self.key_exprs]
            yield sort_batch(merged, vals,
                             [o.ascending for o in self.orders],
                             [o.nulls_first for o in self.orders])

        return [gen(p) for p in self.children[0].partitions(ctx)]


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
    pack), merge them with the sort-based groupby, finalize."""

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
        self.key_schema = T.Schema([T.Field(n, e.dtype, e.nullable)
                                    for n, e in zip(key_names, key_exprs)])
        self.buffer_schemas = [[s.dtype for s in a.fn.buffers()]
                               for a in aggs]
        self._hash_capable = hash_agg_capable(
            mode, [e.dtype for e in key_exprs], [a.fn for a in aggs])
        self._hash_disabled = False  # sticky off after a flagged batch

    def describe(self):
        return f"GpuHashAggregate({self.mode}, keys={len(self.key_exprs)})"

    def _aggregate_batch(self, batch: ColumnBatch) -> ColumnBatch:
        """Sort path, both modes."""
        nk = len(self.key_exprs)
        if self.mode == "update":
            ectx = GpuEvalCtx(batch)
            key_vals = [e.gpu_eval(ectx) for e in self.key_exprs]
            agg_inputs = [e.gpu_eval(ectx) for e in self.agg_children]
        else:  # partial batches: keys, then every buffer, by position
            key_vals = [DevVal.from_column(c) for c in batch.columns[:nk]]
            agg_inputs = [DevVal.from_column(c) for c in batch.columns[nk:]]
        group_keys, buffers = groupby_aggregate(
            batch, key_vals, agg_inputs, [a.fn for a in self.aggs],
            self.mode == "merge", self.key_schema, self.buffer_schemas)
        cols = list(group_keys.columns)
        if self.mode == "update":
            cols += [b.to_column() for bufs in buffers for b in bufs]
        else:
            cols += [a.fn.finalize(bufs).to_column()
                     for a, bufs in zip(self.aggs, buffers)]
        return ColumnBatch(self.output_schema, cols, group_keys.num_rows,
                           batch.capacity)

    def _aggregate_batch_hash(self, batch: ColumnBatch, table: int):
        """(partial batch, fallback flag) via the slot aggregate."""
        ectx = GpuEvalCtx(batch)
        group_keys, buffers, num_groups, flag = hash_group_aggregate(
            batch, [e.gpu_eval(ectx) for e in self.key_exprs],
            [e.gpu_eval(ectx) for e in self.agg_children],
            [a.fn for a in self.aggs], self.key_schema,
            table=table)
        cols = list(group_keys.columns) + [
            b.to_column() for bufs in buffers for b in bufs]
        return ColumnBatch(self.output_schema, cols, num_groups,
                           group_keys.capacity), flag

    def _update_partials(self, ctx, batches: Sequence[ColumnBatch]
                         ) -> List[ColumnBatch]:
        sizes = None
        if self._hash_capable and not self._hash_disabled and \
                HASH_AGG_MXU_ENABLED.get(ctx.conf):
            table = HASH_AGG_MXU_SLOTS.get(ctx.conf)
            pairs = [self._aggregate_batch_hash(b, table) for b in batches]
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
            partials = [self._aggregate_batch(b) for b in batches]
            sizes = host_sizes(partials)
        return [shrink_to_fit(p, s) for p, s in zip(partials, sizes)]

    def partitions(self, ctx):
        if self.mode == "update":
            def gen(part):
                batches = list(part)
                if batches:
                    yield from self._update_partials(ctx, batches)
        else:
            child_schema = self.children[0].output_schema

            def gen(part):
                merged = _concat_all(list(part), child_schema)
                if merged is not None:
                    yield self._aggregate_batch(merged)

        return [gen(p) for p in self.children[0].partitions(ctx)]


class GpuCachedScanExec(GpuExec):
    """Reads (and on first run fills) a CacheHolder of device batches,
    each right-sized once as it is cached."""

    def __init__(self, holder, child: Optional[PhysicalOp],
                 schema: T.Schema):
        super().__init__([child] if child is not None else [], schema)
        self.holder = holder

    def describe(self):
        return "GpuCachedScan"

    def partitions(self, ctx):
        if not self.holder.is_materialized:
            parts = []
            for p in self.children[0].partitions(ctx):
                batches = list(p)
                parts.append([shrink_to_fit(b, s) for b, s in
                              zip(batches, host_sizes(batches))])
            self.holder.partitions = parts
        for part in self.holder.partitions:
            for b in part:
                if b.device != ctx.device:
                    raise ValueError(f"cached batches live on {b.device}, "
                                     f"the query runs on {ctx.device}")
        return [iter(p) for p in self.holder.partitions]


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
    right) pair and the fused static join with its overflow rerun."""

    def __init__(self, children, left_keys, right_keys, how: str,
                 schema: T.Schema, left_schema: T.Schema,
                 right_schema: T.Schema):
        super().__init__(children, schema)
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.how = how
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
                         self.output_schema)

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
    """Equi-join of co-partitioned (left, right) pairs; on one device each
    side is one partition, concatenated and joined once.  Host-driven by
    default; fused when a mesh is active and both children are mesh
    exchanges.  Not ported: residual conditions (the planner refuses
    them), AQE pair coalescing, the skew split and the dynamic broadcast
    switch."""

    _FUSABLE_HOWS = ("inner", "left", "right", "full", "left_semi",
                     "left_anti")

    def __init__(self, left: PhysicalOp, right: PhysicalOp,
                 left_keys: List[Expression], right_keys: List[Expression],
                 how: str, schema: T.Schema):
        super().__init__([left, right], left_keys, right_keys, how, schema,
                         left.output_schema, right.output_schema)

    def describe(self):
        return f"GpuShuffledHashJoin({self.how})"

    def _fusable(self, ctx) -> bool:
        from spark_rapids_tpu_torch.parallel.exchange import (
            GpuShuffleExchangeExec,
        )
        return ctx.mesh_spmd_active() and \
            self.how in self._FUSABLE_HOWS and \
            all(isinstance(c, GpuShuffleExchangeExec) for c in self.children)

    def partitions(self, ctx):
        lparts = self.children[0].partitions(ctx)
        rparts = self.children[1].partitions(ctx)
        if len(lparts) != len(rparts):
            raise ValueError(f"join sides have {len(lparts)} and "
                             f"{len(rparts)} partitions")
        fused = self._fusable(ctx)

        def host(lbs, rbs):
            out = self._join_pair(_concat_all(lbs, self.left_schema),
                                  _concat_all(rbs, self.right_schema),
                                  ctx.device)
            return [] if out is None else [out]

        def gen(lp, rp):
            lbs, rbs = list(lp), list(rp)
            if fused and lbs and rbs:
                yield from self._join_fused(ctx, lbs, rbs,
                                            lambda: host(lbs, rbs))
            else:
                yield from host(lbs, rbs)

        return [gen(lp, rp) for lp, rp in zip(lparts, rparts)]


class GpuBroadcastHashJoinExec(_HashJoinBase):
    """Equi-join against a broadcast build side: the build side is
    concatenated once per query and every stream batch joins against it,
    with no exchange on either side.  ``broadcast_side`` is "right" (inner,
    left, semi, anti) or "left" (inner, right): the planner never
    broadcasts a side whose unmatched rows the join must emit.  Fused under
    an active mesh when the build subtree holds no exchange and shares no
    node with the stream subtree: then each stream partition is joined
    whole, with static sizing.  Not ported: registering the build side in
    a spill catalog."""

    _FUSABLE_HOWS = {"right": ("inner", "left", "left_semi", "left_anti"),
                     "left": ("inner", "right")}

    def __init__(self, stream: PhysicalOp, broadcast: PhysicalOp,
                 left_keys: List[Expression], right_keys: List[Expression],
                 how: str, broadcast_side: str, schema: T.Schema):
        if broadcast_side == "right":
            lsch, rsch = stream.output_schema, broadcast.output_schema
        else:
            lsch, rsch = broadcast.output_schema, stream.output_schema
        super().__init__([stream, broadcast], left_keys, right_keys, how,
                         schema, lsch, rsch)
        self.broadcast_side = broadcast_side
        self._bc_cache = None  # (weakref(ctx), build batches)

    def describe(self):
        return (f"GpuBroadcastHashJoin({self.how}, "
                f"bc={self.broadcast_side})")

    def _build_side(self, ctx) -> dict:
        """The build side, materialized once per query: its batches, and
        (on first use by the host path) their concatenation."""
        import weakref
        cached = self._bc_cache
        if cached is not None and cached[0]() is ctx:
            return cached[1]
        build = {"batches": [b for p in self.children[1].partitions(ctx)
                             for b in p]}
        self._bc_cache = (weakref.ref(ctx), build)
        return build

    def _fusable(self, ctx) -> bool:
        from spark_rapids_tpu_torch.parallel.exchange import (
            GpuShuffleExchangeExec,
        )
        if not ctx.mesh_spmd_active() or self.how not in \
                self._FUSABLE_HOWS[self.broadcast_side]:
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

        def host(sbs):
            if "batch" not in build:
                build["batch"] = _concat_all(build["batches"], bc_schema) \
                    or empty_device_batch(bc_schema, ctx.device)
            outs = (self._join_pair(*self._pair(sb, build["batch"]),
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
