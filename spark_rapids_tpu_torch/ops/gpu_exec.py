"""Device operators (port of ``spark_rapids_tpu/ops/tpu_exec.py``: project,
filter, sort, hash aggregate and cached scan).

Each exec runs its per-batch work eagerly as torch ops on ``ctx.device``.
String columns ride every operator as offsets + bytes; string group keys
take the sort-based groupby (the slot aggregate needs integral keys).
Host syncs happen only where the JAX package takes them: to size an output
(:func:`shrink_to_fit`, :func:`_concat_all`) and to read the slot
aggregate's fallback flags, each as ONE ``.tolist()`` for all batches.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import (
    ColumnBatch, host_sizes, round_up_capacity,
)
from spark_rapids_tpu_torch.config import (
    HASH_AGG_MXU_ENABLED, HASH_AGG_MXU_SLOTS,
)
from spark_rapids_tpu_torch.exprs.aggregates import AggregateExpression
from spark_rapids_tpu_torch.exprs.base import (
    DevVal, Expression, GpuEvalCtx, SortOrder, bind_references,
)
from spark_rapids_tpu_torch.kernels.groupby import groupby_aggregate
from spark_rapids_tpu_torch.kernels.hashagg import (
    hash_agg_capable, hash_group_aggregate,
)
from spark_rapids_tpu_torch.kernels.layout import (
    compact, concat_kway, gather_rows,
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
