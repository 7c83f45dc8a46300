"""Shuffle and broadcast exchanges on one device (port of
``spark_rapids_tpu/parallel/exchange.py`` without the mesh branches and the
absorbed map stages).

By default (``spark.rapids.sql.tpu.exchange.collapseLocal``) an exchange
hands every input batch on in a single logical partition: on one device a
partitioning only constrains placement, which one partition trivially
satisfies.  Under a one-device mesh (``spark.rapids.shuffle.ici.enabled``)
the exchange is the all-to-all over one shard, which also hands its input
on unchanged; a join whose two children are mesh exchanges then runs fused
(``ops/gpu_exec.py``).

With the collapse off the device exchange splits.  The split sorts every
input batch by target partition (partition ids, dead rows to ``n``, one
stable argsort, one gather), fetches every batch's per-target row counts
and varlen element totals in ONE host sync, then assembles each target
partition from all sorted batches with one k-way segment gather: one
gatherScatter launch for every buffer of the piece
(``layout.gather_segments_kway``).  A partition over
``spark.rapids.sql.tpu.exchange.splitCoalesceMaxBytes`` stays as
per-batch pieces.  Range partitioning samples its bounds first, in three
host syncs of its own (``rangeSampleSyncs``); single partitioning hands
over the flat batch list.  The split records
``_last_part_rows``/``_last_part_bytes``, host-known sizes the adaptive
layer (``plan/adaptive.py``) reads, and is memoized per query context
and runtime generation: each piece is registered in the spill catalog at
``PRIORITY_SHUFFLE_OUTPUT`` (closed when the query ends), read back with
one unspill in flight ahead of the consumer (``prefetch_spillables``),
and a replay after a device-lost recovery splits again.  The ``exchange``
fault site fires as a device exchange hands out its partitions, collapsed
or not.
:class:`CpuShuffleExchangeExec` is the host twin: one stable ``argsort``
per batch.
"""

from __future__ import annotations

import itertools
import time
from typing import List

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import (
    ColumnBatch, HostBatch, device_to_host_many, fixed_row_bytes,
    round_up_capacity, varlen_byte_scales,
)
from spark_rapids_tpu_torch.config import (
    CPU_RANGE_PARTITIONING_SAMPLE, EXCHANGE_COLLAPSE_LOCAL,
    SHUFFLE_COALESCE_MAX_BYTES,
)
from spark_rapids_tpu_torch.kernels.layout import (
    gather_rows, gather_segments_kway, segment_inputs,
)
from spark_rapids_tpu_torch.parallel.partitioning import (
    Partitioning, RangePartitioning, SinglePartitioning,
)
from spark_rapids_tpu_torch.fault import inject
from spark_rapids_tpu_torch.mem.catalog import PRIORITY_SHUFFLE_OUTPUT
from spark_rapids_tpu_torch.plan.physical import (
    CpuExec, GpuExec, PhysicalOp, prefetch_spillables,
)


def _range_sample_limit(ctx) -> int:
    return max(1, CPU_RANGE_PARTITIONING_SAMPLE.get(ctx.conf))


def _collapse_local(ctx) -> bool:
    return EXCHANGE_COLLAPSE_LOCAL.get(ctx.conf)


def _flat(parts):
    return itertools.chain.from_iterable(parts)


class CpuShuffleExchangeExec(CpuExec):
    """The host exchange.  Collapsed: every input batch in partition
    order, then batch order (the device exchange's order).  Split: each
    batch's rows by one stable ``argsort`` of their partition ids, so a
    target partition keeps its rows in input order."""

    def __init__(self, partitioning: Partitioning, child: PhysicalOp):
        super().__init__([child], child.output_schema)
        self.partitioning = partitioning

    def describe(self):
        p = self.partitioning
        return f"CpuShuffleExchange({type(p).__name__}, {p.num_partitions})"

    def num_partitions(self, ctx):
        return 1 if _collapse_local(ctx) else \
            self.partitioning.num_partitions

    def partitions(self, ctx):
        in_parts = self.children[0].partitions(ctx)
        if _collapse_local(ctx):
            return [_flat(in_parts)]
        n = self.partitioning.num_partitions
        all_batches = [list(p) for p in in_parts]
        if isinstance(self.partitioning, RangePartitioning):
            self.partitioning.prepare_columns(*_sample_host_keys(
                all_batches, self.partitioning.key_ordinals,
                _range_sample_limit(ctx)))
        out: List[List[HostBatch]] = [[] for _ in range(n)]
        for pi, batches in enumerate(all_batches):
            for hb in batches:
                ids = self.partitioning.host_partition_ids(hb, pi)
                order = np.argsort(ids, kind="stable")
                counts = np.bincount(ids, minlength=n)
                ends = np.cumsum(counts)
                for p in range(n):
                    if counts[p]:
                        out[p].append(HostBatch(hb.schema, [
                            c.take(order[ends[p] - counts[p]:ends[p]])
                            for c in hb.columns]))
        return [iter(p) for p in out]


def _sample_host_keys(all_batches: List[List[HostBatch]],
                      key_ordinals: List[int], limit: int):
    """The key columns of the first ``limit`` rows, in partition and
    batch order: (one host column a key, rows)."""
    heads, remaining = [], limit
    for hb in (hb for batches in all_batches for hb in batches):
        if remaining <= 0:
            break
        take = min(hb.num_rows, remaining)
        if take:
            heads.append(HostBatch(
                T.Schema([hb.schema.fields[i] for i in key_ordinals]),
                [hb.columns[i].slice(0, take) for i in key_ordinals]))
            remaining -= take
    return _key_columns(heads, limit - remaining)


def _key_columns(heads: List[HostBatch], rows: int):
    if not heads:
        return [], 0
    return HostBatch.concat(heads).columns, rows


def _sample_device_keys(all_batches: List[List[ColumnBatch]],
                        key_ordinals: List[int], limit: int, syncs=None):
    """The key columns of the first ``limit`` rows, in partition and
    batch order, on the host: one sync for every batch's row count, then
    a head gather of the key columns per batch that contributes, brought
    back together (:func:`device_to_host_many`: one sync for the sizes,
    one for the copies).  Each sync adds one to the metric ``syncs`` when
    given.  Returns (one host column a key, rows)."""
    subs = [ColumnBatch(T.Schema([db.schema.fields[i] for i in key_ordinals]),
                        [db.columns[i] for i in key_ordinals], db.num_rows,
                        db.capacity)
            for batches in all_batches for db in batches]
    if not subs:
        return [], 0
    counts = torch.stack([b.num_rows.to(torch.int64) for b in subs]).tolist()
    if syncs is not None:
        syncs.add(1)
    gathered, remaining = [], limit
    for sub, nr in zip(subs, counts):
        take = min(int(nr), remaining)
        if remaining <= 0:
            break
        if take <= 0:
            continue
        pcap = round_up_capacity(take)
        gathered.append(gather_rows(
            sub, torch.arange(pcap, dtype=torch.int64, device=sub.device),
            take, out_capacity=pcap))
        remaining -= take
    heads = device_to_host_many(gathered, keep_offsets=True)
    if syncs is not None and gathered:
        syncs.add(2)
    return _key_columns(heads, limit - remaining)


class GpuShuffleExchangeExec(GpuExec):
    """The device exchange: collapsed, under a mesh handed through, or the
    split (module docstring).  Metrics: ``shufflePieces``,
    ``shuffleSyncs`` (the split's one), ``rangeSampleSyncs`` (the range
    sample's), ``shuffleSplitDispatches``, ``shuffleBytes``,
    ``shuffleRows``, ``shuffleWallNs``, ``aqeEstimateErrorPct`` (against
    the planner's ``_aqe_est_bytes``) and ``shuffleElided``."""

    def __init__(self, partitioning: Partitioning, child: PhysicalOp):
        super().__init__([child], child.output_schema)
        self.partitioning = partitioning

    def describe(self):
        p = self.partitioning
        return f"GpuShuffleExchange({type(p).__name__}, {p.num_partitions})"

    def _splits(self, ctx) -> bool:
        return ctx.mesh is None and not _collapse_local(ctx)

    def num_partitions(self, ctx):
        return self.partitioning.num_partitions if self._splits(ctx) else 1

    def has_materialized_split(self, ctx) -> bool:
        """True when the split already ran for ``ctx`` in the runtime's
        current generation: :meth:`partitions` would hand back its pieces
        (registered until the query ends) instead of splitting again."""
        held = ctx.held.get(self.op_id)
        return held is not None and held[0] == ctx.generation

    def bypass_partitions(self, ctx):
        """The child's partitions with no split (the adaptive broadcast
        switch's probe side, which joins every batch against a broadcast
        build): no partition ids, no piece gathers, no sync."""
        inject.maybe_fire("exchange")
        ctx.metric(self.op_id, "shuffleElided").add(1)
        return self.children[0].partitions(ctx)

    def partitions(self, ctx):
        inject.maybe_fire("exchange")
        if not self._splits(ctx):
            return [_flat(self.children[0].partitions(ctx))]
        if self.has_materialized_split(ctx):
            return [prefetch_spillables([h for h, _, _ in p])
                    for p in ctx.held[self.op_id][1]]
        all_batches = [list(p) for p in self.children[0].partitions(ctx)]
        if isinstance(self.partitioning, RangePartitioning):
            self._sample_range(ctx, all_batches)
        if isinstance(self.partitioning, SinglePartitioning):
            return [iter([b for part in all_batches for b in part])]
        n = self.partitioning.num_partitions
        out: List[list] = [[] for _ in range(n)]  # (piece, rows, bytes)
        t0 = time.monotonic_ns()
        self._split(ctx, all_batches, n, out)
        ctx.metric(self.op_id, "shufflePieces").add(sum(map(len, out)))
        # the adaptive layer reads these instead of counting rows again
        self._last_part_rows = [sum(r for _, r, _ in p) for p in out]
        self._last_part_bytes = [sum(b for _, _, b in p) for p in out]
        ctx.metric(self.op_id, "shuffleBytes").add(sum(self._last_part_bytes))
        ctx.metric(self.op_id, "shuffleRows").add(sum(self._last_part_rows))
        ctx.metric(self.op_id, "shuffleWallNs").add(time.monotonic_ns() - t0)
        est = getattr(self, "_aqe_est_bytes", None)
        if est is not None:
            actual = sum(self._last_part_bytes)
            ctx.metric(self.op_id, "aqeEstimateErrorPct").add(
                abs(est - actual) * 100.0 / max(actual, 1))
        ctx.held[self.op_id] = (ctx.generation, out)
        return [prefetch_spillables([h for h, _, _ in p]) for p in out]

    def _sample_range(self, ctx, all_batches) -> None:
        """The range bounds from the first rows' keys (three syncs)."""
        self.partitioning.prepare_columns(*_sample_device_keys(
            all_batches, self.partitioning.key_ordinals,
            _range_sample_limit(ctx),
            ctx.metric(self.op_id, "rangeSampleSyncs")))

    def _sort_by_pid(self, batch: ColumnBatch, part_index: int, n: int,
                     bound_words=None):
        """(the batch with each target's rows contiguous, per-target row
        counts, per-target element totals of each varlen column): the
        partition ids with dead rows sent to ``n``, one stable argsort,
        one gather; the counts and totals segment sums.  No host sync."""
        cap, dev = batch.capacity, batch.device
        if bound_words is not None:
            ids = self.partitioning.device_partition_ids_from_words(
                batch, bound_words)
        else:
            ids = self.partitioning.device_partition_ids(batch, part_index)
        live = torch.arange(cap, dtype=torch.int32, device=dev) < \
            batch.num_rows
        ids = torch.where(live, ids.to(torch.int64), n)
        order = torch.sort(ids, stable=True)[1]
        sorted_batch = gather_rows(batch, order, batch.num_rows)
        # index_add_, not bincount: CUDA's bincount reads the max on the
        # host
        counts = torch.zeros(n + 1, dtype=torch.int64, device=dev) \
            .index_add_(0, ids, torch.ones_like(ids))[:n]
        totals = [torch.zeros(n + 1, dtype=torch.int64, device=dev)
                  .index_add_(0, ids, (c.offsets[1:] - c.offsets[:-1])
                              .to(torch.int64))[:n]
                  for c in batch.columns if c.is_varlen]
        return sorted_batch, counts, totals

    def _piece_bytes(self, rows: int, elems) -> int:
        return rows * fixed_row_bytes(self.output_schema) + sum(
            e * s for e, s in zip(elems,
                                  varlen_byte_scales(self.output_schema)))

    def _split(self, ctx, all_batches, n, out):
        """Every batch's pid sort dispatched, ONE sync for all counts and
        totals, then one k-way segment gather per target partition (per
        batch above ``splitCoalesceMaxBytes``), each piece registered in
        the spill catalog as it is made."""
        catalog = ctx.catalog
        bound_words = None
        if isinstance(self.partitioning, RangePartitioning):
            bound_words = self.partitioning.encode_bounds_device(ctx.device)
        sorted_all = []
        for pi, batches in enumerate(all_batches):
            for db in batches:
                sorted_all.append(self._sort_by_pid(db, pi, n, bound_words))
                ctx.metric(self.op_id, "shuffleSplitDispatches").add(1)
        if not sorted_all:
            return
        sizes = torch.stack([torch.stack([c] + bt)
                             for _, c, bt in sorted_all]).tolist()
        ctx.metric(self.op_id, "shuffleSyncs").add(1)
        counts = [s[0] for s in sizes]
        elems = [s[1:] for s in sizes]
        starts = [np.concatenate(([0], np.cumsum(c)))[:n].tolist()
                  for c in counts]
        cap_bytes = SHUFFLE_COALESCE_MAX_BYTES.get(ctx.conf)
        n_var = len(varlen_byte_scales(self.output_schema))
        inputs = segment_inputs([b for b, _, _ in sorted_all])
        for p in range(n):
            segs = [b for b in range(len(sorted_all)) if counts[b][p] > 0]
            if not segs:
                continue
            group_elems = [sum(elems[b][ci][p] for b in segs)
                           for ci in range(n_var)]
            total = self._piece_bytes(sum(counts[b][p] for b in segs),
                                      group_elems)
            groups = [[b] for b in segs] \
                if cap_bytes > 0 and total > cap_bytes and len(segs) > 1 \
                else [segs]
            for group in groups:
                rows = sum(counts[b][p] for b in group)
                es = [sum(elems[b][ci][p] for b in group)
                      for ci in range(n_var)]
                piece = gather_segments_kway(
                    [sorted_all[b][0] for b in group],
                    [starts[b][p] for b in group],
                    [counts[b][p] for b in group], round_up_capacity(rows),
                    [round_up_capacity(max(e, 16), minimum=16) for e in es],
                    inputs=inputs.take(group))
                ctx.metric(self.op_id, "shuffleSplitDispatches").add(1)
                h = catalog.register(piece, PRIORITY_SHUFFLE_OUTPUT)
                ctx.defer_close(h)
                del piece
                out[p].append((h, rows, self._piece_bytes(rows, es)))


class CpuBroadcastExchangeExec(CpuExec):
    """Materialize the whole child once; every consumer partition sees the
    same single host batch (the broadcast, collected once on the host)."""

    def __init__(self, child: PhysicalOp):
        super().__init__([child], child.output_schema)
        self._cached = None

    def num_partitions(self, ctx):
        return 1

    def materialize(self, ctx) -> HostBatch:
        if self._cached is None:
            from spark_rapids_tpu_torch.ops.cpu_exec import _concat
            self._cached = _concat(
                [b for p in self.children[0].partitions(ctx) for b in p],
                self.output_schema)
        return self._cached

    def partitions(self, ctx):
        return [iter([self.materialize(ctx)])]
