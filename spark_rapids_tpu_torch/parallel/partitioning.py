"""Partitioning strategies (port of ``spark_rapids_tpu/parallel/
partitioning.py``, without the mesh rules).

Each strategy computes a target-partition id per row, on the device (for
the device exchange) and on the host (the host exchange).  Hash
partitioning is ``pmod(murmur3, n)`` over the JAX package's hash words: the
raw value bits for fixed-width types, the engine's two polynomial string
hashes (a stringHash launch) for strings, so every row lands where the JAX
package puts it.  Round robin starts each batch at its partition ordinal, as
the JAX package does, not at a running count.  Range partitioning compares
each row with bounds picked from a host sample: on the device as the
order-preserving sort-key words (``kernels/sortkeys.py``) of the rows and
the bounds in one ``[rows, bounds]`` grid, on the host as ranks of the same
order.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import ColumnBatch, HostBatch, HostColumn
from spark_rapids_tpu_torch.exprs.base import (
    CpuEvalCtx, DevVal, Expression, GpuEvalCtx, SortOrder,
)
from spark_rapids_tpu_torch.exprs.hashing import (
    murmur3_cols, murmur3_cols_cpu,
)


class Partitioning:
    num_partitions: int = 1

    def device_partition_ids(self, batch: ColumnBatch, part_index: int):
        raise NotImplementedError

    def host_partition_ids(self, batch: HostBatch, part_index: int):
        raise NotImplementedError

    def prepare(self, sample_rows):
        """Hook for strategies that need a pass over the data (range)."""


@dataclasses.dataclass
class SinglePartitioning(Partitioning):
    num_partitions: int = 1

    def device_partition_ids(self, batch, part_index):
        return torch.zeros(batch.capacity, dtype=torch.int32,
                           device=batch.device)

    def host_partition_ids(self, batch, part_index):
        return np.zeros(batch.num_rows, dtype=np.int32)


@dataclasses.dataclass
class HashPartitioning(Partitioning):
    keys: List[Expression]
    num_partitions: int

    def device_partition_ids(self, batch, part_index):
        ctx = GpuEvalCtx(batch)
        h = murmur3_cols([k.gpu_eval(ctx) for k in self.keys])
        return torch.remainder(h, self.num_partitions).to(torch.int32)

    def host_partition_ids(self, batch, part_index):
        ctx = CpuEvalCtx(batch)
        h = murmur3_cols_cpu([k.cpu_eval(ctx) for k in self.keys])
        n = np.int32(self.num_partitions)
        return ((h % n) + n) % n


@dataclasses.dataclass
class RoundRobinPartitioning(Partitioning):
    num_partitions: int

    def device_partition_ids(self, batch, part_index):
        iota = torch.arange(batch.capacity, dtype=torch.int32,
                            device=batch.device)
        return (part_index + iota) % self.num_partitions

    def host_partition_ids(self, batch, part_index):
        return (part_index + np.arange(batch.num_rows, dtype=np.int32)) \
            % np.int32(self.num_partitions)


class RangePartitioning(Partitioning):
    """Sample-based range bounds (GpuRangePartitioner analogue).  The
    exchange brings a sample of the keys to the host,
    :meth:`prepare_columns` picks the bounds, and a row's partition is
    the number of bounds its key exceeds."""

    def __init__(self, orders: List[SortOrder], key_ordinals: List[int],
                 num_partitions: int):
        self.orders = orders
        self.key_ordinals = key_ordinals
        self.num_partitions = num_partitions
        self.bound_rows: Optional[List[tuple]] = None  # host key tuples
        self._bound_words = None  # (device, words) of the bounds

    def prepare(self, sample_rows):
        """sample_rows: key tuples sampled from the input (see
        :meth:`prepare_columns`)."""
        self.prepare_columns(
            [HostColumn.from_list(o.child.dtype, [r[i] for r in sample_rows])
             for i, o in enumerate(self.orders)], len(sample_rows))

    def prepare_columns(self, cols: List[HostColumn], n_rows: int):
        """The sample as one host column a key: bound i is the sample's
        row ``(i * n_rows) // n`` in the sort order, by one stable
        ``lexsort`` of the sample's key words (``ops/cpu_exec.py:
        sort_key_words``, the order of the JAX package's ``sort_key_fn``,
        by which it sorts the sample's Python tuples: the same rows)."""
        from spark_rapids_tpu_torch.ops.cpu_exec import sort_key_words
        n = self.num_partitions
        self._bound_words = None
        if not n_rows or n <= 1:
            self.bound_rows = []
            return
        order = np.lexsort(sort_key_words(cols, self.orders)[::-1])
        picks = order[[min(n_rows - 1, (i * n_rows) // n)
                       for i in range(1, n)]]
        values = [c.take(picks).to_list() for c in cols]
        self.bound_rows = list(zip(*values))

    def _bound_columns(self) -> List[HostColumn]:
        return [HostColumn.from_list(o.child.dtype,
                                     [b[i] for b in self.bound_rows])
                for i, o in enumerate(self.orders)]

    def host_partition_ids(self, batch, part_index):
        """The JAX twin's per-row count of exceeded bounds, vectorized:
        rows and bounds ranked together in the sort order
        (:func:`ops.cpu_exec.sort_key_words`), then one ``searchsorted``
        of each row's rank among the bounds'."""
        from spark_rapids_tpu_torch.ops.cpu_exec import (
            _concat_columns, sort_key_words,
        )
        assert self.bound_rows is not None, "range bounds not prepared"
        n = batch.num_rows
        if not self.bound_rows or n == 0:
            return np.zeros(n, dtype=np.int32)
        cols = [_concat_columns([batch.columns[i], b])
                for i, b in zip(self.key_ordinals, self._bound_columns())]
        words = sort_key_words(cols, self.orders)
        order = np.lexsort(words[::-1])
        sorted_words = np.stack([w[order] for w in words])
        new = np.ones(len(order), dtype=np.int64)
        new[1:] = np.any(sorted_words[:, 1:] != sorted_words[:, :-1],
                         axis=0)
        ranks = np.empty(len(order), dtype=np.int64)
        ranks[order] = np.cumsum(new)
        bounds = np.sort(ranks[n:])
        return np.searchsorted(bounds, ranks[:n], side="left") \
            .astype(np.int32)

    def _key_words(self, batch: ColumnBatch) -> List[torch.Tensor]:
        from spark_rapids_tpu_torch.kernels.sortkeys import encode_sort_keys
        vals = [DevVal.from_column(batch.columns[i])
                for i in self.key_ordinals]
        return encode_sort_keys(vals, [o.ascending for o in self.orders],
                                [o.nulls_first for o in self.orders],
                                batch.num_rows, liveness=False)

    def encode_bounds_device(self, device) -> tuple:
        """All bounds' sort-key words, encoded once (one staged batch of
        the bound rows, one encode) and cached until :meth:`prepare`
        picks new bounds: a tuple of per-word tensors of ``len(bounds)``
        entries."""
        from spark_rapids_tpu_torch.batch import host_to_device
        assert self.bound_rows is not None, "range bounds not prepared"
        device = torch.device(device)
        if self._bound_words is not None and \
                self._bound_words[0] == device:
            return self._bound_words[1]
        words = ()
        if self.bound_rows:
            nb = len(self.bound_rows)
            hb = HostBatch(T.Schema([(f"b{i}", o.child.dtype)
                                     for i, o in enumerate(self.orders)]),
                           self._bound_columns())
            db = host_to_device(hb, device, capacity=nb)
            from spark_rapids_tpu_torch.kernels.sortkeys import (
                encode_sort_keys,
            )
            words = tuple(w[:nb] for w in encode_sort_keys(
                [DevVal.from_column(c) for c in db.columns],
                [o.ascending for o in self.orders],
                [o.nulls_first for o in self.orders], db.num_rows,
                liveness=False))
        self._bound_words = (device, words)
        return words

    def device_partition_ids(self, batch, part_index):
        return self.device_partition_ids_from_words(
            batch, self.encode_bounds_device(batch.device))

    def device_partition_ids_from_words(self, batch: ColumnBatch,
                                        bound_words: tuple):
        """One lexicographic compare of every row against every bound, over
        a ``[cap, bounds]`` grid: pid = the number of bounds the row's key
        words exceed."""
        cap = batch.capacity
        if not bound_words:
            return torch.zeros(cap, dtype=torch.int32, device=batch.device)
        nb = int(bound_words[0].shape[0])
        gt = torch.zeros((cap, nb), dtype=torch.bool, device=batch.device)
        eq = torch.ones((cap, nb), dtype=torch.bool, device=batch.device)
        for w, bw in zip(self._key_words(batch), bound_words):
            gt |= eq & (w[:, None] > bw[None, :])
            eq &= w[:, None] == bw[None, :]
        return gt.sum(dim=1, dtype=torch.int32)
