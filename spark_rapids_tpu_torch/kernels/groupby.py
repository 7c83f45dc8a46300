"""Sort-based groupby aggregation (port of
``spark_rapids_tpu/kernels/groupby.py``).

Rows are sorted on the exact key columns, segment ids come from adjacent key
equality, and the aggregates' segment kernels reduce with
``num_segments = capacity`` (worst case: every live row its own group).  The
same machinery serves the update (raw rows) and merge (partial buffers)
modes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import ColumnBatch, device_scalar
from spark_rapids_tpu_torch.exprs.base import DevVal
from spark_rapids_tpu_torch.kernels.layout import (
    compaction_indices, gather_rows,
)
from spark_rapids_tpu_torch.kernels.sort import argsort_batch
from spark_rapids_tpu_torch.kernels.sortkeys import (
    keys_equal_prev, string_key_hashes,
)


@dataclasses.dataclass
class GroupSegments:
    """Result of grouping: row order and segment structure."""

    perm: torch.Tensor        # int64[cap] sort permutation
    seg_ids: torch.Tensor     # int64[cap] group id per *sorted* row
    seg_start: torch.Tensor   # bool[cap] first sorted row of each group
    num_groups: torch.Tensor  # 0-d int32
    live: torch.Tensor        # bool[cap] sorted-row liveness


def group_segments(key_vals: List[DevVal], num_rows) -> GroupSegments:
    """Sort rows by key and mark exact group boundaries.  The string
    keys are hashed once, for the sort; the adjacent equality test takes
    those hashes moved by the permutation (every row, dead ones too, moves
    with its bytes, so they are the sorted bytes' hashes)."""
    cap = int(key_vals[0].validity.shape[0])
    n = len(key_vals)
    hashes = string_key_hashes(key_vals)
    perm = argsort_batch(key_vals, [True] * n, [True] * n, num_rows,
                         groupings=[True] * n, hashes=hashes)
    live = torch.arange(cap, dtype=torch.int32,
                        device=perm.device) < num_rows
    # string keys need their bytes in sorted order for the adjacent
    # equality test's prefix words
    sorted_keys = [_gather_str_val(v, perm, cap) if v.dtype.is_string
                   else DevVal(v.dtype, v.data[perm], v.validity[perm])
                   for v in key_vals]
    sorted_hashes = [None if h is None else (h[0][perm], h[1][perm])
                     for h in hashes]
    seg_start = live & ~keys_equal_prev(sorted_keys, sorted_hashes)
    seg_ids = (torch.cumsum(seg_start.to(torch.int64), 0) - 1).clamp(
        0, cap - 1)
    num_groups = seg_start.sum().to(torch.int32)
    return GroupSegments(perm, seg_ids, seg_start, num_groups, live)


def groupby_aggregate(batch: ColumnBatch, key_vals: List[DevVal],
                      agg_inputs: List[DevVal], agg_fns: Sequence,
                      merge: bool, key_schema: T.Schema,
                      buffer_schemas: List[List[T.DataType]]
                      ) -> Tuple[ColumnBatch, List[List[DevVal]]]:
    """One-batch groupby: (group-key batch of num_groups rows, per-agg
    buffer lists aligned with group order).  In ``merge`` mode
    ``agg_inputs`` holds every aggregate's partial buffers, flattened in
    order, and ``segment_merge`` folds them; otherwise raw inputs go
    through ``segment_update``."""
    cap = batch.capacity
    segs = group_segments(key_vals, batch.num_rows)
    key_batch = ColumnBatch(
        key_schema, [v.to_column() for v in key_vals], batch.num_rows, cap)
    sorted_keys = gather_rows(key_batch, segs.perm, batch.num_rows)
    idx, _ = compaction_indices(segs.seg_start, cap)
    group_keys = gather_rows(sorted_keys, idx, segs.num_groups)

    def permuted(v: DevVal) -> DevVal:
        if v.dtype.is_string:  # count over a string column
            return _gather_str_val(v, segs.perm, cap)
        return DevVal(v.dtype, v.data[segs.perm], v.validity[segs.perm])

    out_buffers: List[List[DevVal]] = []
    if merge:
        flat_i = 0
        for fn, bufs in zip(agg_fns, buffer_schemas):
            partials = [permuted(agg_inputs[flat_i + j])
                        for j in range(len(bufs))]
            flat_i += len(bufs)
            out_buffers.append(fn.segment_merge(partials, segs.seg_ids, cap,
                                                segs.live))
    else:
        for fn, v in zip(agg_fns, agg_inputs):
            out_buffers.append(fn.segment_update(permuted(v), segs.seg_ids,
                                                 cap, segs.live))
    return group_keys, out_buffers


def _gather_str_val(v: DevVal, perm: torch.Tensor, cap: int) -> DevVal:
    """A string value with every row (dead ones too) moved by ``perm``."""
    b = ColumnBatch(T.Schema([("s", v.dtype)]), [v.to_column()],
                    device_scalar(cap, v.validity.device), cap)
    g = gather_rows(b, perm, cap).columns[0]
    return DevVal(v.dtype, g.data, g.validity, g.offsets)
