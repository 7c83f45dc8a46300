"""Row-movement kernels: gather, filter compaction, head, k-way concat.

Port of ``spark_rapids_tpu/kernels/layout.py``.  Plain functions over
:class:`ColumnBatch`; output capacities are host ints, live row counts stay
0-d tensors on the device.  ``jnp`` gathers clamp out-of-range indices
silently while a CUDA gather with a bad index kills the context, so every
index here is clamped or masked explicitly before it is used.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from spark_rapids_tpu_torch.batch import (
    ColumnBatch, DeviceColumn, device_scalar,
)
from spark_rapids_tpu_torch.kernels import cuda_tier


def _count(n, device) -> torch.Tensor:
    """A live-row count as a 0-d int32 device tensor."""
    if isinstance(n, torch.Tensor):
        return n.reshape(()).to(torch.int32)
    return device_scalar(n, device)


def _gather_string_column(col: DeviceColumn, idx: torch.Tensor,
                          live: torch.Tensor, out_cap: int,
                          out_byte_cap: int) -> DeviceColumn:
    """Gather whole string rows: new row r = old row ``idx[r]`` (idx
    already clamped, 0 on dead rows).  New offsets come from one cumsum of
    the gathered lengths (0 on dead rows, so they stay constant past the
    live rows); every output byte finds its row with one ``searchsorted``
    over the new offsets and copies its source byte.  Bytes past the new
    total are 0, as in the JAX package, so raw buffers compare equal."""
    dev = col.data.device
    src_lens = col.offsets[1:] - col.offsets[:-1]
    new_lens = torch.where(live, src_lens[idx], 0)
    new_offsets = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=dev),
        torch.cumsum(new_lens, 0, dtype=torch.int32)])
    pos = torch.arange(out_byte_cap, dtype=torch.int32, device=dev)
    rows = cuda_tier.rows_of_positions(new_offsets, out_byte_cap)
    rows_c = rows.clamp(0, out_cap - 1).long()
    pos_in_row = pos - new_offsets[rows_c]
    src_pos = col.offsets[idx[rows_c]] + pos_in_row
    src_pos = src_pos.clamp(0, int(col.data.shape[0]) - 1).long()
    in_range = pos < new_offsets[-1]
    data = torch.where(in_range, col.data[src_pos], 0).to(col.data.dtype)
    validity = col.validity[idx] & live
    return DeviceColumn(col.dtype, data, validity, new_offsets)


def gather_rows(batch: ColumnBatch, indices: torch.Tensor, num_rows,
                out_capacity: Optional[int] = None,
                out_byte_caps: Optional[Sequence[int]] = None
                ) -> ColumnBatch:
    """New batch whose row r is ``batch`` row ``indices[r]`` for
    r < num_rows; rows past num_rows are zero/invalid.  ``indices`` has
    ``out_capacity`` entries (default: the input capacity).
    ``out_byte_caps`` gives each string column's output byte capacity, in
    schema order (default: the input column's, valid whenever the gather
    cannot grow the byte total: permutations and filters)."""
    out_cap = out_capacity if out_capacity is not None else batch.capacity
    dev = batch.device
    num_rows = _count(num_rows, dev)
    live = torch.arange(out_cap, dtype=torch.int32, device=dev) < num_rows
    idx = indices.to(torch.int64).clamp(0, batch.capacity - 1)
    idx = idx.masked_fill(~live, 0)
    cols = []
    str_i = 0
    for col in batch.columns:
        if col.is_varlen:
            bcap = (out_byte_caps[str_i] if out_byte_caps is not None
                    else int(col.data.shape[0]))
            str_i += 1
            cols.append(_gather_string_column(col, idx, live, out_cap, bcap))
            continue
        data = col.data[idx].masked_fill(~live, 0)
        validity = col.validity[idx] & live
        cols.append(DeviceColumn(col.dtype, data, validity))
    return ColumnBatch(batch.schema, cols, num_rows, out_cap)


def compaction_indices(mask: torch.Tensor, num_rows):
    """(indices, count): stable order of rows where mask is True and live.

    ``indices`` is int32[cap], kept rows first then zeros.  A cumsum ranks
    the kept rows and one scatter inverts the ranking.  Dropped row i is
    aimed at its own scratch slot ``cap + i``, cut off after: one shared
    scratch slot would take every dropped row's store at one address,
    which the card serializes.  ``torch.nonzero`` would sync the host."""
    cap = int(mask.shape[0])
    dev = mask.device
    iota = torch.arange(cap, dtype=torch.int32, device=dev)
    keep = mask & (iota < num_rows)
    csum = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32)
    count = csum[cap - 1] if cap else device_scalar(0, dev)
    target = torch.where(keep, csum - 1, cap + iota).to(torch.int64)
    idx = torch.zeros(2 * cap, dtype=torch.int32, device=dev)
    idx.index_copy_(0, target, iota)
    return idx[:cap], count


def compact(batch: ColumnBatch, mask: torch.Tensor) -> ColumnBatch:
    """Filter: keep rows where mask (bool[cap]) is True.  The output keeps
    the input capacity (a filter can only shrink)."""
    indices, count = compaction_indices(mask, batch.num_rows)
    return gather_rows(batch, indices, count)


def take_head(batch: ColumnBatch, limit) -> ColumnBatch:
    """LocalLimit: clamp the live-row count (no data movement).  String
    offsets then keep growing past the new count; :func:`concat_kway`
    reads each input's live bytes up to ``offsets[num_rows]``."""
    n = torch.minimum(batch.num_rows, _count(limit, batch.device))
    return ColumnBatch(batch.schema, batch.columns, n, batch.capacity)


def concat_kway(batches: Sequence[ColumnBatch], out_capacity: int,
                out_byte_caps: Optional[Sequence[int]] = None
                ) -> ColumnBatch:
    """Concatenate k batches (same schema) into ONE output allocation per
    buffer: every input's live rows (and, for strings, live bytes
    ``[0, offsets[num_rows])``) are written once at their running offset,
    all buffers in one gatherScatter launch on CUDA
    (:func:`cuda_tier.pack_columns`).  Output rows past the live total are
    zeros; string offsets are the cumsum of the packed live lengths.
    ``out_byte_caps`` defaults to the summed input byte capacities."""
    if not batches:
        raise ValueError("concat_kway needs at least one batch")
    if len(batches) == 1:
        return batches[0]
    schema = batches[0].schema
    for b in batches[1:]:  # partials of one exec share their schema object
        if b.schema is not schema and b.schema != schema:
            raise ValueError(f"{b.schema} != {schema}")
    ns = [b.num_rows for b in batches]
    total = torch.stack(ns).sum().to(torch.int32)
    columns = [[(c.data, c.validity, c.offsets) for c in parts]
               for parts in zip(*(b.columns for b in batches))]
    if out_byte_caps is None:
        out_byte_caps = [sum(int(d.shape[0]) for d, _, _ in parts)
                         for parts in columns if parts[0][2] is not None]
    packed = cuda_tier.pack_columns(columns, ns, out_capacity,
                                    list(out_byte_caps))
    cols = [DeviceColumn(f.dtype, data, validity, offsets)
            for f, (data, validity, offsets) in zip(schema.fields, packed)]
    return ColumnBatch(schema, cols, total, out_capacity)
