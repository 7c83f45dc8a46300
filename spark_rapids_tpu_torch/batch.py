"""Columnar batch model: host (numpy) batches and device (torch) batches.

Port of ``spark_rapids_tpu/batch.py``.  The layout is the JAX package's:

* every device batch is padded to a power-of-two ``capacity`` and carries its
  live row count ``num_rows`` as a 0-d int32 tensor ON the device, so no
  operator needs the host to learn how many rows survived a filter;
* every column has a bool validity mask (True = valid); NULL semantics live in
  the expressions, not in sentinel values;
* strings are int32 ``offsets[capacity+1]`` into a flat uint8 byte buffer
  (itself padded to a power of two), offsets constant past ``num_rows``.

Host syncs are explicit: :func:`host_sizes` fetches every row count and
string byte total the caller needs in ONE ``.tolist()`` of a stacked tensor,
and :func:`device_to_host_many` issues every copy before one synchronize.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T

MIN_CAPACITY = 8
MIN_BYTE_CAPACITY = 16


def round_up_capacity(n: int, minimum: int = MIN_CAPACITY) -> int:
    """Next power of two >= n (and >= minimum)."""
    cap = max(int(minimum), 1)
    n = max(int(n), 1)
    while cap < n:
        cap <<= 1
    return cap


# --------------------------------------------------------------------------
# Host-side column/batch
# --------------------------------------------------------------------------


@dataclasses.dataclass
class HostColumn:
    dtype: T.DataType
    values: np.ndarray  # object ndarray of str for strings
    validity: np.ndarray  # bool, True = valid

    def __post_init__(self):
        self.values = np.asarray(self.values)
        self.validity = np.asarray(self.validity, dtype=np.bool_)
        if len(self.values) != len(self.validity):
            raise ValueError(f"{len(self.values)} values but "
                             f"{len(self.validity)} validity flags")

    def __len__(self) -> int:
        return len(self.values)

    @staticmethod
    def from_list(dtype: T.DataType, items: Sequence[Any]) -> "HostColumn":
        if isinstance(items, np.ndarray) and items.dtype != object:
            # dense numpy input has no NULLs: skip the per-row walk (a
            # string column stays a numpy str array, see
            # _string_host_to_buffers)
            values = items if dtype.is_string else \
                items.astype(dtype.np_dtype, copy=False)
            return HostColumn(dtype, values,
                              np.ones(len(items), dtype=np.bool_))
        validity = np.array([x is not None for x in items], dtype=np.bool_)
        if dtype.is_string:
            values = np.array([x if x is not None else "" for x in items],
                              dtype=object)
        else:
            values = np.array([x if x is not None else 0 for x in items],
                              dtype=dtype.np_dtype)
        return HostColumn(dtype, values, validity)

    def to_list(self) -> List[Any]:
        out: List[Any] = []
        for v, ok in zip(self.values, self.validity):
            if not ok:
                out.append(None)
            elif self.dtype.is_string:
                out.append(str(v))
            elif self.dtype == T.BOOLEAN:
                out.append(bool(v))
            elif self.dtype.is_fractional:
                out.append(float(v))
            else:
                out.append(int(v))
        return out


class HostBatch:
    """A host (numpy) table: the staging form between input and device."""

    def __init__(self, schema: T.Schema, columns: Sequence[HostColumn]):
        self.schema = schema
        self.columns = list(columns)
        nrows = {len(c) for c in self.columns}
        if len(nrows) > 1:
            raise ValueError(f"ragged batch: {nrows}")
        self.num_rows = len(self.columns[0]) if self.columns else 0

    @staticmethod
    def from_pydict(data: Dict[str, Tuple[T.DataType, Sequence[Any]]]
                    ) -> "HostBatch":
        fields, cols = [], []
        for name, (dtype, items) in data.items():
            fields.append(T.Field(name, dtype))
            cols.append(HostColumn.from_list(dtype, items))
        return HostBatch(T.Schema(fields), cols)

    def to_pydict(self) -> Dict[str, List[Any]]:
        return {f.name: c.to_list()
                for f, c in zip(self.schema.fields, self.columns)}

    @staticmethod
    def concat(batches: Sequence["HostBatch"]) -> "HostBatch":
        schema = batches[0].schema
        cols = []
        for i, f in enumerate(schema.fields):
            values = np.concatenate([b.columns[i].values for b in batches])
            validity = np.concatenate([b.columns[i].validity
                                       for b in batches])
            cols.append(HostColumn(f.dtype, values, validity))
        return HostBatch(schema, cols)

    def __repr__(self):
        return f"HostBatch({self.schema}, rows={self.num_rows})"


# --------------------------------------------------------------------------
# Device column / batch
# --------------------------------------------------------------------------


class DeviceColumn:
    """One column on the device: data + validity mask (+ string offsets)."""

    def __init__(self, dtype: T.DataType, data: torch.Tensor,
                 validity: torch.Tensor, offsets: torch.Tensor = None):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.offsets = offsets  # strings only: int32[cap+1]

    @property
    def is_varlen(self) -> bool:
        return self.offsets is not None

    def __repr__(self):
        return f"DeviceColumn({self.dtype}, data={tuple(self.data.shape)})"


class ColumnBatch:
    """A device table: columns + device-resident live-row count + capacity.

    ``device`` is the ``torch.device`` every buffer of the batch lives on.
    """

    def __init__(self, schema: T.Schema, columns: Sequence[DeviceColumn],
                 num_rows: torch.Tensor, capacity: int):
        self.schema = schema
        self.columns = tuple(columns)
        self.num_rows = num_rows  # 0-d int32 tensor on the device
        self.capacity = int(capacity)
        self.device = num_rows.device

    def column(self, name: str) -> DeviceColumn:
        return self.columns[self.schema.index_of(name)]

    def __repr__(self):
        return f"ColumnBatch({self.schema}, cap={self.capacity})"


def empty_device_batch(schema: T.Schema, device) -> ColumnBatch:
    """A batch of no rows at the least capacity: zero data, no valid row,
    16 string bytes."""
    capacity = MIN_CAPACITY
    cols = []
    for f in schema.fields:
        validity = torch.zeros(capacity, dtype=torch.bool, device=device)
        if f.dtype.is_string:
            cols.append(DeviceColumn(
                f.dtype, torch.zeros(MIN_BYTE_CAPACITY, dtype=torch.uint8,
                                     device=device), validity,
                torch.zeros(capacity + 1, dtype=torch.int32,
                            device=device)))
        else:
            cols.append(DeviceColumn(
                f.dtype, torch.zeros(capacity, dtype=f.dtype.torch_dtype,
                                     device=device), validity))
    return ColumnBatch(schema, cols, device_scalar(0, device), capacity)


def device_scalar(value: int, device) -> torch.Tensor:
    """0-d int32 tensor made on the device by a fill, not an H2D copy."""
    return torch.full((), int(value), dtype=torch.int32, device=device)


# --------------------------------------------------------------------------
# Host <-> device staging
# --------------------------------------------------------------------------


def _ascii_rows(values: np.ndarray, validity: np.ndarray):
    """(lengths, bytes) of a numpy str array whose characters are all
    ASCII, by numpy alone: each character is its own UTF-8 byte.  None if
    the array is not a str array or holds a non-ASCII character."""
    if values.dtype.kind != "U":
        return None
    n, width = len(values), values.dtype.itemsize // 4
    if width == 0:
        return np.zeros(n, dtype=np.int64), np.zeros(0, dtype=np.uint8)
    codes = np.ascontiguousarray(values).view(np.uint32).reshape(n, width)
    if n and int(codes.max()) >= 128:
        return None
    # numpy pads with NUL: the length runs to the last non-NUL character
    nonzero = codes != 0
    lengths = np.where(nonzero.any(axis=1),
                       width - np.argmax(nonzero[:, ::-1], axis=1), 0)
    lengths = np.where(validity, lengths, 0).astype(np.int64)
    keep = np.arange(width) < lengths[:, None]
    return lengths, codes[keep].astype(np.uint8)


def _string_host_to_buffers(values: np.ndarray, validity: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Encode strings to (offsets int32[n+1], bytes uint8[byte cap]).
    NULL rows are empty.  An all-ASCII numpy str array is encoded by
    numpy without a Python step per row; anything else row by row."""
    ascii_rows = _ascii_rows(values, validity)
    if ascii_rows is not None:
        lengths, raw = ascii_rows
    else:
        encoded = [str(v).encode("utf-8") if ok else b""
                   for v, ok in zip(values, validity)]
        lengths = np.fromiter((len(e) for e in encoded), dtype=np.int64,
                              count=len(encoded))
        raw = np.frombuffer(b"".join(encoded), dtype=np.uint8)
    offsets = np.zeros(len(lengths) + 1, dtype=np.int32)
    np.cumsum(lengths, out=offsets[1:])
    total = int(offsets[-1])
    data = np.zeros(round_up_capacity(max(total, 1), MIN_BYTE_CAPACITY),
                    dtype=np.uint8)
    data[:total] = raw
    return offsets, data


def host_column_to_device(col: HostColumn, capacity: int,
                          device) -> DeviceColumn:
    n = len(col)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} rows")
    validity = np.zeros(capacity, dtype=np.bool_)
    validity[:n] = col.validity

    def put(a):
        return torch.from_numpy(a).to(device)

    if col.dtype.is_string:
        offsets, data = _string_host_to_buffers(col.values, col.validity)
        full_offsets = np.full(capacity + 1, offsets[-1], dtype=np.int32)
        full_offsets[: n + 1] = offsets
        return DeviceColumn(col.dtype, put(data), put(validity),
                            put(full_offsets))
    data = np.zeros(capacity, dtype=col.dtype.np_dtype)
    data[:n] = col.values
    return DeviceColumn(col.dtype, put(data), put(validity))


def host_to_device(batch: HostBatch, device,
                   capacity: int = None) -> ColumnBatch:
    device = torch.device(device)
    cap = capacity if capacity is not None else \
        round_up_capacity(batch.num_rows)
    cols = [host_column_to_device(c, cap, device) for c in batch.columns]
    return ColumnBatch(batch.schema, cols,
                       device_scalar(batch.num_rows, device), cap)


def host_sizes(batches: Sequence[ColumnBatch]
               ) -> List[Tuple[int, List[int]]]:
    """(num_rows, [string byte totals...]) for many batches in ONE host
    sync: every scalar is stacked on the device and fetched by a single
    ``.tolist()``.  String totals read ``offsets[-1]``, valid because
    offsets are constant past ``num_rows``."""
    if not batches:
        return []
    scalars = []
    for b in batches:
        scalars.append(b.num_rows.to(torch.int64))
        scalars.extend(c.offsets[-1].to(torch.int64)
                       for c in b.columns if c.is_varlen)
    flat = torch.stack(scalars).tolist()
    out, i = [], 0
    for b in batches:
        nv = sum(1 for c in b.columns if c.is_varlen)
        out.append((int(flat[i]), [int(t) for t in flat[i + 1:i + 1 + nv]]))
        i += 1 + nv
    return out


def _start_to_host(t: torch.Tensor) -> torch.Tensor:
    """Enqueue a device->host copy; the caller synchronizes once."""
    if t.device.type == "cuda":
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        return out
    return t.clone()


def device_to_host_many(batches: Sequence[ColumnBatch]) -> List[HostBatch]:
    """Bring batches back to numpy: one sizes sync, then every live buffer
    copy enqueued before ONE synchronize."""
    sizes = host_sizes(batches)
    pending = []
    for b, (n, totals) in zip(batches, sizes):
        bufs, si = [], 0
        for c in b.columns:
            if c.is_varlen:
                bufs.append((_start_to_host(c.data[:totals[si]]),
                             _start_to_host(c.validity[:n]),
                             _start_to_host(c.offsets[:n + 1])))
                si += 1
            else:
                bufs.append((_start_to_host(c.data[:n]),
                             _start_to_host(c.validity[:n])))
        pending.append(bufs)
    cuda_devs = {b.device for b in batches if b.device.type == "cuda"}
    for dev in cuda_devs:
        torch.cuda.current_stream(dev).synchronize()
    out = []
    for b, bufs in zip(batches, pending):
        cols = []
        for f, cb in zip(b.schema.fields, bufs):
            validity = cb[1].numpy()
            if f.dtype.is_string:
                raw = cb[0].numpy().tobytes()
                offsets = cb[2].numpy()
                values = np.empty(len(validity), dtype=object)
                for i in range(len(validity)):
                    values[i] = raw[offsets[i]:offsets[i + 1]].decode(
                        "utf-8", errors="replace")
                cols.append(HostColumn(f.dtype, values, validity))
            else:
                cols.append(HostColumn(f.dtype, cb[0].numpy(), validity))
        out.append(HostBatch(b.schema, cols))
    return out


def device_to_host(batch: ColumnBatch) -> HostBatch:
    return device_to_host_many([batch])[0]
