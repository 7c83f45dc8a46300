"""Columnar batch model: host (numpy) batches and device (torch) batches.

Port of ``spark_rapids_tpu/batch.py``.  The layout is the JAX package's:

* every device batch is padded to a power-of-two ``capacity`` and carries its
  live row count ``num_rows`` as a 0-d int32 tensor ON the device, so no
  operator needs the host to learn how many rows survived a filter;
* every column has a bool validity mask (True = valid); NULL semantics live in
  the expressions, not in sentinel values;
* strings are int32 ``offsets[capacity+1]`` into a flat uint8 byte buffer
  (itself padded to a power of two), offsets constant past ``num_rows``;
  an array column has the same layout over its flat element buffer
  (:func:`_array_host_to_buffers`), and on the host one list a row.

A host string column comes in one of two forms: one Python/numpy string a
row, or, as Arrow and the file scans hand it over, the UTF-8 byte buffer
with int32 offsets from 0 (:func:`string_column`); the second stages with
no Python step a row.  Staging onto a CUDA device goes through pinned host
buffers with non-blocking copies, on the caller's current stream.

Host syncs are explicit: :func:`host_sizes` fetches every row count and
string byte total the caller needs in ONE ``.tolist()`` of a stacked tensor,
and :func:`device_to_host_many` issues every copy before one synchronize.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
    #: one value a row (an object or numpy str array for strings), or,
    #: when ``offsets`` is set, a string column's UTF-8 bytes (uint8)
    values: np.ndarray
    validity: np.ndarray  # bool, True = valid
    #: a string column as Arrow holds it: int32 ``offsets[n+1]`` from 0
    #: into ``values``, NULL rows empty (see :func:`string_column`)
    offsets: Optional[np.ndarray] = None

    def __post_init__(self):
        self.values = np.asarray(self.values)
        self.validity = np.asarray(self.validity, dtype=np.bool_)
        if self.offsets is not None:
            if len(self.offsets) != len(self.validity) + 1:
                raise ValueError(f"{len(self.offsets)} offsets for "
                                 f"{len(self.validity)} rows")
        elif len(self.values) != len(self.validity):
            raise ValueError(f"{len(self.values)} values but "
                             f"{len(self.validity)} validity flags")

    def __len__(self) -> int:
        return len(self.validity)

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
        elif dtype.is_array:
            values = np.empty(len(items), dtype=object)
            for i, x in enumerate(items):
                values[i] = list(x) if x is not None else []
        else:
            values = np.array([x if x is not None else 0 for x in items],
                              dtype=dtype.np_dtype)
        return HostColumn(dtype, values, validity)

    def string_values(self) -> np.ndarray:
        """A string column one value a row (decoded from its bytes when it
        is held as bytes and offsets; NULL rows empty)."""
        if self.offsets is None:
            return self.values
        raw = self.values.tobytes()
        offs = self.offsets.tolist()
        out = np.empty(len(self), dtype=object)
        for i in range(len(self)):
            out[i] = raw[offs[i]:offs[i + 1]].decode("utf-8")
        return out

    def slice(self, start: int, length: int) -> "HostColumn":
        """Rows ``[start, start + length)``; a bytes-and-offsets column
        keeps its form, offsets rebased to 0."""
        validity = self.validity[start:start + length]
        if self.offsets is None:
            return HostColumn(self.dtype, self.values[start:start + length],
                              validity)
        offs = self.offsets[start:start + len(validity) + 1]
        return HostColumn(self.dtype, self.values[offs[0]:offs[-1]],
                          validity, offs - offs[0])

    def take(self, index: np.ndarray) -> "HostColumn":
        """Rows ``index`` in that order; a bytes-and-offsets column keeps
        its form (one gather of the bytes)."""
        index = np.asarray(index, dtype=np.int64)
        validity = self.validity[index]
        if self.offsets is None:
            return HostColumn(self.dtype, self.values[index], validity)
        starts = self.offsets[:-1].astype(np.int64)[index]
        lengths = self.offsets[1:].astype(np.int64)[index] - starts
        offsets = np.zeros(len(index) + 1, dtype=np.int32)
        np.cumsum(lengths, out=offsets[1:])
        shift = np.repeat(starts - offsets[:-1], lengths)
        data = self.values[np.arange(int(offsets[-1]), dtype=np.int64) +
                           shift]
        return HostColumn(self.dtype, data, validity, offsets)

    def to_list(self) -> List[Any]:
        out: List[Any] = []
        values = self.string_values() if self.dtype.is_string else \
            self.values
        for v, ok in zip(values, self.validity):
            if not ok:
                out.append(None)
            elif self.dtype.is_string:
                out.append(str(v))
            elif self.dtype.is_array:
                out.append([element_value(self.dtype.element, e) for e in v])
            elif self.dtype == T.BOOLEAN:
                out.append(bool(v))
            elif self.dtype.is_fractional:
                out.append(float(v))
            else:
                out.append(int(v))
        return out


def element_value(dtype: T.DataType, v):
    """One array element as Python gives it (None for an element NULL,
    which only the host holds)."""
    if v is None:
        return None
    if dtype.is_string:
        return str(v)
    if dtype == T.BOOLEAN:
        return bool(v)
    if dtype.is_fractional:
        return float(v)
    return int(v)


def string_column(dtype: T.DataType, data, offsets,
                  validity) -> HostColumn:
    """A string :class:`HostColumn` over a UTF-8 byte buffer and its
    offsets, as Arrow holds a string array: offsets of any integer width
    and any start (a sliced array's) are rebased to int32 from 0, and a
    NULL row that owns bytes (Arrow allows it) is made empty, since the
    device layout gives a NULL row none.  Columns past 2^31 - 1 bytes are
    refused."""
    data = np.asarray(data, dtype=np.uint8)
    offsets = np.asarray(offsets)
    validity = np.asarray(validity, dtype=np.bool_)
    base, end = int(offsets[0]), int(offsets[-1])
    if end - base > np.iinfo(np.int32).max:
        raise ValueError(f"a string column of {end - base} bytes does not "
                         "fit int32 offsets")
    offs = (offsets - base).astype(np.int32)
    data = data[base:end]
    lengths = np.diff(offs)
    if not validity.all() and lengths[~validity].any():
        starts = offs[:-1]
        lengths = np.where(validity, lengths, 0)
        new = np.zeros(len(offs), dtype=np.int32)
        np.cumsum(lengths, out=new[1:])
        # byte j of row r comes from old_start[r] + (j - new_start[r])
        shift = np.repeat((starts - new[:-1]).astype(np.int64), lengths)
        data = data[np.arange(int(new[-1]), dtype=np.int64) + shift]
        offs = new
    return HostColumn(dtype, data, validity, offs)


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

    def column(self, name: str) -> HostColumn:
        return self.columns[self.schema.index_of(name)]

    def to_pydict(self) -> Dict[str, List[Any]]:
        return {f.name: c.to_list()
                for f, c in zip(self.schema.fields, self.columns)}

    def slice(self, start: int, length: int) -> "HostBatch":
        return HostBatch(self.schema, [c.slice(start, length)
                                       for c in self.columns])

    @staticmethod
    def concat(batches: Sequence["HostBatch"]) -> "HostBatch":
        schema = batches[0].schema
        cols = []
        for i, f in enumerate(schema.fields):
            parts = [b.columns[i] for b in batches]
            validity = np.concatenate([p.validity for p in parts])
            if all(p.offsets is not None for p in parts):
                ends = np.cumsum([0] + [int(p.offsets[-1]) for p in parts])
                offsets = np.concatenate(
                    [np.zeros(1, np.int64)] +
                    [p.offsets[1:].astype(np.int64) + e
                     for p, e in zip(parts, ends)])
                cols.append(string_column(
                    f.dtype, np.concatenate([p.values[:p.offsets[-1]]
                                             for p in parts]),
                    offsets, validity))
                continue
            values = np.concatenate([
                p.string_values() if p.offsets is not None else p.values
                for p in parts])
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
        if f.dtype.is_string or f.dtype.is_array:
            elem = torch.uint8 if f.dtype.is_string else \
                f.dtype.element.torch_dtype
            cols.append(DeviceColumn(
                f.dtype, torch.zeros(MIN_BYTE_CAPACITY, dtype=elem,
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


def _array_host_to_buffers(dtype: T.ArrayType, values: np.ndarray,
                           validity: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Encode one list a row to (offsets int32[n+1], flat elements padded
    to a power of two), the varlen layout strings use; a NULL row is
    empty.  Element NULLs and array<string> have no device layout."""
    if dtype.element.is_string:
        raise NotImplementedError("array<string> has no device layout; "
                                  "such columns stay on the host")
    lists = [v if ok else [] for v, ok in zip(values, validity)]
    if any(e is None for x in lists for e in x):
        raise NotImplementedError("array element NULLs have no device "
                                  "layout; such columns stay on the host")
    lengths = np.fromiter((len(x) for x in lists), dtype=np.int64,
                          count=len(lists))
    offsets = np.zeros(len(lists) + 1, dtype=np.int32)
    np.cumsum(lengths, out=offsets[1:])
    total = int(offsets[-1])
    data = np.zeros(round_up_capacity(max(total, 1), MIN_BYTE_CAPACITY),
                    dtype=dtype.element.np_dtype)
    if total:
        data[:total] = np.asarray([e for x in lists for e in x],
                                  dtype=dtype.element.np_dtype)
    return offsets, data


@functools.lru_cache(maxsize=None)
def _torch_dtype(np_dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


def _stage(head: np.ndarray, size: int, np_dtype, fill, device
           ) -> torch.Tensor:
    """One device buffer of ``size`` elements: ``head``, then ``fill``.
    For a CUDA device it is written into pinned host memory and copied
    with ``non_blocking`` on the current stream (the pinned block is not
    handed out again before that copy ends); for the CPU a numpy buffer
    is wrapped as it is."""
    n = len(head)
    if device.type == "cuda":
        host = torch.empty(size, dtype=_torch_dtype(np.dtype(np_dtype)),
                           pin_memory=True)
        buf = host.numpy()
        buf[:n] = head
        buf[n:] = fill
        return host.to(device, non_blocking=True)
    buf = np.full(size, fill, dtype=np_dtype)
    buf[:n] = head
    return torch.from_numpy(buf).to(device)


def host_column_to_device(col: HostColumn, capacity: int,
                          device) -> DeviceColumn:
    n = len(col)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} rows")
    device = torch.device(device)
    validity = _stage(col.validity, capacity, np.bool_, False, device)
    if col.dtype.is_string:
        if col.offsets is not None:
            offsets = col.offsets
            total = int(offsets[-1])
            data = _stage(col.values[:total],
                          round_up_capacity(max(total, 1),
                                            MIN_BYTE_CAPACITY),
                          np.uint8, 0, device)
        else:
            offsets, raw = _string_host_to_buffers(col.values, col.validity)
            data = _stage(raw, len(raw), np.uint8, 0, device)
        full = _stage(offsets, capacity + 1, np.int32, offsets[-1], device)
        return DeviceColumn(col.dtype, data, validity, full)
    if col.dtype.is_array:
        offsets, raw = _array_host_to_buffers(col.dtype, col.values,
                                              col.validity)
        data = _stage(raw, len(raw), raw.dtype, 0, device)
        full = _stage(offsets, capacity + 1, np.int32, offsets[-1], device)
        return DeviceColumn(col.dtype, data, validity, full)
    data = _stage(col.values, capacity, col.dtype.np_dtype, 0, device)
    return DeviceColumn(col.dtype, data, validity)


def host_to_device(batch: HostBatch, device,
                   capacity: int = None) -> ColumnBatch:
    device = torch.device(device)
    cap = capacity if capacity is not None else \
        round_up_capacity(batch.num_rows)
    cols = [host_column_to_device(c, cap, device) for c in batch.columns]
    return ColumnBatch(batch.schema, cols,
                       device_scalar(batch.num_rows, device), cap)


def host_batch_bytes(hb: HostBatch) -> int:
    """Host bytes a :class:`HostBatch` holds: each column's values and
    validity; a string column its UTF-8 bytes plus a byte a row (the JAX
    package counts characters there, which differ on non-ASCII text)."""
    total = 0
    for c in hb.columns:
        if c.dtype.is_array:
            total += sum(len(x) for x in c.values) * int(np.dtype(
                c.dtype.element.np_dtype).itemsize) + len(c)
        elif c.dtype.is_string:
            total += (int(c.offsets[-1]) if c.offsets is not None else
                      sum(len(str(x).encode("utf-8")) for x in c.values)) \
                + len(c)
        else:
            total += c.values.nbytes
        total += c.validity.nbytes
    return total


def host_sizes(batches: Sequence[ColumnBatch]
               ) -> List[Tuple[int, List[int]]]:
    """(num_rows, [string byte totals...]) for many batches in ONE host
    sync: every scalar is stacked on the device and fetched by a single
    ``.tolist()``.  String totals read ``offsets[-1]``, valid because
    offsets are constant past ``num_rows``; an array column's total is
    its element count, in the same list."""
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


def device_to_host_many(batches: Sequence[ColumnBatch],
                        keep_offsets: bool = False) -> List[HostBatch]:
    """Bring batches back to numpy: one sizes sync, then every live buffer
    copy enqueued before ONE synchronize.  A string column comes back one
    ``str`` a row, or, with ``keep_offsets``, as its bytes and offsets
    (no Python step a row)."""
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
            if f.dtype.is_string and keep_offsets:
                cols.append(HostColumn(f.dtype, cb[0].numpy(), validity,
                                       cb[2].numpy().copy()))
            elif f.dtype.is_array:
                data, offsets = cb[0].numpy(), cb[2].numpy()
                values = np.empty(len(validity), dtype=object)
                if len(validity):
                    for i, seg in enumerate(np.split(
                            data[:offsets[-1]], offsets[1:-1])):
                        values[i] = seg.tolist()
                cols.append(HostColumn(f.dtype, values, validity))
            elif f.dtype.is_string:
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


def fixed_row_bytes(schema: T.Schema) -> int:
    """Bytes per row of a schema's fixed-width buffers as the device holds
    them: data item size plus a validity byte a column; a varlen column
    its 4-byte offset and validity byte (its elements are counted from
    its offsets).  The shuffle split's piece sizes, which the adaptive
    layer reads, are these plus the elements' bytes."""
    total = 0
    for f in schema.fields:
        if f.dtype.is_string or f.dtype.is_array:
            total += 5
        else:
            total += int(np.dtype(f.dtype.np_dtype).itemsize) + 1
    return total


def varlen_byte_scales(schema: T.Schema) -> List[int]:
    """Bytes per element of each varlen column, in column order: 1 for a
    string, the element's item size for an array."""
    return [1 if f.dtype.is_string else
            int(np.dtype(f.dtype.element.np_dtype).itemsize)
            for f in schema.fields if f.dtype.is_string or f.dtype.is_array]
