"""A host batch as one framed byte buffer: the wire format of the JAX
package's ``native_rt.serialize_host_batch``/``deserialize_host_batch``
(its Python form, ``native_rt.py:112`` on), so the port's bytes for a
:class:`HostBatch` equal the JAX package's::

    header:     "<IIIQ"  magic 0x54505542, version 1, columns, rows
    per column: "<BBQQQ" type code, has offsets, data, validity and
                offsets lengths; then the data bytes, the validity (a
                byte a row) and the int32 offsets, each padded to 8 bytes

Type codes are the positions in ``types.ALL_TYPES``.  A string column is
its UTF-8 bytes with NULL rows empty.  An array column, which the JAX
format has no code for, is written with code 255: its element bytes and
int32 element offsets.  A deserialized string column comes back as bytes
and offsets (no Python step a row).
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import HostBatch, HostColumn, string_column

_MAGIC = 0x54505542
_HEADER = struct.Struct("<IIIQ")
_COLUMN = struct.Struct("<BBQQQ")
ARRAY_TYPE_CODE = 255
_TYPE_CODES = {t: i for i, t in enumerate(T.ALL_TYPES)}


def _string_buffers(col: HostColumn):
    if col.offsets is not None:
        c = string_column(col.dtype, col.values, col.offsets, col.validity)
        return c.values[:int(c.offsets[-1])], c.offsets
    encoded = [str(v).encode("utf-8") if ok else b""
               for v, ok in zip(col.values, col.validity)]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int32)
    np.cumsum(np.fromiter((len(e) for e in encoded), dtype=np.int64,
                          count=len(encoded)), out=offsets[1:])
    return np.frombuffer(b"".join(encoded), dtype=np.uint8), offsets


def _array_buffers(col: HostColumn):
    lists = [v if ok else [] for v, ok in zip(col.values, col.validity)]
    offsets = np.zeros(len(lists) + 1, dtype=np.int32)
    np.cumsum(np.fromiter((len(x) for x in lists), dtype=np.int64,
                          count=len(lists)), out=offsets[1:])
    data = np.asarray([e for x in lists for e in x],
                      dtype=col.dtype.element.np_dtype)
    return data, offsets


def _column_parts(f: T.Field, col: HostColumn):
    """(type code, data, validity, offsets or None) as byte views."""
    if f.dtype.is_string:
        data, offsets = _string_buffers(col)
        code = _TYPE_CODES[f.dtype]
    elif f.dtype.is_array:
        data, offsets = _array_buffers(col)
        code = ARRAY_TYPE_CODE
    else:
        data = np.ascontiguousarray(col.values, dtype=f.dtype.np_dtype)
        offsets, code = None, _TYPE_CODES[f.dtype]
    validity = np.ascontiguousarray(col.validity).view(np.uint8)
    return (code, memoryview(np.ascontiguousarray(data)).cast("B"),
            memoryview(validity).cast("B"),
            None if offsets is None else memoryview(
                np.ascontiguousarray(offsets, dtype=np.int32)).cast("B"))


def serialize_host_batch(hb: HostBatch) -> bytes:
    """HostBatch -> one contiguous framed buffer."""
    out: List = [_HEADER.pack(_MAGIC, 1, len(hb.columns), hb.num_rows)]
    pos = _HEADER.size

    def pad():
        nonlocal pos
        extra = (-pos) % 8
        if extra:
            out.append(b"\0" * extra)
            pos += extra

    for f, c in zip(hb.schema.fields, hb.columns):
        code, d, v, o = _column_parts(f, c)
        olen = 0 if o is None else o.nbytes
        out.append(_COLUMN.pack(code, 1 if olen else 0, d.nbytes, v.nbytes,
                                olen))
        pos += _COLUMN.size
        pad()
        for b in (d, v, o):
            if b is not None:
                out.append(b)
                pos += b.nbytes
            pad()
    return b"".join(out)


def deserialize_host_batch(buf, schema: T.Schema) -> HostBatch:
    """Framed buffer -> HostBatch; string columns as bytes and offsets.
    The columns are read-only views into ``buf``."""
    view = memoryview(buf)
    magic, _version, n, n_rows = _HEADER.unpack_from(view, 0)
    if magic != _MAGIC or n != len(schema.fields):
        raise ValueError("not a serialized host batch of this schema")
    pos = _HEADER.size
    cols = []
    for f in schema.fields:
        _code, _has_o, dl, vl, ol = _COLUMN.unpack_from(view, pos)
        pos += _COLUMN.size
        pos += (-pos) % 8
        data = np.frombuffer(view, dtype=np.uint8, count=dl, offset=pos)
        pos += dl + ((-dl) % 8)
        validity = np.frombuffer(view, dtype=np.uint8, count=vl,
                                 offset=pos).astype(np.bool_)
        pos += vl + ((-vl) % 8)
        offsets = np.frombuffer(view, dtype=np.int32, count=ol // 4,
                                offset=pos) if ol else None
        pos += ol + ((-ol) % 8)
        if f.dtype.is_string:
            cols.append(HostColumn(f.dtype, data, validity, offsets))
        elif f.dtype.is_array:
            elems = data.view(f.dtype.element.np_dtype)
            values = np.empty(int(n_rows), dtype=object)
            for r in range(int(n_rows)):
                values[r] = elems[offsets[r]:offsets[r + 1]].tolist()
            cols.append(HostColumn(f.dtype, values, validity))
        else:
            cols.append(HostColumn(f.dtype, data.view(f.dtype.np_dtype),
                                   validity))
    return HostBatch(schema, cols)
