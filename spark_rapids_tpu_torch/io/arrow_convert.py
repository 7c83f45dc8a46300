"""Arrow -> HostBatch conversion (port of
``spark_rapids_tpu/io/arrow_convert.py``).

Unlike the JAX package, a string column is never held one Python ``str`` a
row: Arrow keeps it as int32 offsets into a UTF-8 byte buffer, which is
the device layout, so the column is handed over as those two buffers
(:func:`spark_rapids_tpu_torch.batch.string_column`) and staged with no
Python step a row.  Dictionary arrays are always decoded: the port's scan
never keeps strings encoded.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import pyarrow as pa

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import HostBatch, HostColumn, string_column

_ARROW_TO_TYPE = {
    pa.bool_(): T.BOOLEAN,
    pa.int8(): T.BYTE,
    pa.int16(): T.SHORT,
    pa.int32(): T.INT,
    pa.int64(): T.LONG,
    pa.float32(): T.FLOAT,
    pa.float64(): T.DOUBLE,
    pa.date32(): T.DATE,
    pa.string(): T.STRING,
    pa.large_string(): T.STRING,
}


def arrow_type_to_sql(at: pa.DataType) -> T.DataType:
    if at in _ARROW_TO_TYPE:
        return _ARROW_TO_TYPE[at]
    if pa.types.is_timestamp(at):
        return T.TIMESTAMP
    if pa.types.is_dictionary(at):
        return arrow_type_to_sql(at.value_type)
    raise TypeError(f"unsupported arrow type {at}")


def sql_type_to_arrow(dt: T.DataType) -> pa.DataType:
    for a, s in _ARROW_TO_TYPE.items():
        if s == dt and a != pa.large_string():
            return a
    if dt == T.TIMESTAMP:
        return pa.timestamp("us", tz="UTC")
    raise TypeError(f"unsupported sql type {dt}")


def schema_from_arrow(asch: pa.Schema) -> T.Schema:
    return T.Schema([
        T.Field(f.name, arrow_type_to_sql(f.type), f.nullable)
        for f in asch
    ])


def _string_host_column(f: T.Field, arr: pa.Array,
                        validity: np.ndarray) -> HostColumn:
    """The offsets and bytes of a string array, read in place (a sliced
    array's window of them); int64 offsets are taken down to int32 and a
    column past 2^31 - 1 bytes is refused by name."""
    if not (pa.types.is_string(arr.type) or
            pa.types.is_large_string(arr.type)):
        arr = arr.cast(pa.string())
    n = len(arr)
    if n == 0:
        return HostColumn(f.dtype, np.zeros(0, np.uint8), validity,
                          np.zeros(1, np.int32))
    width = np.int64 if pa.types.is_large_string(arr.type) else np.int32
    _, off_buf, data_buf = arr.buffers()
    offsets = np.frombuffer(off_buf, dtype=width)[arr.offset:
                                                  arr.offset + n + 1]
    data = np.zeros(0, np.uint8) if data_buf is None else \
        np.frombuffer(data_buf, dtype=np.uint8)
    try:
        return string_column(f.dtype, data, offsets, validity)
    except ValueError as e:
        raise ValueError(f"column {f.name}: {e}") from None


def arrow_to_host_batch(table_or_batch,
                        schema: Optional[T.Schema] = None) -> HostBatch:
    tb = table_or_batch
    if isinstance(tb, pa.Table):
        tb = tb.combine_chunks()
    if schema is None:
        schema = schema_from_arrow(tb.schema)
    cols: List[HostColumn] = []
    for f, name in zip(schema.fields, tb.schema.names):
        arr = tb.column(name)
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks() if arr.num_chunks != 1 else \
                arr.chunk(0)
        if pa.types.is_dictionary(arr.type):
            arr = arr.dictionary_decode()
        null_free = arr.null_count == 0
        # null-free columns skip the bit-unpacking is_valid() pass
        validity = np.ones(len(arr), dtype=np.bool_) if null_free \
            else np.asarray(arr.is_valid())
        if f.dtype.is_string:
            cols.append(_string_host_column(f, arr, validity))
            continue
        if f.dtype == T.TIMESTAMP:
            arr2 = arr.cast(pa.timestamp("us"))
            values = np.nan_to_num(
                arr2.to_numpy(zero_copy_only=False)).astype(
                "datetime64[us]").astype(np.int64)
            values = np.where(validity, values, 0).astype(np.int64)
        else:
            values = None
            if null_free:
                # zero-copy view over the arrow buffer for contiguous
                # null-free numerics (bit-packed bools and anything
                # non-contiguous raise and take the copy below)
                try:
                    values = arr.to_numpy(zero_copy_only=True)
                except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
                    values = None
            if values is None:
                values = arr.to_numpy(zero_copy_only=False)
            if values.dtype.kind == "f" and not f.dtype.is_fractional:
                # arrow promotes nullable ints to float NaN; undo it
                values = np.where(validity, np.nan_to_num(values), 0)
            values = values.astype(f.dtype.np_dtype, copy=False)
        cols.append(HostColumn(f.dtype, values, validity))
    return HostBatch(schema, cols)
