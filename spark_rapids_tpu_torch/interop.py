"""Carrying a table across from plain numpy.

In this system the table and its batches play the part a model's weights
play elsewhere: the tests read the arrays off a JAX-package ``HostBatch``
and hand the same arrays to both packages, so both compute on one table.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import HostBatch, HostColumn


def host_batch_from_numpy(fields: Sequence, columns: Sequence) -> HostBatch:
    """Build a :class:`HostBatch` from plain numpy.

    ``fields``: ``(name, type)`` pairs, the type a :class:`T.DataType` or
    its name (``"int"``, ``"bigint"``, ``"double"``, ``"string"``...).
    ``columns``: one ``(data, validity)`` or ``(data, validity, offsets)``
    tuple per field.  Fixed-width data is one value per row (any value
    under a NULL); string data is the flat UTF-8 byte buffer with int32
    ``offsets[n+1]``."""
    out_fields, cols = [], []
    for (name, dtype), col in zip(fields, columns):
        if isinstance(dtype, str):
            dtype = T.type_from_name(dtype)
        data, validity = np.asarray(col[0]), np.asarray(col[1], np.bool_)
        if dtype.is_string:
            offsets = np.asarray(col[2], dtype=np.int64)
            raw = data.astype(np.uint8).tobytes()
            values = np.array(
                [raw[offsets[i]:offsets[i + 1]].decode("utf-8") if ok else ""
                 for i, ok in enumerate(validity)], dtype=object)
        else:
            values = data.astype(dtype.np_dtype)
        out_fields.append(T.Field(name, dtype))
        cols.append(HostColumn(dtype, values, validity))
    return HostBatch(T.Schema(out_fields), cols)


def host_batches(data: Dict, batch_rows: int) -> List[HostBatch]:
    """Cut a generator's table (``{name: (type, values)}``, as
    :mod:`spark_rapids_tpu_torch.benchmarks.datagen` returns it) into host
    batches of ``batch_rows`` rows, the size a scan hands over."""
    n = len(next(iter(data.values()))[1])
    cols = {k: (t, np.asarray(v)) for k, (t, v) in data.items()}
    return [HostBatch.from_pydict({k: (t, v[s:s + batch_rows])
                                   for k, (t, v) in cols.items()})
            for s in range(0, n, batch_rows)]
