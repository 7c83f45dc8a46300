"""Multi-column sort over a ColumnBatch (port of
``spark_rapids_tpu/kernels/sort.py``).  String keys sort by their prefix
words then (length, h1, h2); the batch's string columns move through
:func:`gather_rows` with their bytes."""

from __future__ import annotations

from typing import List

from spark_rapids_tpu_torch.batch import ColumnBatch
from spark_rapids_tpu_torch.exprs.base import DevVal
from spark_rapids_tpu_torch.kernels.layout import gather_rows
from spark_rapids_tpu_torch.kernels.sortkeys import (
    argsort_by_words, encode_sort_keys,
)


def argsort_batch(key_vals: List[DevVal], ascendings: List[bool],
                  nulls_firsts: List[bool], num_rows, groupings=None,
                  hashes=None):
    """Stable permutation sorting rows by the evaluated key columns.
    ``groupings`` marks keys that only need equal values adjacent, and
    ``hashes`` may carry the string keys' hashes (see
    :func:`encode_sort_keys`)."""
    cap = int(key_vals[0].validity.shape[0])
    words = encode_sort_keys(key_vals, ascendings, nulls_firsts, num_rows,
                             groupings=groupings, hashes=hashes)
    return argsort_by_words(words, cap)


def sort_batch(batch: ColumnBatch, key_vals: List[DevVal],
               ascendings: List[bool], nulls_firsts: List[bool]
               ) -> ColumnBatch:
    perm = argsort_batch(key_vals, ascendings, nulls_firsts, batch.num_rows)
    return gather_rows(batch, perm, batch.num_rows)
