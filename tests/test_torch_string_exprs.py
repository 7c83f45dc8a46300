"""PyTorch port: string expressions, string gathers and string sort words
against the JAX package.

* the string predicates: ``LIKE`` with each of its five plans (exact by
  row hashes, prefix, suffix, contains, prefix and suffix) and ``%``,
  ``startswith``, ``endswith``, ``contains``; string literals;
* string gathers and filter compaction, raw device buffers equal (dead
  lanes and the zero fill past the live bytes too);
* sort words with and without grouping, the stable order they give, and
  the adjacent-key equality the sort-based groupby cuts groups with.

Every comparison is exact: these functions hash, compare or move bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.batch import host_to_device as jax_h2d
from spark_rapids_tpu.exprs import strings as JS
from spark_rapids_tpu.exprs.base import ColumnRef as JaxColumnRef
from spark_rapids_tpu.exprs.base import DevVal as JaxDevVal
from spark_rapids_tpu.exprs.base import TpuEvalCtx
from spark_rapids_tpu.kernels import groupby as JG
from spark_rapids_tpu.kernels import layout as JL
from spark_rapids_tpu.kernels import sortkeys as JSK

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import host_to_device
from spark_rapids_tpu_torch.exprs import strings as PS
from spark_rapids_tpu_torch.exprs.base import (
    ColumnRef, DevVal, GpuEvalCtx, Literal,
)
from spark_rapids_tpu_torch.kernels import cuda_tier
from spark_rapids_tpu_torch.kernels import groupby as G
from spark_rapids_tpu_torch.kernels import layout as L
from spark_rapids_tpu_torch.kernels import sortkeys as SK

from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    assert_device_bits, one_torch_thread, port_host_batch,
)

STRS = {
    "s": (JT.STRING, ["bb", "", None, "apple", "bb", "zed", "é中",
                      "a" * 70, None, "apple" * 13 + "x", "apple" * 13]),
    "i": (JT.INT, [3, None, 7, 1, 7, None, 0, 2, 2, 5, 5]),
}


def _both(pydict, num_rows=None):
    jb = JaxHostBatch.from_pydict(pydict)
    jdev, pdev = jax_h2d(jb), host_to_device(port_host_batch(jb), "cpu")
    if num_rows is not None:
        jdev, pdev = JL.take_head(jdev, num_rows), L.take_head(pdev, num_rows)
    return jdev, pdev


@pytest.mark.parametrize("num_rows", [0, 6, 11])
def test_string_compact_matches_jax(num_rows):
    jdev, pdev = _both(STRS, num_rows=num_rows)
    mask = np.array([True, False, True, True, False, True, True, True,
                     True, False, True, False, True, False, True, True])
    assert_device_bits(jax.jit(JL.compact)(jdev, jnp.asarray(mask)),
                       L.compact(pdev, torch.from_numpy(mask)))


def test_string_gather_matches_jax():
    """A permutation with repeats, a smaller output capacity and byte
    capacity (the shrink of a sparse batch), and the default caps."""
    jdev, pdev = _both(STRS)
    perm = np.array([9, 3, 3, 0, 7, 1, 10, 2], dtype=np.int32)
    for idx, kw in ((np.tile(perm, 2), {}),
                    (perm, {"out_capacity": 8, "out_byte_caps": [256]})):
        want = jax.jit(lambda b, i: JL.gather_rows(b, i, 7, **kw))(
            jdev, jnp.asarray(idx))
        got = L.gather_rows(pdev, torch.from_numpy(idx), 7, **kw)
        assert_device_bits(want, got)


@pytest.mark.parametrize("chunk", [16, 100, 255])
def test_string_gather_in_byte_chunks_matches_jax(monkeypatch, chunk):
    """A gather whose output bytes pass ``GATHER_BYTES_CHUNK`` resolves
    them a chunk at a time (a join's wide output): the same bits."""
    monkeypatch.setattr(L, "GATHER_BYTES_CHUNK", chunk)
    jdev, pdev = _both(STRS)
    idx = np.tile(np.array([9, 3, 3, 0, 7, 1, 10, 2], dtype=np.int32), 2)
    kw = {"out_capacity": 16, "out_byte_caps": [1024]}
    want = jax.jit(lambda b, i: JL.gather_rows(b, i, 13, **kw))(
        jdev, jnp.asarray(idx))
    assert_device_bits(want, L.gather_rows(pdev, torch.from_numpy(idx), 13,
                                           **kw))


def _vals(jdev, pdev, names):
    jv = [JaxDevVal.from_column(jdev.column(n)) for n in names]
    pv = [DevVal.from_column(pdev.column(n)) for n in names]
    return jv, pv


@pytest.mark.parametrize("groupings,asc,nf", [
    (None, [True, True], [True, True]),
    (None, [False, True], [False, True]),
    ([True, True], [True, True], [True, True]),
], ids=["order", "desc-nulls-last", "grouping"])
def test_string_sort_words_match_jax(groupings, asc, nf):
    jdev, pdev = _both(STRS, num_rows=9)
    jv, pv = _vals(jdev, pdev, ["s", "i"])
    want = jax.jit(lambda v, n: JSK.encode_sort_keys(
        v, asc, nf, n, groupings=groupings))(jv, jdev.num_rows)
    got = SK.encode_sort_keys(pv, asc, nf, pdev.num_rows,
                              groupings=groupings)
    assert len(got) == len(want) == (21 if groupings is None else 5) + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(jax.device_get(w)).astype(np.int64))
    n = int(pdev.num_rows)
    perm = SK.argsort_by_words(got, pdev.capacity)[:n].numpy()
    jperm = np.asarray(JSK.argsort_by_words(want, jdev.capacity))[:n]
    np.testing.assert_array_equal(perm, jperm)


def test_string_keys_equal_prev_matches_jax():
    rows = ["bb", "bb", "", "", None, None, "apple" * 13 + "x",
            "apple" * 13 + "x", "apple" * 13 + "y", "é", "é"]
    jdev, pdev = _both({"s": (JT.STRING, rows),
                        "i": (JT.INT, [1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4])})
    jv, pv = _vals(jdev, pdev, ["s", "i"])
    want = np.asarray(jax.device_get(JSK.keys_equal_prev(jv)))
    got = SK.keys_equal_prev(pv, SK.string_key_hashes(pv))
    np.testing.assert_array_equal(got.numpy(), want)


SEGMENT_FIELDS = ("perm", "seg_ids", "seg_start", "num_groups", "live")
# one compiled program for every case of the same capacity
_jax_segments = jax.jit(lambda v, n: [getattr(JG.group_segments(v, n), f)
                                      for f in SEGMENT_FIELDS])


@pytest.mark.parametrize("num_rows", [11, 8])
def test_group_segments_reusing_hashes_matches_jax(num_rows, monkeypatch):
    """The group sort hashes its string keys once, for the sort, and its
    adjacent-key test takes those hashes moved by the permutation: the
    segments equal the JAX package's, which hashes the sorted bytes again.
    String keys with NULLs, duplicates, a long shared prefix and dead rows
    (num_rows 8 of 11, the tail's keys left in place)."""
    rows = ["bb", "bb", "", None, "apple" * 13 + "x", None, "é",
            "apple" * 13 + "y", "bb", "é", "apple" * 13 + "x"]
    jdev, pdev = _both({"s": (JT.STRING, rows),
                        "t": (JT.STRING, ["x", "y", "x", "x", None, "x",
                                          "y", "x", "x", "y", "x"]),
                        "i": (JT.INT, [1, 1, 1, 2, 2, 2, 3, 3, 1, 3, 2])},
                       num_rows=num_rows)
    jv, pv = _vals(jdev, pdev, ["s", "i", "t"])
    calls = []
    real = cuda_tier.string_hash_columns
    monkeypatch.setattr(cuda_tier, "string_hash_columns",
                        lambda cols: calls.append(len(cols)) or real(cols))
    got = G.group_segments(pv, pdev.num_rows)
    assert calls == [2]  # one call, both string keys
    want = _jax_segments(jv, jdev.num_rows)
    for field, w in zip(SEGMENT_FIELDS, want):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(jax.device_get(w)),
                                      err_msg=field)


def test_string_literal_column():
    _, pdev = _both(STRS)
    v = Literal("ab").gpu_eval(GpuEvalCtx(pdev))
    assert v.offsets.tolist() == [2 * i for i in range(17)]
    assert bytes(v.data.numpy()) == b"ab" * 16
    assert Literal(None, T.STRING).gpu_eval(GpuEvalCtx(pdev)).offsets.sum() \
        == 0



LIKE_ROWS = ["green", "greenish", "evergreen", "gr een", "", None,
             "g\u00e9n", "lemon green navy", "gn", "grn", "green" * 15]


@pytest.mark.parametrize("make", [
    lambda m, c: m.Like(c, "green"),          # exact: row hashes
    lambda m, c: m.Like(c, "gre%"),           # prefix
    lambda m, c: m.Like(c, "%een"),           # suffix
    lambda m, c: m.Like(c, "%een%"),          # contains: the scan
    lambda m, c: m.Like(c, "g%n"),            # prefix and suffix
    lambda m, c: m.Like(c, "%"),              # any
    lambda m, c: m.StringStartsWith(c, "gr"),
    lambda m, c: m.StringEndsWith(c, "\u00e9n"),
    lambda m, c: m.StringContains(c, ""),
], ids=["exact", "prefix", "suffix", "contains", "prefix-suffix", "any",
        "startswith", "endswith", "contains-empty"])
def test_string_predicates_match_jax(make):
    jdev, pdev = _both({"s": (JT.STRING, LIKE_ROWS)})
    want = make(JS, JaxColumnRef("s", JT.STRING)).tpu_eval(TpuEvalCtx(jdev))
    got = make(PS, ColumnRef("s", T.STRING)).gpu_eval(GpuEvalCtx(pdev))
    for field in ("data", "validity"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(),
            np.asarray(jax.device_get(getattr(want, field))), err_msg=field)
