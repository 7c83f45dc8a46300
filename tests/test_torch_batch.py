"""PyTorch port: host -> device -> host round trips against the JAX package.

The same numpy columns are staged by both packages; the device buffers must
be bit-identical (same capacity, dtype and bytes, padding included) and the
rows must come back unchanged.  Exact comparison throughout: staging moves
bytes and computes nothing.
"""

import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.batch import host_sizes as jax_host_sizes
from spark_rapids_tpu.batch import host_to_device as jax_h2d

from spark_rapids_tpu_torch import batch as PB
from spark_rapids_tpu_torch.runtime.device import resolve_device
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    assert_device_bits, one_torch_thread, port_host_batch,
)

COLUMNS = {
    "int": (JT.INT, [3, None, -7, 2 ** 31 - 1, None, -(2 ** 31)]),
    "long": (JT.LONG, [None, 2 ** 62, -1, 0, 5, None]),
    "double": (JT.DOUBLE, [1.5, None, float("nan"), -0.0, float("inf"),
                           -2.25]),
    "boolean": (JT.BOOLEAN, [True, None, False, None, True, False]),
    "string": (JT.STRING, ["bb", "", None, "héllo", "z" * 40, None]),
}


@pytest.mark.parametrize("name", list(COLUMNS))
def test_round_trip_matches_jax(name):
    jb = JaxHostBatch.from_pydict({name: COLUMNS[name]})
    jdev = jax_h2d(jb)
    pdev = PB.host_to_device(port_host_batch(jb), "cpu")
    assert_device_bits(jdev, pdev)
    got = PB.device_to_host(pdev).to_pydict()[name]
    want = jb.to_pydict()[name]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if isinstance(w, float) and w != w:
            assert g != g
        else:
            assert g == w


def test_all_types_one_batch_and_host_sizes():
    """Several columns in one batch, with sizes fetched in one sync."""
    jb = JaxHostBatch.from_pydict(COLUMNS)
    jdev = jax_h2d(jb)
    pdev = PB.host_to_device(port_host_batch(jb), "cpu")
    assert_device_bits(jdev, pdev)
    assert PB.host_sizes([pdev, pdev]) == jax_host_sizes([jdev, jdev])
    assert pdev.device == torch.device("cpu")
    assert pdev.num_rows.dim() == 0 and pdev.num_rows.dtype == torch.int32


def test_dense_numpy_columns_stage_without_nulls():
    rng = np.random.RandomState(7)
    vals = rng.randint(-50, 50, 37).astype(np.int32)
    jb = JaxHostBatch.from_pydict({"x": (JT.INT, vals.tolist())})
    pb = PB.HostBatch.from_pydict({"x": (PB.T.INT, vals)})
    assert_device_bits(jax_h2d(jb), PB.host_to_device(pb, "cpu"))


@pytest.mark.parametrize("vals", [
    ["A", "N", "R", "A"],                   # 1-char codes (lineitem)
    ["green navy", "", "a\x00b", "lemon"],  # empty row, interior NUL
    ["", ""],                               # zero-width str array
    ["h\u00e9llo", "ab", "\u4e2d"],          # non-ASCII: row by row
], ids=["flags", "mixed", "all-empty", "utf8"])
def test_numpy_string_columns_stage_as_jax(vals):
    """A numpy str column (the generators' form) is encoded by numpy
    alone when it is all ASCII; either way the bytes and offsets equal
    the JAX package's staging of the same strings."""
    jb = JaxHostBatch.from_pydict({"s": (JT.STRING, list(vals))})
    pb = PB.HostBatch.from_pydict({"s": (PB.T.STRING, np.array(vals))})
    assert pb.columns[0].values.dtype.kind == "U"
    assert_device_bits(jax_h2d(jb), PB.host_to_device(pb, "cpu"))
    assert PB.device_to_host(PB.host_to_device(pb, "cpu")).to_pydict() == \
        {"s": list(vals)}


def test_no_cuda_means_no_default_device(monkeypatch):
    """Without CUDA a session needs device='cpu'; it never quietly runs
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GpuSparkSession()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert GpuSparkSession(device="cpu").device == torch.device("cpu")
