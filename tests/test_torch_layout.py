"""PyTorch port: row-movement kernels against the JAX package.

The port's plain k-way pack (what a CPU tensor takes, and what the CUDA
kernel is held to on the card) must be bit-equal to the JAX package's
Pallas kernel run in interpret mode AND to its XLA scatter chain, for every
element width.  Exact comparison throughout: these functions move bytes.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.batch import host_to_device as jax_h2d
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.kernels import layout as JL
from spark_rapids_tpu.kernels import pallas_tier as JPT

from spark_rapids_tpu_torch.batch import host_to_device
from spark_rapids_tpu_torch.kernels import cuda_tier
from spark_rapids_tpu_torch.kernels import layout as L

from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    assert_device_bits, one_torch_thread, port_host_batch,
)

DTYPES = ["bool", "uint8", "int32", "int64", "float32", "float64"]


@contextlib.contextmanager
def jax_tier(engaged: bool):
    key = "spark.rapids.sql.tpu.pallas.interpret" if engaged else \
        "spark.rapids.sql.tpu.pallas.gatherScatter.enabled"
    JPT.configure(JaxConf({key: engaged}))
    try:
        yield
    finally:
        JPT.configure(None)


def _arrays(rng, dtype, sizes):
    out = []
    for n in sizes:
        if dtype == "bool":
            out.append(rng.rand(n) < 0.2)  # NULL-heavy validity shape
        elif dtype.startswith("float"):
            out.append((rng.randn(n) * 1e3).astype(dtype))
        else:
            out.append(rng.randint(0, 250, n).astype(dtype))
    return out


def _windows(rng, sizes, case):
    los, his = [], []
    for j, n in enumerate(sizes):
        if case == "boundary":
            lo, hi = 0, n
        elif j == 1:
            lo = hi = int(rng.randint(0, n + 1))  # empty segment
        else:
            lo = int(rng.randint(0, n // 2 + 1))  # lo > 0 windows
            hi = int(rng.randint(lo, n + 1))
        los.append(lo)
        his.append(hi)
    return los, his


@pytest.mark.parametrize("k,dtype,case", [
    (k, dtype, "windows") for k in (1, 2, 5) for dtype in DTYPES] +
    [(2, "int32", "boundary"), (5, "float64", "boundary")])
def test_pack_segments_matches_pallas_and_xla(k, dtype, case):
    rng = np.random.RandomState(k * 100 + DTYPES.index(dtype))
    sizes = [int(s) for s in rng.randint(9, 40, k)]
    arrays = _arrays(rng, dtype, sizes)
    los, his = _windows(rng, sizes, case)
    total = sum(h - lo for lo, h in zip(los, his))
    # "windows": a total below out_cap (tail must be zeros), out_cap not a
    # multiple of any block; "boundary": out_cap == the live total
    out_cap = total if case == "boundary" else total + 13
    got = cuda_tier.pack_segments([torch.from_numpy(a) for a in arrays],
                                  los, his, out_cap)
    assert got.dtype == torch.from_numpy(arrays[0]).dtype
    jarrs = [jnp.asarray(a) for a in arrays]
    jl = [jnp.asarray(v, jnp.int32) for v in los]
    jh = [jnp.asarray(v, jnp.int32) for v in his]
    pallas = JPT.pack_segments(jarrs, jl, jh, out_cap, interpret=True)
    with jax_tier(engaged=False):  # one compiled program, not op by op
        xla = jax.jit(lambda a, lo, hi: JL._pack_kway(a, lo, hi, out_cap))(
            jarrs, jl, jh)
    for want in (pallas, xla):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax.device_get(want)))
    # values outside [lo, hi) never leak; zeros past the total
    assert not got[total:].any()


MIXED = {
    "i": (JT.INT, [3, None, 7, 1, 7, None, 0]),
    "f": (JT.FLOAT, [1.5, -2.0, None, 0.0, float("nan"), 3.25, -0.0]),
    "s": (JT.STRING, ["bb", "", None, "apple", "bb", "zed", "aa"]),
    "b": (JT.BOOLEAN, [True, False, None, True, False, True, None]),
}
NULLY = {
    "i": (JT.INT, [None, None, 5, None]),
    "f": (JT.FLOAT, [None, 1.0, 2.0, None]),
    "s": (JT.STRING, [None, "x", None, None]),
    "b": (JT.BOOLEAN, [True, None, False, True]),
}
SINGLE = {
    "i": (JT.INT, [42]),
    "f": (JT.FLOAT, [0.5]),
    "s": (JT.STRING, ["one"]),
    "b": (JT.BOOLEAN, [None]),
}
EMPTY = {
    "i": (JT.INT, []),
    "f": (JT.FLOAT, []),
    "s": (JT.STRING, []),
    "b": (JT.BOOLEAN, []),
}


def _both(pydict):
    jb = JaxHostBatch.from_pydict(pydict)
    return jax_h2d(jb), host_to_device(port_host_batch(jb), "cpu")


@pytest.mark.parametrize("dicts,cap,head", [
    ([MIXED, NULLY], 16, None),       # NULL-heavy second input
    ([SINGLE, SINGLE], 2, None),      # capacity boundary: cap == rows
    ([MIXED, SINGLE], 4, 2),          # take_head-truncated first input
    ([EMPTY, MIXED, EMPTY, NULLY], 16, None),  # inputs of no rows
    ([NULLY, SINGLE, MIXED] * 3, 64, 0),       # nine inputs, head 0
], ids=["mixed-nully", "single-boundary", "take-head", "empty-inputs",
        "nine-inputs"])
def test_concat_kway_matches_jax(dicts, cap, head):
    pairs = [_both(d) for d in dicts]
    if head is not None:
        pairs[0] = (JL.take_head(pairs[0][0], head),
                    L.take_head(pairs[0][1], head))
    with jax_tier(engaged=True):
        want = JL.concat_kway([p[0] for p in pairs], cap)
    got = L.concat_kway([p[1] for p in pairs], cap)
    assert_device_bits(want, got)
    if head == 2:  # only the live window of the truncated input
        from spark_rapids_tpu_torch.batch import device_to_host
        assert device_to_host(got).to_pydict()["s"] == ["bb", "", "one"]


def _pack_args(batches):
    columns = [[(c.data, c.validity, c.offsets) for c in parts]
               for parts in zip(*(b.columns for b in batches))]
    byte_caps = [sum(int(d.shape[0]) for d, _, _ in parts)
                 for parts in columns if parts[0][2] is not None]
    return columns, [b.num_rows for b in batches], byte_caps


@pytest.mark.parametrize("limit", [1, 2, 4])
def test_grouped_concat_equals_one_pack_and_jax(limit):
    """More batches than one gatherScatter launch's table holds are packed
    in groups of ``limit``, then the groups: the buffers equal one pack's
    and the JAX package's concat_kway (take_head-truncated strings, a batch
    of no rows, zero tails)."""
    from spark_rapids_tpu_torch.batch import ColumnBatch, DeviceColumn
    pairs = [_both(d) for d in (MIXED, EMPTY, NULLY, SINGLE, MIXED)]
    pairs[0] = (JL.take_head(pairs[0][0], 4), L.take_head(pairs[0][1], 4))
    with jax_tier(engaged=True):
        want = JL.concat_kway([p[0] for p in pairs], 32)
    batches = [p[1] for p in pairs]
    columns, ns, byte_caps = _pack_args(batches)
    got = cuda_tier._pack_columns_grouped(columns, ns, 32, byte_caps, limit)
    one = cuda_tier.pack_columns(columns, ns, 32, byte_caps)
    for g, o in zip(got, one):  # bit for bit (NaN among the floats)
        for gb, ob in zip(g, o):
            assert (gb is None) == (ob is None)
            assert gb is None or torch.equal(gb.view(torch.uint8),
                                             ob.view(torch.uint8))
    cols = [DeviceColumn(f.dtype, d, v, o)
            for f, (d, v, o) in zip(batches[0].schema.fields, got)]
    assert_device_bits(want, ColumnBatch(
        batches[0].schema, cols, torch.stack(ns).sum().to(torch.int32), 32))


@pytest.mark.parametrize("num_rows", [0, 5, 7])
def test_compaction_and_compact_match_jax(num_rows):
    jdev, pdev = _both({k: v for k, v in MIXED.items() if k != "s"})
    mask = np.array([True, False, True, True, False, True, True, False])
    jidx, jcnt = JL.compaction_indices(jnp.asarray(mask), num_rows)
    pidx, pcnt = L.compaction_indices(torch.from_numpy(mask), num_rows)
    np.testing.assert_array_equal(np.asarray(jidx), pidx.numpy())
    assert int(jcnt) == int(pcnt)
    jdev = JL.take_head(jdev, num_rows)
    pdev = L.take_head(pdev, num_rows)
    assert_device_bits(JL.compact(jdev, jnp.asarray(mask)),
                       L.compact(pdev, torch.from_numpy(mask)))


def test_wrapper_rejects_what_it_cannot_take():
    a = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_tier.pack_segments([a, a.to(torch.int64)], [0, 0], [1, 1], 4)
    with pytest.raises(ValueError):
        cuda_tier.pack_segments([a.reshape(2, 2)], [0], [1], 4)
    with pytest.raises(ValueError):
        cuda_tier.pack_segments([a], [0, 1], [1], 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_kernel_matches_plain_version_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.RandomState(3)
    sizes = [int(s) for s in rng.randint(1, 5000, 16)]
    arrays = [torch.from_numpy(a).cuda() for a in
              _arrays(rng, dtype, sizes)]
    los, his = _windows(rng, sizes, "windows")
    los = [torch.tensor(v, dtype=torch.int32, device="cuda") for v in los]
    his = [torch.tensor(v, dtype=torch.int32, device="cuda") for v in his]
    before = cuda_tier.launch_count("gatherScatter")
    got = cuda_tier.pack_segments(arrays, los, his, 70001)
    torch.cuda.synchronize()
    assert cuda_tier.launch_count("gatherScatter") == before + 1
    want = cuda_tier.pack_segments_reference(arrays, los, his, 70001)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n_strings", [(16, 2), (200, 6)])
def test_concat_kernel_matches_plain_version_on_card(k, n_strings):
    """Every buffer of a concat in one launch (k = 200 with six string
    columns exceeds one launch's table: grouped packs) equals the plain
    version, zero tails and rebuilt offsets included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.RandomState(k + n_strings)
    caps = [int(c) for c in rng.randint(1, 500, k)]
    ns = [int(rng.randint(0, c + 1)) for c in caps]
    columns = []
    for dtype in DTYPES:
        columns.append([
            (torch.from_numpy(d).cuda(), torch.from_numpy(v).cuda(), None)
            for d, v in zip(_arrays(rng, dtype, caps),
                            _arrays(rng, "bool", caps))])
    live = []
    for _ in range(n_strings):
        parts = []
        for cap in caps:
            offs = np.zeros(cap + 1, dtype=np.int32)
            np.cumsum(rng.randint(0, 9, cap), out=offs[1:])
            data = rng.randint(0, 256, int(offs[-1]) + 5).astype(np.uint8)
            parts.append((torch.from_numpy(data).cuda(),
                          torch.from_numpy(rng.rand(cap) < 0.9).cuda(),
                          torch.from_numpy(offs).cuda()))
        columns.append(parts)
        live.append(sum(int(o[n]) for (_, _, o), n in zip(parts, ns)))
    n_dev = [torch.tensor(n, dtype=torch.int32, device="cuda") for n in ns]
    out_cap, byte_caps = sum(ns) + 7, [b + 3 for b in live]
    got = cuda_tier.pack_columns(columns, n_dev, out_cap, byte_caps)
    torch.cuda.synchronize()
    want = cuda_tier.pack_columns_reference(columns, n_dev, out_cap,
                                            byte_caps)
    for g, w in zip(got, want):
        for gb, wb in zip(g, w):
            assert (gb is None) == (wb is None)
            assert gb is None or torch.equal(gb.view(torch.uint8),
                                             wb.view(torch.uint8))
