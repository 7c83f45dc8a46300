"""PyTorch port: slot aggregate, sort-based groupby and sort against the JAX
package.

Every comparison is bit-for-bit on the raw device buffers: group keys,
integer sums and counts, min/max (NaN and -0.0 included) and float sums.
The slot aggregate keeps the JAX package's limb formulation (integer-valued
f32 limb rows whose per-chunk sums stay below 2^24), so its float sums are
exact in any summation order and no tolerance is needed; the sort path sums
floats with one sequential scatter-add per group on both sides.
"""

import jax
import numpy as np
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.batch import host_to_device as jax_h2d
from spark_rapids_tpu.exprs import aggregates as JA
from spark_rapids_tpu.exprs.base import ColumnRef as JRef
from spark_rapids_tpu.exprs.base import DevVal as JDevVal
from spark_rapids_tpu.kernels import groupby as JG
from spark_rapids_tpu.kernels import hashagg as JH
from spark_rapids_tpu.kernels import sort as JS

from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.batch import host_to_device
from spark_rapids_tpu_torch.exprs import aggregates as PA
from spark_rapids_tpu_torch.exprs.base import ColumnRef as PRef
from spark_rapids_tpu_torch.exprs.base import DevVal as PDevVal
from spark_rapids_tpu_torch.kernels import groupby as PG
from spark_rapids_tpu_torch.kernels import hashagg as PH
from spark_rapids_tpu_torch.kernels import sort as PS

from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    assert_device_bits, one_torch_thread, port_host_batch,
)

AGGS = [("Sum", "v"), ("Sum", "f"), ("Count", "f"), ("Average", "f"),
        ("Average", "v"), ("Min", "m"), ("Max", "m"), ("Max", "v"),
        ("Min", "k2")]


def _data(n, key_range, seed=5, nan_in_sum=False):
    rng = np.random.RandomState(seed)
    k1 = [None if i % 13 == 0 else int(x)
          for i, x in enumerate(rng.randint(-3, key_range, n))]
    k2 = [int(x) for x in rng.randint(10 ** 12, 10 ** 12 + 3, n)]
    v = [None if i % 7 == 0 else int(x)
         for i, x in enumerate(rng.randint(-10 ** 15, 10 ** 15, n))]
    f = [None if i % 5 == 0 else float(x)
         for i, x in enumerate((rng.rand(n) * 1e6 - 5e5).round(3))]
    m = [None if i % 6 == 0 else float(x)
         for i, x in enumerate(rng.randn(n))]
    for i in range(0, n, 11):
        m[i] = -0.0
    for i in range(3, n, 17):
        m[i] = 0.0
    m[4] = float("nan")
    if nan_in_sum:
        f[2] = float("nan")
    return {"k1": (JT.INT, k1), "k2": (JT.LONG, k2), "v": (JT.LONG, v),
            "f": (JT.DOUBLE, f), "m": (JT.DOUBLE, m)}


def _both(pydict, live=None):
    jb = JaxHostBatch.from_pydict(pydict)
    jdev, pdev = jax_h2d(jb), host_to_device(port_host_batch(jb), "cpu")
    if live is not None:
        import jax.numpy as jnp
        from spark_rapids_tpu.kernels.layout import take_head as jhead
        from spark_rapids_tpu_torch.kernels.layout import take_head as phead
        jdev, pdev = jhead(jdev, jnp.int32(live)), phead(pdev, live)
    return jdev, pdev


def _fns(schema_j, schema_p):
    jf, pf = [], []
    for name, c in AGGS:
        jf.append(getattr(JA, name)(JRef(c, schema_j.field(c).dtype)))
        pf.append(getattr(PA, name)(PRef(c, schema_p.field(c).dtype)))
    return jf, pf


def _vals(batch, names, dev_val):
    return [dev_val.from_column(batch.column(n)) for n in names]


def _key_schemas():
    return (JT.Schema([("k1", JT.INT), ("k2", JT.LONG)]),
            PT.Schema([("k1", PT.INT), ("k2", PT.LONG)]))


# aggregates in AGGS whose first buffer is a float sum
FLOAT_SUMS = {i for i, (name, c) in enumerate(AGGS)
              if name in ("Sum", "Average") and c == "f"}


def _assert_buffers(jbufs, pbufs, float_sum_rtol=None):
    """Bit-equal buffers; with ``float_sum_rtol`` the float-sum buffers
    may differ by that relative amount instead."""
    assert len(jbufs) == len(pbufs)
    for ai, (jl, pl) in enumerate(zip(jbufs, pbufs)):
        for bi, (jb, pb) in enumerate(zip(jl, pl)):
            for field in ("data", "validity"):
                jn = np.asarray(jax.device_get(getattr(jb, field)))
                pn = getattr(pb, field).numpy()
                assert jn.dtype == pn.dtype, field
                if float_sum_rtol and field == "data" and bi == 0 and \
                        ai in FLOAT_SUMS:
                    np.testing.assert_allclose(pn, jn, rtol=float_sum_rtol,
                                               atol=0)
                else:
                    np.testing.assert_array_equal(jn, pn, err_msg=field)


def _run_hash(pydict, table, live=None):
    jdev, pdev = _both(pydict, live)
    jfns, pfns = _fns(jdev.schema, pdev.schema)
    jks, pks = _key_schemas()
    cols = [c for _, c in AGGS]
    jout = jax.jit(lambda b, kv, ai: JH.hash_group_aggregate(
        b, kv, ai, jfns, jks, jks, table=table))(
        jdev, _vals(jdev, ["k1", "k2"], JDevVal), _vals(jdev, cols, JDevVal))
    pout = PH.hash_group_aggregate(
        pdev, _vals(pdev, ["k1", "k2"], PDevVal), _vals(pdev, cols, PDevVal),
        pfns, pks, table=table)
    return jout, pout


@pytest.mark.parametrize("n,live", [(3000, None), (3000, 2500), (40000, None)],
                         ids=["one-chunk", "take-head", "four-chunks"])
def test_slot_aggregate_bit_identical(n, live):
    (jk, jbufs, jn, jflag), (pk, pbufs, pn, pflag) = _run_hash(
        _data(n, 97), PH.TABLE_SLOTS, live)
    assert not bool(jflag) and not bool(pflag)
    assert int(jn) == int(pn) > 0
    assert_device_bits(jk, pk)
    # Past one 16384-row chunk the float sums add one scaled term per
    # chunk.  Under jit, XLA on the CPU contracts that multiply into the
    # cross-chunk sum (an FMA), while torch rounds the product first: at
    # most one rounding per chunk apart, 1e-12 relative bounds it.  The
    # limb sums themselves are exact on both sides.
    _assert_buffers(jbufs, pbufs,
                    float_sum_rtol=1e-12 if n > PH._CHUNK else None)


@pytest.mark.parametrize("key_range,nan_in_sum", [
    (PH.TABLE_SLOTS * 2, False),   # packed key space over the slot table
    (97, True),                    # NaN in a float sum
], ids=["wide-keys", "nan-sum"])
def test_slot_aggregate_raises_fallback_flag(key_range, nan_in_sum):
    (_, _, _, jflag), (_, _, _, pflag) = _run_hash(
        _data(3000, key_range, nan_in_sum=nan_in_sum), PH.TABLE_SLOTS)
    assert bool(jflag) and bool(pflag)


def test_sort_groupby_update_and_merge_bit_identical():
    jdev, pdev = _both(_data(2000, 40))
    jfns, pfns = _fns(jdev.schema, pdev.schema)
    jks, pks = _key_schemas()
    cols = [c for _, c in AGGS]
    bufs_j = [[s.dtype for s in f.buffers()] for f in jfns]
    bufs_p = [[s.dtype for s in f.buffers()] for f in pfns]
    jkeys, jbufs = jax.jit(lambda b, kv, ai: JG.groupby_aggregate(
        b, kv, ai, jfns, False, jks, bufs_j, jks))(
        jdev, _vals(jdev, ["k1", "k2"], JDevVal), _vals(jdev, cols, JDevVal))
    pkeys, pbufs = PG.groupby_aggregate(
        pdev, _vals(pdev, ["k1", "k2"], PDevVal), _vals(pdev, cols, PDevVal),
        pfns, False, pks, bufs_p)
    assert_device_bits(jkeys, pkeys)
    _assert_buffers(jbufs, pbufs)
    # merge the update buffers back onto themselves (every group twice)
    jflat = [b for bl in jbufs for b in bl]
    pflat = [b for bl in pbufs for b in bl]
    jm_keys, jm = jax.jit(lambda b, kv, ai: JG.groupby_aggregate(
        b, kv, ai, jfns, True, jks, bufs_j, jks))(
        jkeys, [JDevVal.from_column(c) for c in jkeys.columns], jflat)
    pm_keys, pm = PG.groupby_aggregate(
        pkeys, [PDevVal.from_column(c) for c in pkeys.columns], pflat,
        pfns, True, pks, bufs_p)
    assert_device_bits(jm_keys, pm_keys)
    _assert_buffers(jm, pm)
    _assert_buffers([[f.finalize(b)] for f, b in zip(jfns, jm)],
                    [[f.finalize(b)] for f, b in zip(pfns, pm)])


def test_sort_batch_bit_identical():
    d = _data(500, 9)
    jdev, pdev = _both(d, live=480)
    keys = [("k1", True, True), ("m", False, False), ("k2", True, True),
            ("v", False, True)]
    jv = _vals(jdev, [k for k, _, _ in keys], JDevVal)
    pv = _vals(pdev, [k for k, _, _ in keys], PDevVal)
    asc = [a for _, a, _ in keys]
    nf = [n for _, _, n in keys]
    jout = jax.jit(lambda b, v: JS.sort_batch(b, v, asc, nf))(jdev, jv)
    pout = PS.sort_batch(pdev, pv, asc, nf)
    assert_device_bits(jout, pout)
