"""PyTorch port, equi-join kernels: ``kernels/join.py`` and the joinProbe
kernel's plain version against the JAX package.

The same numpy inputs become a batch in each package.  Both packages must
give the same raw outputs, dead lanes included: the host-driven pair list
(``join_pairs``), the static one (``join_pairs_static``: pairs, counts,
matched flags and the overflow flag), and joinProbe's candidates
(``probe_row``, ``build_row``, ``match``, ``total``), which the port's
plain version computes on the CPU and which the JAX package computes both
through its Pallas kernel in interpret mode and through its XLA
formulation (tier off).  The joined batches of ``hash_join`` and
``hash_join_static`` must be equal buffer for buffer, for every join type.
No float is computed, so there is no tolerance.

Every capacity stays at or below 128: the Pallas interpreter is slow.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.batch import host_to_device as jax_to_device
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.exprs.base import DevVal as JaxDevVal
from spark_rapids_tpu.kernels import join as JJ
from spark_rapids_tpu.kernels import pallas_tier as PT

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import host_to_device
from spark_rapids_tpu_torch.exprs.base import DevVal
from spark_rapids_tpu_torch.kernels import cuda_tier
from spark_rapids_tpu_torch.kernels import join as PJ

from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    assert_device_bits, one_torch_thread, port_host_batch,
)

INTERPRET_KEY = "spark.rapids.sql.tpu.pallas.interpret"
HOWS = ["inner", "left", "right", "full", "left_semi", "left_anti"]
#: two LONG keys whose first join hashes are equal (h1 = 41837122) and
#: whose key words differ: a candidate that the exact verify must reject
COLLIDE = (110526240400, 994712892952)
LONG_STRS = ["p" * 64 + "-one", "p" * 64 + "-two"]  # equal 64-byte prefix


def _pick(rng, values, n, null_frac):
    """n draws from ``values`` (a list), a ``null_frac`` share NULL."""
    idx = rng.randint(0, len(values), n)
    return [None if rng.rand() < null_frac else values[i] for i in idx]


def _case(name):
    """(left pydict, right pydict, key column names, left cap, right cap)
    of one case, made from a seed."""
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "long-many-to-many":
        keys = list(range(12))
        return ({"k": (JT.LONG, _pick(rng, keys, 40, 0.1))},
                {"k": (JT.LONG, _pick(rng, keys, 24, 0.1))}, ["k"], 64, 32)
    if name == "int-nulls":
        keys = list(range(-8, 8))
        return ({"k": (JT.INT, _pick(rng, keys, 50, 0.25))},
                {"k": (JT.INT, _pick(rng, keys, 30, 0.25))}, ["k"], 64, 32)
    if name == "date":
        keys = list(range(9190, 9215))
        return ({"k": (JT.DATE, _pick(rng, keys, 60, 0.1))},
                {"k": (JT.DATE, _pick(rng, keys, 20, 0.0))}, ["k"], 64, 32)
    if name == "double":
        keys = [0.0, -0.0, 1.5, -2.25, float("nan"), float("inf"), 1e300]
        return ({"k": (JT.DOUBLE, _pick(rng, keys, 40, 0.1))},
                {"k": (JT.DOUBLE, _pick(rng, keys, 14, 0.1))}, ["k"], 64, 16)
    if name == "string":
        keys = ["", "a", "BUILDING", "MACHINERY", "été"] + LONG_STRS
        return ({"k": (JT.STRING, _pick(rng, keys, 40, 0.1))},
                {"k": (JT.STRING, _pick(rng, keys + ["x"], 20, 0.1))},
                ["k"], 64, 32)
    if name == "two-column":
        ints, strs = list(range(4)), ["AIR", "RAIL", "", "TRUCK"]
        return ({"a": (JT.LONG, _pick(rng, ints, 40, 0.05)),
                 "s": (JT.STRING, _pick(rng, strs, 40, 0.05)),
                 "v": (JT.INT, list(range(40)))},
                {"b": (JT.LONG, _pick(rng, ints, 24, 0.05)),
                 "t": (JT.STRING, _pick(rng, strs, 24, 0.05)),
                 "w": (JT.DOUBLE, [i / 4 for i in range(24)])},
                (["a", "s"], ["b", "t"]), 64, 32)
    if name == "dup-heavy":  # long runs of one key on both sides
        return ({"k": (JT.LONG, _pick(rng, [1, 2], 24, 0.1))},
                {"k": (JT.LONG, _pick(rng, [1, 2, 3], 30, 0.0))},
                ["k"], 32, 32)
    if name == "h1-collision":
        return ({"k": (JT.LONG, [COLLIDE[0], 7, COLLIDE[0], None, 3])},
                {"k": (JT.LONG, [COLLIDE[1], COLLIDE[1], 7, COLLIDE[0]])},
                ["k"], 8, 8)
    if name == "empty-probe":
        return ({"k": (JT.LONG, [])},
                {"k": (JT.LONG, _pick(rng, list(range(5)), 20, 0.1))},
                ["k"], 8, 32)
    if name == "empty-build":
        return ({"k": (JT.LONG, _pick(rng, list(range(5)), 20, 0.1))},
                {"k": (JT.LONG, [])}, ["k"], 32, 8)
    raise KeyError(name)


CASES = ["long-many-to-many", "int-nulls", "date", "double", "string",
         "two-column", "h1-collision", "empty-probe", "empty-build"]


def _sides(name, device="cpu"):
    """((jax left, jax keys), (jax right, keys)), the same for the port
    (its batches on ``device``)."""
    ldata, rdata, keys, lcap, rcap = _case(name)
    lnames, rnames = keys if isinstance(keys, tuple) else (keys, keys)
    out = []
    for data, names, cap in ((ldata, lnames, lcap), (rdata, rnames, rcap)):
        jb = JaxHostBatch.from_pydict(data)
        jdev = jax_to_device(jb, capacity=cap)
        pdev = host_to_device(port_host_batch(jb), device, capacity=cap)
        out.append(((jdev, [JaxDevVal.from_column(jdev.column(n))
                            for n in names]),
                    (pdev, [DevVal.from_column(pdev.column(n))
                            for n in names])))
    (jl, pl), (jr, pr) = out
    return (jl, jr), (pl, pr)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jax.device_get(x))


def _assert_same(want, got, names):
    for name, w, g in zip(names, want, got):
        w, g = _np(w), _np(g)
        assert w.dtype == g.dtype, (name, w.dtype, g.dtype)
        np.testing.assert_array_equal(w, g, err_msg=name)


@contextlib.contextmanager
def _tier(settings):
    PT.configure(JaxConf(settings))
    try:
        yield
    finally:
        PT.configure(None)


def _recorder(monkeypatch, module, attr, name=None):
    """Record every return value of ``module.attr`` (for PT.run: of the
    joinProbe dispatches only)."""
    seen = []
    real = getattr(module, attr)

    def wrapped(*args, **kwargs):
        out = real(*args, **kwargs)
        if name is None or args[0] == name:
            seen.append(out)
        return out

    monkeypatch.setattr(module, attr, wrapped)
    return seen


PAIR_NAMES = ["l_idx", "r_idx", "n_pairs", "l_counts", "r_matched"]


@pytest.mark.parametrize("case", CASES)
def test_join_pairs_matches_jax(case):
    ((jl, jlk), (jr, jrk)), ((pl, plk), (pr, prk)) = _sides(case)
    want = JJ.join_pairs(jlk, jl.num_rows, jrk, jr.num_rows)
    got = PJ.join_pairs(plk, pl.num_rows, prk, pr.num_rows)
    _assert_same(want, got, PAIR_NAMES)


@pytest.mark.parametrize("case,pair_cap", [(c, 128) for c in CASES] + [
    ("long-many-to-many", 32), ("string", 16), ("dup-heavy", 512),
    ("dup-heavy", 64)],
    ids=CASES + ["pair-cap-below-total", "string-pair-cap-below-total",
                 "dup-heavy", "dup-heavy-pair-cap-below-total"])
def test_join_pairs_static_matches_jax(monkeypatch, case, pair_cap):
    """The static pair list and joinProbe's raw candidates: the port's
    plain version equals the JAX Pallas kernel (interpret mode, no
    fallback) and the JAX XLA formulation."""
    ((jl, jlk), (jr, jrk)), ((pl, plk), (pr, prk)) = _sides(case)
    jax_probe = _recorder(monkeypatch, PT, "run", "joinProbe")
    port_probe = _recorder(monkeypatch, cuda_tier, "probe_join")

    def jax_static():
        return JJ.join_pairs_static(jlk, jl.num_rows, jrk, jr.num_rows,
                                    pair_cap)

    with _tier({INTERPRET_KEY: True}):
        before = PT.fallback_count()
        kernel = jax.block_until_ready(jax_static())
        assert PT.fallback_count() == before, "joinProbe fell back"
    with _tier({spec.entry.key: False for spec in PT.registered()}):
        xla = jax.block_until_ready(jax_static())
    got = PJ.join_pairs_static(plk, pl.num_rows, prk, pr.num_rows, pair_cap)

    names = PAIR_NAMES + ["overflow"]
    _assert_same(xla, got, names)
    _assert_same(kernel, got, names)
    (p_row, b_row, match, total), = port_probe
    assert total.dtype == torch.int64
    for ref in jax_probe:  # the Pallas kernel, then the XLA formulation
        _assert_same(ref[:3], (p_row, b_row, match),
                     ["probe_row", "build_row", "match"])
        assert int(_np(ref[3])) == int(total)
    assert _np(jax_probe[1][3]).dtype == np.int64  # XLA's jnp.sum under x64
    assert bool(got[5]) == (int(total) > pair_cap)
    # the word count from the types alone (a DOUBLE is two words on a
    # real-f64 backend in both packages)
    assert PJ._exact_word_count(plk) == JJ._exact_word_count(jlk) == \
        int(PJ._exact_words(plk)[0].shape[0])
    if case == "h1-collision":  # a rejected candidate: h1 equal, key not
        assert int(total) > int(got[2])


@pytest.fixture(scope="module")
def two_column():
    """The "two-column" sides, and the JAX package's host-driven pairs of
    them, once for every join type (its ``hash_join`` is ``join_pairs``
    then ``stitch_join_output``; ``join_pairs`` recompiles per call)."""
    (jl, jr), (pl, pr) = _sides("two-column")
    pairs = JJ.join_pairs(jl[1], jl[0].num_rows, jr[1], jr[0].num_rows)
    return (jl, jr), (pl, pr), pairs


@pytest.mark.parametrize("how", HOWS)
def test_hash_join_matches_jax(two_column, how):
    """Joined batches of both forms, every join type, over a two-column
    (LONG, STRING) key with payload columns on both sides: raw buffers
    equal, and the static form's overflow flag."""
    ((jl, jlk), (jr, jrk)), ((pl, plk), (pr, prk)), pairs = two_column
    jschema = _joined_schema(jl.schema, jr.schema, how, JT)
    pschema = _joined_schema(pl.schema, pr.schema, how, T)
    want = JJ.stitch_join_output(jl, jr, *pairs, how, jschema)
    got = PJ.hash_join(pl, plk, pr, prk, how, pschema)
    assert_device_bits(want, got)
    with _tier({spec.entry.key: False for spec in PT.registered()}):
        want_s, want_ovf = JJ.hash_join_static(jl, jlk, jr, jrk, how,
                                               jschema)
    got_s, got_ovf = PJ.hash_join_static(pl, plk, pr, prk, how, pschema)
    assert not bool(jax.device_get(want_ovf)) and not bool(got_ovf)
    assert_device_bits(want_s, got_s)


def test_hash_join_static_flags_overflow(two_column):
    """A growth factor too small for the pairs sets the overflow flag in
    both packages."""
    ((jl, jlk), (jr, jrk)), ((pl, plk), (pr, prk)), _ = two_column
    with _tier({spec.entry.key: False for spec in PT.registered()}):
        _, want = JJ.hash_join_static(jl, jlk, jr, jrk, "inner",
                                      _joined_schema(jl.schema, jr.schema,
                                                     "inner", JT),
                                      growth=0.1)
    _, got = PJ.hash_join_static(pl, plk, pr, prk, "inner",
                                 _joined_schema(pl.schema, pr.schema,
                                                "inner", T), growth=0.1)
    assert bool(jax.device_get(want)) and bool(got)


def _joined_schema(lschema, rschema, how, types):
    if how in ("left_semi", "left_anti"):
        return lschema
    lf = [types.Field(f.name, f.dtype, how in ("right", "full"))
          for f in lschema.fields]
    rf = [types.Field(f.name, f.dtype, how in ("left", "full"))
          for f in rschema.fields]
    return types.Schema(lf + rf)


def test_probe_join_refuses_bad_inputs():
    """The wrapper checks types and shapes before any launch."""
    n = 8
    i64 = torch.zeros(n, dtype=torch.int64)
    ok = torch.ones(n, dtype=torch.bool)
    perm = torch.arange(n, dtype=torch.int32)
    words = torch.zeros(1, n, dtype=torch.int64)
    args = [i64, ok, i64, perm, words, ok, words, ok]
    out = cuda_tier.probe_join(*args, 16)
    assert [tuple(t.shape) for t in out[:3]] == [(16,)] * 3
    assert int(out[3]) == n * n  # every probe row matches every build row
    with pytest.raises(ValueError, match="perm must be"):
        cuda_tier.probe_join(*args[:3], perm.long(), *args[4:], 16)
    with pytest.raises(ValueError, match="pair_cap"):
        cuda_tier.probe_join(*args, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_probe_kernel_matches_plain_version_on_card(case):
    """On the card: joinProbe's four outputs equal its plain version's on
    the same inputs, one launch per call, and the static join equals the
    port's CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _, ((pl, plk), (pr, prk)) = _sides(case, "cuda")
    l_h1, l_ok, l_live, perm, r_sorted = PJ._hashed_sides(
        plk, pl.num_rows, prk, pr.num_rows)
    args = (l_h1, l_ok & l_live, r_sorted, perm, *PJ._exact_words(plk),
            *PJ._exact_words(prk))
    before = cuda_tier.launch_count("joinProbe")
    got = cuda_tier.probe_join(*args, 64)
    assert cuda_tier.launch_count("joinProbe") == before + 1
    want = cuda_tier.probe_join_reference(*args, 64)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    _, ((cl, clk), (cr, crk)) = _sides(case)
    _assert_same(
        PJ.join_pairs_static(clk, cl.num_rows, crk, cr.num_rows, 64),
        [t.cpu() for t in PJ.join_pairs_static(plk, pl.num_rows, prk,
                                               pr.num_rows, 64)],
        PAIR_NAMES + ["overflow"])
