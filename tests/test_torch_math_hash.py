"""PyTorch port, the math expressions (``exprs/mathexprs.py``), the murmur3
hash (``exprs/hashing.py``) and ``to_date`` (``exprs/datetime.py:ToDate``)
against the JAX package's own functions on the same numpy inputs.

Each expression runs four ways: the JAX package's device form
(``tpu_eval`` under jax's CPU backend) and host twin (``cpu_eval``), and
the port's device form (``gpu_eval`` on CPU tensors) and host twin.  The
host twins call the same numpy functions, so they agree bit for bit.  The
device forms of the transcendental functions may differ in the last bits
(torch's CPU kernels, CUDA's libdevice and XLA's CPU lowering each round
their own way, torch's CPU ``sqrt`` included): the port's are held within
4 ULP of the numpy result, with NaN and the infinities in the same places,
and the JAX package's within 512 ULP (XLA's CPU ``sinh``/``cosh`` near
overflow, ``log1p`` and ``atanh`` are that far off); the port's ``floor``,
``ceil``, ``rint``, ``signum`` and ``round`` equal numpy's exactly.

murmur3 is exact everywhere but one place: XLA's CPU backend flushes f32
subnormals to zero, so where the JAX device form meets an f32 subnormal
(a FLOAT input, or the ``hi``/``lo`` halves of a DOUBLE below ~1e-31) it
disagrees with its own numpy twin; there the port, on both sides, gives
the numpy twin's bits (on CUDA, conversions keep subnormals too).
"""

import math

import jax
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.batch import host_to_device as jax_to_device
from spark_rapids_tpu.exprs import base as JB
from spark_rapids_tpu.exprs import datetime as JDT
from spark_rapids_tpu.exprs import hashing as JH
from spark_rapids_tpu.exprs import mathexprs as JMX

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import host_to_device
from spark_rapids_tpu_torch.exprs import base as PB
from spark_rapids_tpu_torch.exprs import datetime as PDT
from spark_rapids_tpu_torch.exprs import hashing as PH
from spark_rapids_tpu_torch.exprs import mathexprs as PMX

from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread, port_host_batch,
)

UNARY = ["Sqrt", "Exp", "Log", "Log2", "Log10", "Log1p", "Expm1", "Floor",
         "Ceil", "Sin", "Cos", "Tan", "Asin", "Acos", "Atan", "Cbrt",
         "Signum", "Rint", "ToDegrees", "ToRadians", "Sinh", "Cosh",
         "Tanh", "Asinh", "Acosh", "Atanh", "Cot"]
EXACT = {"Floor", "Ceil", "Rint", "Signum"}
ULPS = 4
#: XLA's CPU lowering of sinh/cosh near overflow, log1p and atanh is
#: hundreds of ULP off numpy's (measured: 453, 101, 31)
JAX_ULPS = 512
EDGES = [0.0, -0.0, 0.5, -0.5, 1.0, -1.0, 2.5, -2.5, 1e-300, 1e300,
         -1e300, np.nan, np.inf, -np.inf, 709.0, 710.0, 1e-8, 3.0, 1.5,
         -1.5, 7.25, 100.0]


def _run(data, make, capacity=None):
    """((JAX device, JAX host), (port device, port host)) values of
    ``make(module, ColumnRef)`` over the same table in each package."""
    jb = JaxHostBatch.from_pydict(data)
    jdev = jax_to_device(jb, capacity=capacity)
    phb = port_host_batch(jb)
    pdev = host_to_device(phb, "cpu", capacity=capacity)
    je = JB.resolve(make(JMX, JDT, JH, JB), jb.schema)
    pe = PB.resolve(make(PMX, PDT, PH, PB), phb.schema)
    jd = je.tpu_eval(JB.TpuEvalCtx(jdev))
    jh = je.cpu_eval(JB.CpuEvalCtx(jb))
    pd = pe.gpu_eval(PB.GpuEvalCtx(pdev))
    ph = pe.cpu_eval(PB.CpuEvalCtx(phb))
    n = jb.num_rows

    def dev(v):
        return (np.asarray(jax.device_get(v.data))[:n]
                if not isinstance(v.data, torch.Tensor)
                else v.data.numpy()[:n],
                np.asarray(jax.device_get(v.validity))[:n]
                if not isinstance(v.validity, torch.Tensor)
                else v.validity.numpy()[:n])

    def host(v):
        return np.asarray(v.values), np.asarray(v.validity)

    return (dev(jd), host(jh)), (dev(pd), host(ph))


def _ulp_close(got, want, ulps=ULPS):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    assert np.array_equal(got[~fin & ~np.isnan(want)],
                          want[~fin & ~np.isnan(want)])
    g, w = got[fin], want[fin]
    assert np.isfinite(g).all()
    tol = ulps * np.spacing(np.maximum(np.abs(w), np.finfo(np.float64).tiny))
    bad = np.abs(g - w) > tol
    assert not bad.any(), (g[bad][:5], w[bad][:5])


def _values(rng, n=200):
    x = np.concatenate([rng.randn(n) * 3, rng.rand(n) * 2 - 1,
                        np.asarray(EDGES)])
    valid = np.ones(len(x), dtype=bool)
    valid[::17] = False
    return [float(v) if ok else None for v, ok in zip(x, valid)]


@pytest.mark.parametrize("fn", UNARY)
def test_unary_math_matches_jax(fn):
    rng = np.random.RandomState(UNARY.index(fn))
    data = {"x": (JT.DOUBLE, _values(rng)),
            "i": (JT.INT, list(range(-3, 200 * 2 + len(EDGES) - 3)))}
    for col in ("x", "i"):
        (jd, jh), (pd, ph) = _run(
            data, lambda M, D, H, B: getattr(M, fn)(B.ColumnRef(col)))
        # host twins: the same numpy function, bit for bit
        np.testing.assert_array_equal(ph[0], jh[0])
        np.testing.assert_array_equal(ph[1], jh[1])
        np.testing.assert_array_equal(pd[1], jd[1])
        live = pd[1]
        if fn in EXACT:
            np.testing.assert_array_equal(pd[0][live], jh[0][live])
        else:
            _ulp_close(pd[0][live], jh[0][live])
        _ulp_close(jd[0][live], jh[0][live], JAX_ULPS)


@pytest.mark.parametrize("dtype", ["double", "float", "int", "long"])
@pytest.mark.parametrize("scale", [-2, -1, 0, 1, 2, 3])
def test_round_half_up_matches_jax(dtype, scale):
    """Ties away from zero at every scale, negatives, integral inputs (as
    they are at a scale >= 0), NULLs; bit for bit on all four sides."""
    ties = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.125, -0.125, 1.005, 2.675,
            0.0, -0.0, 15.0, 25.0, -25.0, 149.5, -150.5, 1234.5678,
            1e15 + 0.5, np.nan, np.inf, -np.inf, 9.995, 0.045]
    rng = np.random.RandomState(scale + 10)
    if dtype in ("int", "long"):
        # at a negative scale 2^31 - 1 rounds past int32, a double cast
        # that XLA and CUDA saturate and x86 makes INT_MIN: not compared
        big = 2 ** 31 - 8 if dtype == "int" else 2 ** 31 - 1
        vals = [int(v) for v in rng.randint(-100000, 100000, 60)] + \
            [0, 5, -5, 15, -15, 149, 150, -150, big, -big]
    else:
        vals = [float(v) for v in rng.randn(60) * 1000] + ties
    vals = [None if i % 11 == 3 else v for i, v in enumerate(vals)]
    jt = {"double": JT.DOUBLE, "float": JT.FLOAT, "int": JT.INT,
          "long": JT.LONG}[dtype]
    (jd, jh), (pd, ph) = _run({"x": (jt, vals)}, lambda M, D, H, B:
                              M.Round(B.ColumnRef("x"), scale))
    for got, want in ((pd, jd), (ph, jh), (pd, jh)):
        assert got[0].dtype == want[0].dtype
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0][got[1]], want[0][want[1]])


def test_round_ties_are_half_up():
    (_, _), (pd, ph) = _run(
        {"x": (JT.DOUBLE, [0.5, 1.5, 2.5, -0.5, -2.5, 0.25])},
        lambda M, D, H, B: M.Round(B.ColumnRef("x"), 0))
    assert pd[0].tolist() == [1.0, 2.0, 3.0, -1.0, -3.0, 0.0]
    assert ph[0].tolist() == pd[0].tolist()


@pytest.mark.parametrize("op", ["Pow", "Logarithm"])
def test_binary_math_matches_jax(op):
    rng = np.random.RandomState(7)
    a = [float(v) for v in rng.rand(80) * 10] + \
        [0.0, -0.0, 2.0, -2.0, 1.0, np.nan, np.inf, -8.0, 10.0, 0.5]
    b = [float(v) for v in rng.randn(80) * 3] + \
        [0.0, 3.0, 0.5, 3.0, np.inf, 2.0, -1.0, 1.0 / 3.0, 2.0, -2.0]
    a = [None if i % 13 == 4 else v for i, v in enumerate(a)]
    b = [None if i % 7 == 2 else v for i, v in enumerate(b)]
    (jd, jh), (pd, ph) = _run(
        {"a": (JT.DOUBLE, a), "b": (JT.DOUBLE, b)},
        lambda M, D, H, B: getattr(M, op)(B.ColumnRef("a"),
                                           B.ColumnRef("b")))
    np.testing.assert_array_equal(ph[0], jh[0])
    np.testing.assert_array_equal(ph[1], jh[1])
    np.testing.assert_array_equal(pd[1], jd[1])
    live = pd[1]
    _ulp_close(pd[0][live], jh[0][live])
    _ulp_close(jd[0][live], jh[0][live])


# ---- murmur3 --------------------------------------------------------------

DOUBLE_EDGES = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1e300, -1e300,
                3.4028234663852886e38, 3.4028235677973366e38, 1e39,
                2.0 ** -126, 1e-30, 1.0, -1.0, 1.0 + 2.0 ** -40,
                0.1, 1e16 + 1.0, 123456789.123456789, -7.25]
DOUBLE_TINY = [5e-324, 1e-310, 1e-40, 1.4e-45, -7e-43, 2.0 ** -149,
               1e-35, 3e-32]
FLOAT_EDGES = [0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, -1.0, 0.1,
               3.4028234663852886e38, 1.1754943508222875e-38, 123.25]
FLOAT_TINY = [1e-40, 1.4e-45, -1e-39]
STRINGS = ["", "a", "abc", "é", "中文", "🙂x", "a" * 70, "green", " ",
           "WELLS FARGO BANK, N.A."]


def _column(kind, rng, n):
    if kind == "boolean":
        return JT.BOOLEAN, [bool(v) for v in rng.randint(0, 2, n)]
    if kind == "int":
        return JT.INT, [int(v) for v in rng.randint(-2 ** 31, 2 ** 31, n,
                                                    dtype=np.int64)]
    if kind == "long":
        return JT.LONG, [int(v) for v in rng.randint(-2 ** 63, 2 ** 63 - 1,
                                                     n, dtype=np.int64)]
    if kind == "date":
        return JT.DATE, [int(v) for v in rng.randint(-800000, 3000000, n)]
    if kind == "timestamp":
        return JT.TIMESTAMP, [int(v) for v in rng.randint(
            -2 ** 62, 2 ** 62, n, dtype=np.int64)]
    if kind == "float":
        base = [float(np.float32(v)) for v in rng.randn(n) * 100]
        return JT.FLOAT, (base + FLOAT_EDGES)[:max(n, len(FLOAT_EDGES))]
    if kind == "double":
        return JT.DOUBLE, ([float(v) for v in rng.randn(n) * 1e6] +
                           DOUBLE_EDGES)[:max(n, len(DOUBLE_EDGES))]
    if kind == "string":
        return JT.STRING, [STRINGS[i % len(STRINGS)] + str(v)
                           if i % 3 else STRINGS[i % len(STRINGS)]
                           for i, v in enumerate(rng.randint(0, 99, n))]
    raise AssertionError(kind)


KINDS = ["boolean", "int", "long", "date", "timestamp", "float", "double",
         "string"]


def _hash_table(kinds, n, seed, null_every=5):
    rng = np.random.RandomState(seed)
    data = {}
    for j, kind in enumerate(kinds):
        dt, vals = _column(kind, rng, n)
        vals = list(vals)[:n] + [None] * max(0, n - len(vals))
        vals = [None if (i + j) % null_every == 0 else v
                for i, v in enumerate(vals)]
        data[f"c{j}"] = (dt, vals)
    return data


def _hash_all(data, capacity=None):
    names = list(data)
    return _run(data, lambda M, D, H, B: H.Murmur3Hash(
        *[B.ColumnRef(c) for c in names]), capacity=capacity)


@pytest.mark.parametrize("kinds", [[k] for k in KINDS] +
                         [["int", "string"], ["double", "long"],
                          ["string", "date", "boolean"],
                          ["float", "timestamp", "double"]],
                         ids=lambda k: "+".join(k))
def test_murmur3_matches_jax_bit_for_bit(kinds):
    """One to three columns of every hashed type with NULLs: the port's
    device form and host twin equal ``murmur3_cols`` and
    ``murmur3_cols_cpu`` bit for bit."""
    data = _hash_table(kinds, 40, seed=len(kinds) * 31 + KINDS.index(
        kinds[0]))
    (jd, jh), (pd, ph) = _hash_all(data, capacity=64)
    for got in (pd, ph, jd):
        assert got[0].dtype == np.int32
        np.testing.assert_array_equal(got[0], jh[0])
        assert got[1].all()


@pytest.mark.parametrize("kind", ["double", "float"])
def test_murmur3_subnormal_halves(kind):
    """Inputs whose f32 halves are subnormal: the port equals the JAX
    numpy twin; the JAX device form (XLA's CPU flushes f32 subnormals to
    zero) differs from its own twin there and only there."""
    tiny = DOUBLE_TINY if kind == "double" else FLOAT_TINY
    jt = JT.DOUBLE if kind == "double" else JT.FLOAT
    vals = tiny + [1.0, -2.0, 0.0]
    (jd, jh), (pd, ph) = _hash_all({"x": (jt, vals)})
    np.testing.assert_array_equal(pd[0], jh[0])
    np.testing.assert_array_equal(ph[0], jh[0])
    normal = np.zeros(len(vals), dtype=bool)
    normal[len(tiny):] = True
    np.testing.assert_array_equal(jd[0][normal], jh[0][normal])
    # f64 subnormals round to an f32 zero, which XLA keeps
    assert (jd[0][:len(tiny)] != jh[0][:len(tiny)]).any()


def _murmur3_words(words, seed=42):
    """murmur3_x86_32 of 32-bit words in plain Python integers."""
    m = 0xFFFFFFFF
    h = seed
    for k in words:
        k = (k * 0xCC9E2D51) & m
        k = ((k << 15) | (k >> 17)) & m
        h ^= (k * 0x1B873593) & m
        h = ((h << 13) | (h >> 19)) & m
        h = (h * 5 + 0xE6546B64) & m
    h ^= 4 * len(words)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & m
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & m
    h ^= h >> 16
    return h - (1 << 32) if h >= 1 << 31 else h


def test_murmur3_matches_spark():
    """Spark's hash() of INT and LONG values: a plain-Python murmur3,
    which gives Spark's hash(0) = 933211791 and hash(0L) = -1670924195."""
    ints = [0, 1, -1, 42, 2 ** 31 - 1, -2 ** 31]
    (_, _), (pd, ph) = _hash_all({"i": (JT.INT, ints)})
    assert pd[0].tolist() == [_murmur3_words([v & 0xFFFFFFFF])
                              for v in ints]
    assert pd[0][0] == 933211791
    assert ph[0].tolist() == pd[0].tolist()
    longs = [0, 1, -1, 2 ** 63 - 1, -2 ** 63, 1 << 40]
    (_, _), (pd, _) = _hash_all({"l": (JT.LONG, longs)})
    assert pd[0].tolist() == [_murmur3_words(
        [v & 0xFFFFFFFF, (v >> 32) & 0xFFFFFFFF]) for v in longs]
    assert pd[0][0] == -1670924195


def test_murmur3_all_null_row_keeps_the_seed():
    (jd, jh), (pd, ph) = _hash_all({"a": (JT.INT, [None, 1]),
                                    "b": (JT.STRING, [None, None])})
    assert pd[0][0] == 42
    np.testing.assert_array_equal(pd[0], jh[0])
    np.testing.assert_array_equal(ph[0], jh[0])


# ---- to_date --------------------------------------------------------------

DATE_TEXTS = ["2000-01-01", "1999-12-31", "2001-02-28", "2000-02-29",
              "2001-02-29", "2000-02-30", "2000-13-01", "2000-00-10",
              "2000-01-00", "2000-01-32", "0000-01-01", "0001-01-01",
              "9999-12-31", "1969-12-31", "1582-10-10", "2000-1-01",
              "2000-01-1", "20000-01-01", "2000/01/01", "2000-01-01 ",
              " 2000-01-01", "", "x", "2000-01-0a", "２０００-01-01",
              "abcd-ef-gh", "2024-06-15", None, "1900-02-29",
              "2100-02-28"]


def test_to_date_matches_jax():
    (jd, jh), (pd, ph) = _run(
        {"s": (JT.STRING, DATE_TEXTS)},
        lambda M, D, H, B: D.ToDate(B.ColumnRef("s")))
    np.testing.assert_array_equal(pd[1], jd[1])
    np.testing.assert_array_equal(pd[0][pd[1]], jd[0][jd[1]])
    np.testing.assert_array_equal(ph[1], jh[1])
    np.testing.assert_array_equal(ph[0], jh[0])
    # the one place the JAX package's two sides differ: year 0, which
    # its device parses and strptime cannot hold
    year0 = np.array([t == "0000-01-01" for t in DATE_TEXTS])
    assert pd[1][year0].all() and not ph[1][year0].any()
    np.testing.assert_array_equal(pd[1][~year0], ph[1][~year0])
    np.testing.assert_array_equal(pd[0][ph[1]], ph[0][ph[1]])
    import datetime as dt
    for text, ok, day in zip(DATE_TEXTS, ph[1], ph[0]):
        if ok:
            assert (dt.date(1970, 1, 1) +
                    dt.timedelta(days=int(day))).isoformat() == text


def test_to_date_of_a_date_and_other_formats():
    (jd, jh), (pd, ph) = _run(
        {"d": (JT.DATE, [0, -1, 11000, None])},
        lambda M, D, H, B: D.ToDate(B.ColumnRef("d")))
    np.testing.assert_array_equal(pd[0], jd[0])
    np.testing.assert_array_equal(ph[1], jh[1])
    texts = ["01/02/2000", "2000-01-02", "12/31/1999", None, "1/2/2000"]
    (jd, jh), (pd, ph) = _run(
        {"s": (JT.STRING, texts)},
        lambda M, D, H, B: D.ToDate(B.ColumnRef("s"), "MM/dd/yyyy"))
    np.testing.assert_array_equal(ph[0], jh[0])
    np.testing.assert_array_equal(ph[1], jh[1])
    e = PDT.ToDate(PB.ColumnRef("s", T.STRING), "MM/dd/yyyy")
    assert "runs on the host" in e.gpu_supported(None)
    assert PDT.ToDate(PB.ColumnRef("s", T.STRING)).gpu_supported(None) \
        is None


@pytest.mark.cuda
def test_string_hash_on_the_card_equals_the_host_twin():
    """On the card: hash() over a string column (the stringHash kernel
    under murmur3) equals the host twin, and launches the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from spark_rapids_tpu_torch.kernels import cuda_tier
    data = _hash_table(["string", "int", "string"], 3000, seed=5)
    phb = port_host_batch(JaxHostBatch.from_pydict(data))
    dev = host_to_device(phb, "cuda")
    e = PB.resolve(PH.Murmur3Hash(*[PB.ColumnRef(c) for c in data]),
                   phb.schema)
    before = cuda_tier.launch_count("stringHash")
    got = e.gpu_eval(PB.GpuEvalCtx(dev)).data[:3000].cpu().numpy()
    assert cuda_tier.launch_count("stringHash") > before
    want = e.cpu_eval(PB.CpuEvalCtx(phb)).values
    np.testing.assert_array_equal(got, want)
    assert math.isfinite(float(got.astype(np.float64).sum()))
