"""PyTorch port, the string functions that build strings on the device
(``exprs/strings.py``: ``build_string`` and the functions over it) against
the JAX package on the same numpy inputs.

Each function runs four ways: the JAX package's device form (``tpu_eval``
on jax's CPU backend) and host twin (``cpu_eval``), and the port's device
form (``gpu_eval`` on CPU tensors) and host twin.  Device forms are held
bit for bit: validity, offsets, and every byte up to the live total (the
port's bytes past it are 0; the JAX package's replace may leave a dead
row's bytes there).  Host twins are held row for row where valid, with
the same validity.  The two sides of one package may disagree: the device
counts UTF-8 bytes where the host counts characters (``length``,
``locate``), the port follows each.  Inputs: empty strings, NULLs, spaces
at both ends, runs of a delimiter, multi-byte UTF-8, rows past
``num_rows`` (``take_head``), and a random column from a seeded
generator.
"""

import jax
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.batch import host_to_device as jax_h2d
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.exprs import base as JB
from spark_rapids_tpu.exprs import strings as JS
from spark_rapids_tpu.kernels import layout as JL
from spark_rapids_tpu.plan.overrides import ExprMeta as JaxExprMeta

from spark_rapids_tpu_torch.batch import host_to_device
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exprs import base as PB
from spark_rapids_tpu_torch.exprs import strings as PS
from spark_rapids_tpu_torch.kernels import layout as PL
from spark_rapids_tpu_torch.plan.overrides import ExprMeta

from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread, port_host_batch,
)

FIXED = ["  Hello world ", "", None, "a#b#c", "xx yy zz", "é中 a",
         "   ", "##", "aaaa", "The Green-ed fox", "abc" * 30, " x ",
         "#lead#", "tail#", "ed", "a.b.c", None, "mIxEd CaSe wOrds", "a  b"]
WORDS = ["a", "b", "ed", "#", " ", "  ", "Zq", "é", "xyz", "AB"]


def _column(seed: int, n: int = 60):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if rng.rand() < 0.1:
            out.append(None)
            continue
        out.append("".join(rng.choice(WORDS, rng.randint(0, 7))))
    return out


def _table(seed: int = 0):
    s = FIXED + _column(seed)
    t = list(reversed(s))
    i = [None if k % 11 == 3 else int(v) for k, v in enumerate(
        np.random.RandomState(seed + 1).randint(-10 ** 6, 10 ** 6, len(s)))]
    i[:4] = [0, -1, 2 ** 31 - 1, -2 ** 31]
    big = [None if v is None else v * 4_000_000_007 for v in i]
    big[:3] = [-(2 ** 63), 2 ** 63 - 1, 255]
    return {"s": (JT.STRING, s), "t": (JT.STRING, t), "i": (JT.INT, i),
            "l": (JT.LONG, big)}


def _run(make, num_rows=None, seed=0):
    """((JAX device, JAX host), (port device, port host)) of
    ``make(strings module, base module, column)`` over the same table."""
    jb = JaxHostBatch.from_pydict(_table(seed))
    phb = port_host_batch(jb)
    jdev, pdev = jax_h2d(jb), host_to_device(phb, "cpu")
    if num_rows is not None:
        jdev, pdev = JL.take_head(jdev, num_rows), PL.take_head(pdev,
                                                                 num_rows)
    je = JB.resolve(make(JS, JB, JB.ColumnRef), jb.schema)
    pe = PB.resolve(make(PS, PB, PB.ColumnRef), phb.schema)
    jd = je.tpu_eval(JB.TpuEvalCtx(jdev))
    pd = pe.gpu_eval(PB.GpuEvalCtx(pdev))
    jh = je.cpu_eval(JB.CpuEvalCtx(jb))
    ph = pe.cpu_eval(PB.CpuEvalCtx(phb))
    return (jd, jh), (pd, ph), pe


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(jax.device_get(x))


def assert_same_device(jd, pd):
    """Validity and offsets equal; string bytes equal to the live total,
    the port's 0 past it; other values equal where valid."""
    jv, pv = _np(jd.validity), _np(pd.validity)
    np.testing.assert_array_equal(pv, jv)
    if jd.offsets is not None:
        jo, po = _np(jd.offsets), _np(pd.offsets)
        np.testing.assert_array_equal(po, jo)
        total = int(po[-1])
        jdat, pdat = _np(jd.data), _np(pd.data)
        assert pdat.dtype == np.uint8
        np.testing.assert_array_equal(pdat[:total], jdat[:total])
        assert not pdat[total:].any()
        return
    jdat, pdat = _np(jd.data), _np(pd.data)
    assert pdat.dtype == jdat.dtype
    np.testing.assert_array_equal(pdat[pv], jdat[jv])


def assert_same_host(jh, ph):
    np.testing.assert_array_equal(ph.validity, jh.validity)
    ok = np.asarray(ph.validity)
    assert list(np.asarray(ph.values)[ok]) == list(np.asarray(jh.values)[ok])


def _lit(B, v):
    return B.Literal(v)


CASES = {
    "length": lambda S, B, c: S.Length(c("s")),
    "upper": lambda S, B, c: S.Upper(c("s")),
    "lower": lambda S, B, c: S.Lower(c("s")),
    "initcap": lambda S, B, c: S.InitCap(c("s")),
    "trim": lambda S, B, c: S.StringTrim(c("s")),
    "ltrim": lambda S, B, c: S.StringTrimLeft(c("s")),
    "rtrim": lambda S, B, c: S.StringTrimRight(c("s")),
    "concat": lambda S, B, c: S.ConcatStrings(c("s"), _lit(B, "-"), c("t")),
    "concat-one": lambda S, B, c: S.ConcatStrings(c("t")),
    "locate": lambda S, B, c: S.StringLocate(_lit(B, "ed"), c("s")),
    "locate-empty": lambda S, B, c: S.StringLocate(_lit(B, ""), c("s")),
    "locate-multibyte": lambda S, B, c: S.StringLocate(
        _lit(B, "é"), c("s")),
    "replace": lambda S, B, c: S.StringReplace(c("s"), "#", "++"),
    "replace-shrink": lambda S, B, c: S.StringReplace(c("s"), "ab", ""),
    "replace-same": lambda S, B, c: S.StringReplace(c("s"), "ed", "de"),
    "lpad": lambda S, B, c: S.StringLPad(c("s"), 6, "*"),
    "rpad": lambda S, B, c: S.StringRPad(c("s"), 4, "0"),
    "lpad-zero": lambda S, B, c: S.StringLPad(c("s"), 0),
    "regexp-literal": lambda S, B, c: S.RegExpReplace(c("s"), "#", "-"),
    "regexp-escaped": lambda S, B, c: S.RegExpReplace(c("s"), "\\.", ""),
    "regexp-class": lambda S, B, c: S.RegExpReplace(c("s"), "[a-c]", "XY"),
    "regexp-class-escaped": lambda S, B, c: S.RegExpReplace(
        c("s"), "[\\.x-z]", "#"),
    "split-part-1": lambda S, B, c: S.SplitPart(c("s"), " ", 1),
    "split-part-3": lambda S, B, c: S.SplitPart(c("s"), " ", 3),
    "split-part-hash": lambda S, B, c: S.SplitPart(c("s"), "#", 2),
    "concat-ws": lambda S, B, c: S.ConcatWs("-", c("s"), c("t")),
    "concat-ws-empty-sep": lambda S, B, c: S.ConcatWs("", c("s"), c("t"),
                                                      c("s")),
    "concat-ws-none": lambda S, B, c: S.ConcatWs(","),
    "substring-index-1": lambda S, B, c: S.SubstringIndex(c("s"), " ", 1),
    "substring-index--1": lambda S, B, c: S.SubstringIndex(c("s"), " ", -1),
    "substring-index-2": lambda S, B, c: S.SubstringIndex(c("s"), "#", 2),
    "substring-index--2": lambda S, B, c: S.SubstringIndex(c("s"), "#", -2),
    "substring-index-0": lambda S, B, c: S.SubstringIndex(c("s"), " ", 0),
    "hex-int": lambda S, B, c: S.Hex(c("i")),
    "hex-long": lambda S, B, c: S.Hex(c("l")),
    "chain": lambda S, B, c: S.Upper(S.SplitPart(S.StringTrim(
        S.ConcatWs(" ", c("s"), c("t"))), " ", 2)),
}

@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("num_rows", [None, 50], ids=["all", "head"])
def test_string_function_matches_jax(case, num_rows):
    (jd, jh), (pd, ph), pe = _run(CASES[case], num_rows)
    assert pe.gpu_supported(RapidsConf({})) is None
    assert_same_device(jd, pd)
    assert_same_host(jh, ph)


def test_bytes_past_the_total_are_zero_and_offsets_flat():
    """A built column past ``num_rows``: offsets constant, bytes past the
    live total 0 (what stringHash and the merge concat read)."""
    for case in ("concat", "replace", "lpad", "concat-ws", "hex-long",
                 "regexp-class"):
        _, (pd, _), _ = _run(CASES[case], num_rows=40)
        off = pd.offsets.numpy()
        assert (off[40:] == off[40]).all()
        assert not pd.data.numpy()[off[-1]:].any()


def test_random_columns_match_jax():
    for seed in (3, 4):
        for case in ("replace", "split-part-3", "substring-index--2",
                     "concat-ws", "trim", "initcap"):
            (jd, jh), (pd, ph), _ = _run(CASES[case], seed=seed)
            assert_same_device(jd, pd)
            assert_same_host(jh, ph)


def test_split_is_host_only_and_matches_jax():
    jb = JaxHostBatch.from_pydict(_table())
    phb = port_host_batch(jb)
    je = JB.resolve(JS.StringSplit(JB.ColumnRef("s"), "#"), jb.schema)
    pe = PB.resolve(PS.StringSplit(PB.ColumnRef("s"), "#"), phb.schema)
    jh = je.cpu_eval(JB.CpuEvalCtx(jb))
    ph = pe.cpu_eval(PB.CpuEvalCtx(phb))
    assert list(ph.values) == list(jh.values)
    np.testing.assert_array_equal(ph.validity, jh.validity)
    assert ExprMeta(pe, RapidsConf({})).reasons == [
        "expression StringSplit has no GPU implementation"]
    assert "array<string>" in pe.gpu_supported(RapidsConf({}))


def _reasons(make, cols):
    """(JAX reasons with TPU read as GPU, port reasons) of one expression
    resolved over a schema of ``cols`` (name -> type name)."""
    from spark_rapids_tpu_torch import types as T
    jschema = JT.Schema([JT.Field(n, getattr(JT, t)) for n, t in cols])
    pschema = T.Schema([T.Field(n, getattr(T, t)) for n, t in cols])
    je = JB.resolve(make(JS, JB, JB.ColumnRef), jschema)
    pe = PB.resolve(make(PS, PB, PB.ColumnRef), pschema)
    want = [r.replace("TPU", "GPU")
            for r in JaxExprMeta(je, JaxConf({})).reasons]
    return want, ExprMeta(pe, RapidsConf({})).reasons


HOST_CASES = {
    "locate-column-needle": lambda S, B, c: S.StringLocate(c("t"), c("s")),
    "replace-empty": lambda S, B, c: S.StringReplace(c("s"), "", "x"),
    "replace-overlap": lambda S, B, c: S.StringReplace(c("s"), "aa", "b"),
    "replace-column": lambda S, B, c: S.StringReplace(c("s"), c("t"), "b"),
    "pad-multi": lambda S, B, c: S.StringLPad(c("s"), 5, "ab"),
    "regexp-real": lambda S, B, c: S.RegExpReplace(c("s"), "a+", "b"),
    "regexp-negated": lambda S, B, c: S.RegExpReplace(c("s"), "[^a]", "b"),
    "regexp-overlap": lambda S, B, c: S.RegExpReplace(c("s"), "aba", "b"),
    "split-part-negative": lambda S, B, c: S.SplitPart(c("s"), " ", -1),
    "split-part-empty": lambda S, B, c: S.SplitPart(c("s"), "", 1),
    "split-part-overlap": lambda S, B, c: S.SplitPart(c("s"), "##", 1),
    "concat-ws-int": lambda S, B, c: S.ConcatWs("-", c("s"), c("i")),
    "substring-index-empty": lambda S, B, c: S.SubstringIndex(c("s"), "", 1),
    "substring-index-overlap": lambda S, B, c: S.SubstringIndex(
        c("s"), "aa", 1),
    "hex-double": lambda S, B, c: S.Hex(c("d")),
    "hex-string": lambda S, B, c: S.Hex(c("s")),
    "split": lambda S, B, c: S.StringSplit(c("s"), " "),
}
COLS = [("s", "STRING"), ("t", "STRING"), ("i", "INT"), ("l", "LONG"),
        ("d", "DOUBLE")]


@pytest.mark.parametrize("case", list(CASES) + list(HOST_CASES))
def test_placement_and_reason_match_jax(case):
    """Over string inputs each function is on the device exactly where the
    JAX package's planner puts it on its device, and a host placement
    gives the JAX package's reason (TPU read as GPU)."""
    make = CASES.get(case) or HOST_CASES[case]
    want, got = _reasons(make, COLS)
    assert got == want
    assert bool(got) == (case in HOST_CASES)


@pytest.mark.parametrize("make", [
    lambda S, B, c: S.Upper(c("i")),
    lambda S, B, c: S.Length(c("i")),
    lambda S, B, c: S.StringTrim(c("d")),
    lambda S, B, c: S.ConcatStrings(c("s"), c("i")),
    lambda S, B, c: S.SplitPart(c("i"), " ", 1),
], ids=["upper", "length", "trim", "concat", "split-part"])
def test_non_string_input_stays_on_the_host(make):
    """A string function over a non-string has no string bytes to read:
    the port places it on the host, where the JAX package's device form
    would read a numeric buffer as bytes (ROADMAP, differences of
    design)."""
    want, got = _reasons(make, COLS)
    assert want == [] and len(got) == 1 and "not a string" in got[0]


def test_built_column_capacity_checked():
    """Offsets are int32: a built column of 2^31 bytes or more raises
    rather than wrapping."""
    lens = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 offsets"):
        PS.build_string(lens, None, 1 << 31, torch.ones(4, dtype=torch.bool))
