"""PyTorch port, the host engine: every CPU twin against the JAX package's
twin of the same name, on the CPU, with nothing compiled on either side.

* each ported expression class's ``cpu_eval`` against the JAX class's on
  the same host batch (the port's string columns held as bytes and
  offsets, decoded one ``str`` a row as the twin expects), bit for bit:
  the same dtype, validity and values, NaN equal to NaN and the sign of
  zero kept, NULL rows' placeholder values too;
* each aggregate's ``cpu_reduce`` on the same values bit for bit, and the
  grouped form (``cpu_reduce_groups``) against ``cpu_reduce`` a group;
* each host exec against its JAX twin with ``spark.rapids.sql.enabled``
  off (every operator on the host): filter, project, aggregate keyed and
  keyless, sort, the six join types with and without a condition,
  nested-loop joins, limit, union, range and distinct, over seeded tables
  with NULLs, NaN, signed zeros, strings and dates; rows equal exactly,
  in order;
* all 22 TPC-H texts through both host engines at generator sf 0.1:
  the same columns and rows exactly, in order.
"""

import math
import types as pytypes

import numpy as np
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.benchmarks import datagen as JD
from spark_rapids_tpu.benchmarks import tpch_like as JQ
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.exprs import aggregates as JAg
from spark_rapids_tpu.exprs import arithmetic as JA
from spark_rapids_tpu.exprs import base as JB
from spark_rapids_tpu.exprs import cast as JC
from spark_rapids_tpu.exprs import conditional as JCo
from spark_rapids_tpu.exprs import datetime as JDt
from spark_rapids_tpu.exprs import nullexprs as JN
from spark_rapids_tpu.exprs import predicates as JP
from spark_rapids_tpu.exprs import strings as JS
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch import functions as PF
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.benchmarks import datagen as PD
from spark_rapids_tpu_torch.benchmarks import tpch_like as PQ
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exprs import aggregates as PAg
from spark_rapids_tpu_torch.exprs import arithmetic as PA
from spark_rapids_tpu_torch.exprs import base as PB
from spark_rapids_tpu_torch.exprs import cast as PC
from spark_rapids_tpu_torch.exprs import conditional as PCo
from spark_rapids_tpu_torch.exprs import datetime as PDt
from spark_rapids_tpu_torch.exprs import nullexprs as PN
from spark_rapids_tpu_torch.exprs import predicates as PP
from spark_rapids_tpu_torch.exprs import strings as PS
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from torch_port_util import port_host_batch

HOST = {"spark.rapids.sql.enabled": False}
TPCH_SF = 0.1
JAX_MODS = pytypes.SimpleNamespace(T=JT, A=JA, B=JB, C=JC, Co=JCo, Dt=JDt,
                                   N=JN, P=JP, S=JS, Ag=JAg, F=JF)
PORT_MODS = pytypes.SimpleNamespace(T=T, A=PA, B=PB, C=PC, Co=PCo, Dt=PDt,
                                    N=PN, P=PP, S=PS, Ag=PAg, F=PF)
WORDS = ["", "a", "green", "Brand#13", "été", "中文x",
         "  7 ", "-12", "3.5", "true", "no", "1999-02-28", "NaN", "1e400",
         "2147483648", "gr%en", "a_b"]
I32 = (-(2 ** 31), 2 ** 31 - 1)
I64 = (-(2 ** 63), 2 ** 63 - 1)


def _pick(rng, values, n, null_frac):
    out = [values[i] for i in rng.randint(0, len(values), n)]
    return [None if rng.rand() < null_frac else v for v in out]


def _table(seed: int = 3, n: int = 96):
    """Columns with NULLs and the edge values: INT and LONG bounds, zero
    divisors, NaN, ±inf, -0.0, doubles past the integral bounds, BOOLEAN,
    DATE before and after the epoch, TIMESTAMP, strings with multi-byte
    characters, parseable and unparseable text."""
    rng = np.random.RandomState(seed)
    ints = [0, -1, 1, 7, -7, 3, -3, I32[0], I32[1], 2, 100]
    longs = [0, -1, 5, -5, I64[0], I64[1], 2 ** 40, 3]
    doubles = [0.0, -0.0, 1.5, -2.25, float("nan"), float("inf"),
               -float("inf"), 2.0 ** 63, -(2.0 ** 63), 2.0 ** 31 + 1.0,
               -(2.0 ** 31) - 1.0, 1e300, 7.0, 0.1, 3.0]
    finite = [v for v in doubles if abs(v) < float("inf") or v != v]
    finite = [v for v in finite if abs(v) < 1e300 or v != v]
    return {
        "i": (JT.INT, _pick(rng, ints, n, 0.15)),
        "j": (JT.INT, _pick(rng, ints, n, 0.15)),
        "l": (JT.LONG, _pick(rng, longs, n, 0.15)),
        "m": (JT.LONG, _pick(rng, longs, n, 0.15)),
        "d": (JT.DOUBLE, _pick(rng, doubles, n, 0.15)),
        "e": (JT.DOUBLE, _pick(rng, doubles, n, 0.15)),
        "f": (JT.FLOAT, [None if v is None else float(np.float32(v))
                         for v in _pick(rng, finite, n, 0.15)]),
        # the JAX package's twin cannot cast ±inf to a string
        # (test_cast_infinity_to_string)
        "g": (JT.DOUBLE, _pick(rng, finite, n, 0.15)),
        # nor a DATE outside Python's years 1-9999 (the first of dt's)
        "dn": (JT.DATE, _pick(rng, [0, -1, 10471, 2932896, 59, -365],
                              n, 0.15)),
        "b": (JT.BOOLEAN, _pick(rng, [True, False], n, 0.2)),
        "c": (JT.BOOLEAN, _pick(rng, [True, False], n, 0.2)),
        "dt": (JT.DATE, _pick(rng, [0, -1, 10471, -719468, 2932896, 59,
                                    -365, 11016], n, 0.15)),
        "ts": (JT.TIMESTAMP, _pick(rng, [0, -1, 86_400_000_000 * 10471 + 5,
                                         -86_400_000_001, 1_234_567],
                                   n, 0.15)),
        "s": (JT.STRING, _pick(rng, WORDS, n, 0.2)),
        "t": (JT.STRING, _pick(rng, WORDS, n, 0.2)),
    }


def _ref(M, batch, name):
    f = batch.schema.fields[batch.schema.index_of(name)]
    return M.B.ColumnRef(name, f.dtype, f.nullable)


def _lit(M, v, t=None):
    return M.B.Literal(v, getattr(M.T, t) if t else None)


# (id, builder(M, col, lit) -> expression), resolved against the batch
EXPRS = [
    ("add-int", lambda M, c, l: M.A.Add(c("i"), c("j"))),
    ("add-long-wrap", lambda M, c, l: M.A.Add(c("l"), c("m"))),
    ("subtract-mixed", lambda M, c, l: M.A.Subtract(c("i"), c("d"))),
    ("multiply-long", lambda M, c, l: M.A.Multiply(c("l"), c("m"))),
    ("multiply-float", lambda M, c, l: M.A.Multiply(c("f"), c("i"))),
    ("divide", lambda M, c, l: M.A.Divide(c("i"), c("j"))),
    ("divide-double", lambda M, c, l: M.A.Divide(c("d"), c("e"))),
    ("integral-divide", lambda M, c, l: M.A.IntegralDivide(c("l"), c("i"))),
    ("remainder-int", lambda M, c, l: M.A.Remainder(c("i"), c("j"))),
    ("remainder-double", lambda M, c, l: M.A.Remainder(c("d"), c("e"))),
    ("pmod-int", lambda M, c, l: M.A.Pmod(c("i"), c("j"))),
    ("pmod-long", lambda M, c, l: M.A.Pmod(c("l"), c("m"))),
    ("pmod-double", lambda M, c, l: M.A.Pmod(c("d"), c("e"))),
    ("unary-minus", lambda M, c, l: M.A.UnaryMinus(c("l"))),
    ("abs", lambda M, c, l: M.A.Abs(c("i"))),
    ("abs-double", lambda M, c, l: M.A.Abs(c("d"))),
    ("unary-positive", lambda M, c, l: M.A.UnaryPositive(c("d"))),
    ("equals-double", lambda M, c, l: M.P.Equals(c("d"), c("e"))),
    ("equals-string", lambda M, c, l: M.P.Equals(c("s"), c("t"))),
    ("not-equals-string", lambda M, c, l: M.P.NotEquals(c("s"), l("a"))),
    ("less-than-string", lambda M, c, l: M.P.LessThan(c("s"), c("t"))),
    ("less-equal", lambda M, c, l: M.P.LessThanOrEqual(c("i"), c("l"))),
    ("greater-than-string", lambda M, c, l: M.P.GreaterThan(c("s"),
                                                            l("green"))),
    ("greater-equal-date", lambda M, c, l: M.P.GreaterThanOrEqual(
        c("dt"), l(10471))),
    ("equal-null-safe", lambda M, c, l: M.P.EqualNullSafe(c("i"), c("j"))),
    ("equal-null-safe-string", lambda M, c, l: M.P.EqualNullSafe(c("s"),
                                                                 c("t"))),
    ("and", lambda M, c, l: M.P.And(c("b"), c("c"))),
    ("or", lambda M, c, l: M.P.Or(c("b"), c("c"))),
    ("not", lambda M, c, l: M.P.Not(c("b"))),
    ("in-int", lambda M, c, l: M.P.In(c("i"), [0, 7, None])),
    ("in-string", lambda M, c, l: M.P.In(c("s"), ["a", "green", "x"])),
    ("is-null", lambda M, c, l: M.N.IsNull(c("s"))),
    ("is-not-null", lambda M, c, l: M.N.IsNotNull(c("d"))),
    ("is-nan", lambda M, c, l: M.N.IsNan(c("d"))),
    ("coalesce", lambda M, c, l: M.N.Coalesce(c("i"), c("l"), l(9))),
    ("coalesce-string", lambda M, c, l: M.N.Coalesce(c("s"), c("t"))),
    ("nanvl", lambda M, c, l: M.N.NaNvl(c("d"), c("e"))),
    ("at-least-n", lambda M, c, l: M.N.AtLeastNNonNulls(2, c("d"), c("s"),
                                                        c("i"))),
    ("if", lambda M, c, l: M.Co.If(c("b"), c("i"), c("d"))),
    ("if-string", lambda M, c, l: M.Co.If(c("b"), c("s"), c("t"))),
    ("case-when", lambda M, c, l: M.Co.CaseWhen(
        [(c("b"), c("i")), (c("c"), c("l"))], l(-4))),
    ("case-when-string", lambda M, c, l: M.Co.CaseWhen(
        [(M.N.IsNull(c("s")), c("t"))])),
    ("cast-int-long", lambda M, c, l: M.C.Cast(c("i"), M.T.LONG)),
    ("cast-double-int", lambda M, c, l: M.C.Cast(c("d"), M.T.INT)),
    ("cast-double-long", lambda M, c, l: M.C.Cast(c("d"), M.T.LONG)),
    ("cast-double-byte", lambda M, c, l: M.C.Cast(c("d"), M.T.BYTE)),
    ("cast-float-short", lambda M, c, l: M.C.Cast(c("f"), M.T.SHORT)),
    ("cast-long-float", lambda M, c, l: M.C.Cast(c("l"), M.T.FLOAT)),
    ("cast-bool-int", lambda M, c, l: M.C.Cast(c("b"), M.T.INT)),
    ("cast-int-bool", lambda M, c, l: M.C.Cast(c("i"), M.T.BOOLEAN)),
    ("cast-date-timestamp", lambda M, c, l: M.C.Cast(c("dt"),
                                                     M.T.TIMESTAMP)),
    ("cast-timestamp-date", lambda M, c, l: M.C.Cast(c("ts"), M.T.DATE)),
    ("cast-timestamp-long", lambda M, c, l: M.C.Cast(c("ts"), M.T.LONG)),
    ("cast-double-timestamp", lambda M, c, l: M.C.Cast(c("d"),
                                                       M.T.TIMESTAMP)),
    ("cast-string-int", lambda M, c, l: M.C.Cast(c("s"), M.T.INT)),
    ("cast-string-long", lambda M, c, l: M.C.Cast(c("s"), M.T.LONG)),
    ("cast-string-double", lambda M, c, l: M.C.Cast(c("s"), M.T.DOUBLE)),
    ("cast-string-bool", lambda M, c, l: M.C.Cast(c("s"), M.T.BOOLEAN)),
    ("cast-string-date", lambda M, c, l: M.C.Cast(c("s"), M.T.DATE)),
    ("cast-int-string", lambda M, c, l: M.C.Cast(c("i"), M.T.STRING)),
    ("cast-double-string", lambda M, c, l: M.C.Cast(c("g"), M.T.STRING)),
    ("cast-float-string", lambda M, c, l: M.C.Cast(c("f"), M.T.STRING)),
    ("cast-bool-string", lambda M, c, l: M.C.Cast(c("b"), M.T.STRING)),
    ("cast-date-string", lambda M, c, l: M.C.Cast(c("dn"), M.T.STRING)),
    ("cast-timestamp-string", lambda M, c, l: M.C.Cast(c("ts"),
                                                       M.T.STRING)),
    ("starts-with", lambda M, c, l: M.S.StringStartsWith(c("s"), l("gr"))),
    ("ends-with", lambda M, c, l: M.S.StringEndsWith(c("s"), l("en"))),
    ("contains", lambda M, c, l: M.S.StringContains(c("s"), l("e"))),
    ("contains-column", lambda M, c, l: M.S.StringContains(c("s"), c("t"))),
    ("like-contains", lambda M, c, l: M.S.Like(c("s"), "%re%")),
    ("like-underscore", lambda M, c, l: M.S.Like(c("s"), "gr_en")),
    ("like-prefix-suffix", lambda M, c, l: M.S.Like(c("s"), "B%3")),
    ("like-percent-literal", lambda M, c, l: M.S.Like(c("s"), "gr%en%")),
    ("substring", lambda M, c, l: M.S.Substring(c("s"), 2, 3)),
    ("substring-negative", lambda M, c, l: M.S.Substring(c("s"), -3)),
    ("substring-zero", lambda M, c, l: M.S.Substring(c("s"), 0, 2)),
    ("year", lambda M, c, l: M.Dt.Year(c("dt"))),
    ("month", lambda M, c, l: M.Dt.Month(c("dt"))),
    ("day-of-month", lambda M, c, l: M.Dt.DayOfMonth(c("dt"))),
    ("day-of-week", lambda M, c, l: M.Dt.DayOfWeek(c("dt"))),
    ("day-of-year", lambda M, c, l: M.Dt.DayOfYear(c("dt"))),
    ("quarter", lambda M, c, l: M.Dt.Quarter(c("dt"))),
    ("week-day", lambda M, c, l: M.Dt.WeekDay(c("dt"))),
    ("year-of-timestamp", lambda M, c, l: M.Dt.Year(c("ts"))),
    ("date-add", lambda M, c, l: M.Dt.DateAdd(c("dt"), c("i"))),
    ("date-sub", lambda M, c, l: M.Dt.DateSub(c("dt"), l(400))),
    ("date-diff", lambda M, c, l: M.Dt.DateDiff(c("dt"), l(10000, "DATE"))),
    ("literal-int", lambda M, c, l: l(42)),
    ("literal-null", lambda M, c, l: l(None, "DOUBLE")),
    ("literal-string", lambda M, c, l: l("éx")),
    ("alias", lambda M, c, l: M.B.Alias(c("s"), "z")),
    ("column-string", lambda M, c, l: c("t")),
    ("bound-ref", lambda M, c, l: M.B.BoundRef(3, M.T.LONG)),
]


def _canon(values, dtype_name):
    """Values as comparable Python objects: floats by their bits (NaN
    one value), strings as ``str``."""
    out = []
    for v in np.asarray(values).tolist():
        if isinstance(v, float):
            out.append("nan" if math.isnan(v) else
                       np.float64(v).view(np.int64).item()
                       if dtype_name == "double" else
                       np.float32(v).view(np.int32).item())
        else:
            out.append(v)
    return out


@pytest.fixture(scope="module")
def batches():
    jb = JaxHostBatch.from_pydict(_table())
    return jb, port_host_batch(jb)


@pytest.mark.parametrize("case", [c for c, _ in EXPRS])
def test_cpu_eval_matches_jax(batches, case):
    build = dict(EXPRS)[case]
    jb, pb = batches
    assert any(c.offsets is not None for c in pb.columns)  # bytes+offsets
    want = build(JAX_MODS, lambda n: _ref(JAX_MODS, jb, n),
                 lambda v, t=None: _lit(JAX_MODS, v, t))
    got = build(PORT_MODS, lambda n: _ref(PORT_MODS, pb, n),
                lambda v, t=None: _lit(PORT_MODS, v, t))
    want = JB.resolve(want, jb.schema).cpu_eval(JB.CpuEvalCtx(jb))
    got = PB.resolve(got, pb.schema).cpu_eval(PB.CpuEvalCtx(pb))
    assert got.dtype.name == want.dtype.name
    assert got.validity.dtype == np.bool_
    np.testing.assert_array_equal(got.validity, want.validity)
    if want.dtype.is_string:
        assert [str(v) for v in got.values] == [str(v) for v in want.values]
    else:
        assert np.asarray(got.values).dtype == np.asarray(want.values).dtype
        assert _canon(got.values, got.dtype.name) == \
            _canon(want.values, want.dtype.name)


@pytest.mark.parametrize("name,dtype,values,want", [
    ("d", "DOUBLE", [float("inf"), -float("inf"), 2.5],
     ["Infinity", "-Infinity", "2.5"]),
    ("dt", "DATE", [-719468, 2932896, 0],
     ["0000-03-01", "9999-12-31", "1970-01-01"]),
], ids=["infinity", "year-zero"])
def test_cast_to_string_past_jax_twin(name, dtype, values, want):
    """±inf casts to Spark's "Infinity" and "-Infinity", and a DATE of
    year 0 to its civil date; the JAX package's twin raises
    OverflowError at both (ROADMAP §3)."""
    jb = JaxHostBatch.from_pydict({name: (getattr(JT, dtype), values)})
    pb = port_host_batch(jb)
    with pytest.raises(OverflowError):
        JC.Cast(JB.ColumnRef(name, getattr(JT, dtype)), JT.STRING).cpu_eval(
            JB.CpuEvalCtx(jb))
    got = PC.Cast(PB.ColumnRef(name, getattr(T, dtype)), T.STRING).cpu_eval(
        PB.CpuEvalCtx(pb))
    assert list(got.values) == want


@pytest.mark.parametrize("orders", [
    [("s", True, None)], [("d", False, None), ("i", True, False)],
    [("f", True, False), ("dt", False, True), ("t", True, None)],
    [("b", False, None), ("l", True, None), ("d", True, None)],
], ids=["string", "double-desc", "three-keys", "bool-long-double"])
def test_sort_indices_are_the_row_sort(batches, orders):
    """The host sort's vectorised order equals the JAX twin's: a stable
    Python sort of its rows by its ``sort_key_fn`` (NaN above every
    number, NULLs per ``nulls_first``, strings by their bytes)."""
    from spark_rapids_tpu.ops.cpu_exec import _rows, sort_key_fn
    from spark_rapids_tpu_torch.ops.cpu_exec import sort_indices
    jb, pb = batches
    jso = [JB.SortOrder(JB.ColumnRef(n, jb.schema.field(n).dtype), asc, nf)
           for n, asc, nf in orders]
    pso = [PB.SortOrder(PB.ColumnRef(n, pb.schema.field(n).dtype), asc, nf)
           for n, asc, nf in orders]
    ordinals = [pb.schema.index_of(n) for n, _, _ in orders]
    key = sort_key_fn(jso, ordinals)
    rows = _rows(jb)
    want = sorted(range(len(rows)), key=lambda i: key(rows[i]))
    assert sort_indices(pb, pso, ordinals).tolist() == want


#: strings a trailing NUL tells apart, short and past 32 bytes
NUL_WORDS = ["a", "a\x00", "", "\x00", "a\x00b", "ab", "é", "é\x00",
             "x" * 40, "x" * 40 + "\x00", "x" * 39 + "\x00", None]


@pytest.mark.parametrize("form", ["bytes-offsets", "one-str-a-row"])
def test_string_keys_tell_a_trailing_nul(form):
    """The host engine's string coding, in both forms a string column
    takes on the host: the sort's order is the JAX twin's row sort, and
    the groups are its first-seen key tuples ("a" and "a\\0" apart)."""
    from spark_rapids_tpu.ops.cpu_exec import _rows, sort_key_fn
    from spark_rapids_tpu_torch.batch import HostColumn
    from spark_rapids_tpu_torch.ops.cpu_exec import group_ids, sort_indices
    words = NUL_WORDS * 3
    jb = JaxHostBatch.from_pydict({"s": (JT.STRING, words)})
    pb = port_host_batch(jb)
    if form == "one-str-a-row":
        jc = jb.columns[0]
        pb.columns[0] = HostColumn(T.STRING, jc.values.copy(),
                                   jc.validity.copy())
    assert (pb.columns[0].offsets is None) == (form == "one-str-a-row")
    for asc in (True, False):
        jso = [JB.SortOrder(JB.ColumnRef("s", JT.STRING), asc, None)]
        pso = [PB.SortOrder(PB.ColumnRef("s", T.STRING), asc, None)]
        key = sort_key_fn(jso, [0])
        rows = _rows(jb)
        want = sorted(range(len(rows)), key=lambda i: key(rows[i]))
        assert sort_indices(pb, pso, [0]).tolist() == want
    seen = {}
    want_gid = [seen.setdefault(w, len(seen)) for w in words]
    gid, first, _ = group_ids(pb.columns, len(words))
    assert gid.tolist() == want_gid
    assert first.tolist() == [words.index(w) for w in seen]


# -- aggregates ---------------------------------------------------------------


AGG_INPUTS = {
    "int": (JT.INT, [3, None, -7, I32[1], 5, I32[0], 0]),
    "long-wrap": (JT.LONG, [I64[1], 1, None, 2, I64[0], -1]),
    "double": (JT.DOUBLE, [0.1, 0.2, None, 1e16, -1e16, 0.3, 1.0 / 3.0] * 20),
    "double-nan": (JT.DOUBLE, [1.0, float("nan"), None, -2.0, 0.5]),
    "nan-first": (JT.DOUBLE, [float("nan"), 1.0, -1.0]),
    "signed-zero": (JT.DOUBLE, [0.0, -0.0, None, 0.0]),
    "neg-zero-first": (JT.DOUBLE, [-0.0, 0.0, 2.0]),
    "float": (JT.FLOAT, [0.5, 1.25, None, -3.0]),
    "bool": (JT.BOOLEAN, [True, None, False, True]),
    "date": (JT.DATE, [10471, -5, None, 0]),
    "string": (JT.STRING, ["green", None, "é", "Brand#1", ""]),
    "string-nul": (JT.STRING, ["a\x00", "a", None, "a\x00b", "", "\x00"]),
    "all-null": (JT.DOUBLE, [None, None]),
    "empty": (JT.INT, []),
}
AGGS = ["Sum", "Count", "Min", "Max", "Average"]


def _agg_pair(fn, kind):
    t, values = AGG_INPUTS[kind]
    jcol = JaxHostBatch.from_pydict({"v": (t, values)})
    pcol = port_host_batch(jcol)
    jc, pc = jcol.columns[0], pcol.columns[0]
    jf = getattr(JAg, fn)(JB.ColumnRef("v", t))
    pf = getattr(PAg, fn)(PB.ColumnRef("v", pcol.schema.fields[0].dtype))
    pvals = PB.CpuVal.from_column(pc)
    return jf, pf, (jc.values, jc.validity), (pvals.values, pvals.validity)


def _bits(v):
    """A reduction's result as a comparable value: a float by its bits
    (NaN one value), a numpy scalar as its Python value."""
    if isinstance(v, (float, np.floating)):
        v = float(v)
        return "nan" if math.isnan(v) else np.float64(v).view(np.int64).item()
    if isinstance(v, np.generic):
        return v.item()
    return v


#: every aggregate over every input, but a sum or average of strings
AGG_CASES = [(fn, kind) for fn in AGGS for kind in AGG_INPUTS
             if not (kind.startswith("string") and
                     fn in ("Sum", "Average"))]


@pytest.mark.parametrize("fn,kind", AGG_CASES)
def test_cpu_reduce_matches_jax(fn, kind):
    jf, pf, (jv, jok), (pv, pok) = _agg_pair(fn, kind)
    want, got = jf.cpu_reduce(jv, jok), pf.cpu_reduce(pv, pok)
    assert (got is None) == (want is None)
    assert _bits(got) == _bits(want)
    if not len(jok):
        return
    # the grouped form: groups of 1, 2, 3... rows back to back, each
    # equal to cpu_reduce over the group alone
    starts = np.unique(np.cumsum(np.arange(len(jok))) % len(jok))
    vals, ok = pf.cpu_reduce_groups(pv, pok, starts)
    bounds = list(starts) + [len(jok)]
    for g, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        one = jf.cpu_reduce(jv[a:b], jok[a:b])
        assert bool(ok[g]) == (one is not None), (g, one)
        if one is not None:
            assert _bits(vals[g]) == _bits(one), g


# -- the host execs, as DataFrames with spark.rapids.sql.enabled off ----------


def _exec_tables(types):
    """(left, right) pydicts in one package's ``types``: join keys with
    NULLs, duplicates and a NaN, values with NULLs, strings, dates."""
    rng = np.random.RandomState(11)
    n_l, n_r = 40, 17
    keys = [0, 1, 2, 3, 4, 5]
    fkeys = [0.0, -0.0, 1.5, float("nan"), 2.5]
    left = {"k": (types.LONG, _pick(rng, keys, n_l, 0.1)),
            "fk": (types.DOUBLE, _pick(rng, fkeys, n_l, 0.1)),
            "a": (types.INT, _pick(rng, list(range(-3, 7)), n_l, 0.2)),
            "x": (types.DOUBLE, [None if rng.rand() < 0.1 else
                                 float(np.round(rng.randn() * 100, 3))
                                 for _ in range(n_l)]),
            "s": (types.STRING, _pick(rng, WORDS, n_l, 0.2)),
            "dt": (types.DATE, _pick(rng, [0, 10471, -40, 11000], n_l, 0.1))}
    right = {"k2": (types.LONG, _pick(rng, keys, n_r, 0.1)),
             "fk2": (types.DOUBLE, _pick(rng, fkeys, n_r, 0.1)),
             "b": (types.INT, _pick(rng, list(range(-3, 7)), n_r, 0.2)),
             "t": (types.STRING, _pick(rng, WORDS, n_r, 0.2))}
    return left, right


def _both(settings=None):
    settings = dict(HOST, **(settings or {}))
    return (TpuSparkSession(JaxConf(dict(settings))),
            GpuSparkSession(RapidsConf(dict(settings)), device="cpu"))


def _frames(sess, types):
    left, right = _exec_tables(types)
    return (sess.create_dataframe(left, num_partitions=2),
            sess.create_dataframe(right))


def _q_filter(l, r, F):
    return l.filter((l["a"] > 0) | l["s"].like("%e%"))


def _q_project(l, r, F):
    return l.select((l["a"] * 3).alias("a3"), l["s"],
                    (l["x"] / l["a"]).alias("q"), l["dt"])


def _q_agg_keyed(l, r, F):
    return l.group_by("s", "fk").agg(F.sum("x").alias("sx"),
                                     F.count("a").alias("ca"),
                                     F.avg("a").alias("aa"),
                                     F.min("x").alias("mn"),
                                     F.max("dt").alias("mx"),
                                     F.min("s").alias("ms"))


def _q_agg_keyless(l, r, F):
    return l.agg(F.sum("x").alias("sx"), F.count("*").alias("n"),
                 F.max("s").alias("ms"), F.avg("x").alias("ax"))


def _q_agg_empty(l, r, F):
    return l.filter(l["a"] > 100).agg(F.sum("x").alias("sx"),
                                      F.count("*").alias("n"))


def _q_sort(l, r, F):
    return l.order_by(l["s"].desc(), l["fk"].asc(), l["x"].desc(),
                      l["dt"])


def _q_sort_nulls_last(l, r, F):
    return l.order_by(l["x"].asc(nulls_first=False), l["a"])


def _q_limit(l, r, F):
    return l.limit(7)


def _q_union(l, r, F):
    return l.select("k", "s").union(r.select("k2", "t"))


def _q_distinct(l, r, F):
    return l.select("s", "fk").distinct()


def _nul_frame(l, F):
    types = JT if F is JF else T
    return l.session.create_dataframe({
        "s": (types.STRING, NUL_WORDS * 2),
        "v": (types.INT, list(range(2 * len(NUL_WORDS))))})


def _q_nul_strings_group(l, r, F):
    n = _nul_frame(l, F)
    # no min/max of s here: the JAX twin's exec packs a group's strings
    # into a numpy str array, which drops a trailing NUL (ROADMAP §3);
    # test_cpu_reduce_matches_jax holds the reductions themselves
    return n.group_by("s").agg(F.count("v").alias("n"),
                               F.min("v").alias("mv"))


def _q_nul_strings_sort(l, r, F):
    n = _nul_frame(l, F)
    return n.order_by(n["s"].desc(), n["v"])


def _q_nul_strings_join(l, r, F):
    n, m = _nul_frame(l, F), _nul_frame(l, F)
    m = m.select(m["s"].alias("s2"), m["v"].alias("v2"))
    return n.join(m, on=n["s"] == m["s2"], how="full")


def _q_range(l, r, F):
    sess = l.session
    return sess.range(3, 40, 4, num_partitions=3).union(sess.range(-5))


def _join(how, cond):
    def q(l, r, F):
        on = l["k"] == r["k2"]
        if cond:
            on = on & ((l["a"] < r["b"]) | (l["s"] == r["t"]))
        return l.join(r, on=on, how=how)
    return q


def _join_float(l, r, F):
    return l.join(r, on=l["fk"] == r["fk2"], how="full")


def _nested(how):
    def q(l, r, F):
        if how == "cross":
            return l.cross_join(r)
        return l.join(r, on=(l["a"] < r["b"]) | (l["s"] == r["t"]),
                      how=how)
    return q


HOWS = ["inner", "left", "right", "full", "left_semi", "left_anti"]
EXEC_QUERIES = dict(
    [("filter", _q_filter), ("project", _q_project),
     ("aggregate-keyed", _q_agg_keyed), ("aggregate-keyless", _q_agg_keyless),
     ("aggregate-empty", _q_agg_empty), ("sort", _q_sort),
     ("sort-nulls-last", _q_sort_nulls_last), ("limit", _q_limit),
     ("union", _q_union), ("distinct", _q_distinct), ("range", _q_range),
     ("join-float-keys", _join_float),
     ("nul-strings-group", _q_nul_strings_group),
     ("nul-strings-sort", _q_nul_strings_sort),
     ("nul-strings-join", _q_nul_strings_join)] +
    [(f"join-{h}", _join(h, False)) for h in HOWS] +
    [(f"join-{h}-condition", _join(h, True)) for h in HOWS] +
    [(f"nested-loop-{h}", _nested(h)) for h in HOWS + ["cross"]])


@pytest.mark.parametrize("case", list(EXEC_QUERIES))
def test_host_exec_matches_jax(case):
    """Every operator of the query on the host in both packages; rows
    equal exactly, in order (repr: NaN equal to NaN, -0.0 apart from
    0.0)."""
    q = EXEC_QUERIES[case]
    jsess, psess = _both()
    want = q(*_frames(jsess, JT), JF)
    got = q(*_frames(psess, T), PF)
    assert got.columns == want.columns
    rows = got.collect()
    assert repr(rows) == repr(want.collect())
    tree = psess.last_physical_plan.tree_string()
    assert "Gpu" not in tree and "HostToDevice" not in tree, tree
    if case not in ("aggregate-empty", "nested-loop-left_semi"):
        assert rows, case


# -- all 22 TPC-H texts on both host engines ----------------------------------


@pytest.fixture(scope="module")
def tpch_host_rows():
    """The JAX package's host engine over every text, once."""
    sess = TpuSparkSession(JaxConf(dict(HOST)))
    JD.register_tpch(sess, sf=TPCH_SF, num_partitions=3)
    out = {}
    for q in JQ.QUERIES:
        df = sess.sql(JQ.QUERIES[q])
        out[q] = (df.columns, df.collect())
    return out


@pytest.fixture(scope="module")
def port_host_session():
    sess = GpuSparkSession(RapidsConf(dict(HOST)), device="cpu")
    PD.register_tpch(sess, sf=TPCH_SF, num_partitions=3)
    return sess


@pytest.mark.parametrize("query", sorted(PQ.QUERIES,
                                         key=lambda q: int(q[1:])))
def test_tpch_host_engine_matches_jax(tpch_host_rows, port_host_session,
                                      query):
    want_cols, want_rows = tpch_host_rows[query]
    df = port_host_session.sql(PQ.QUERIES[query])
    assert df.columns == want_cols
    assert repr(df.collect()) == repr(want_rows)
    tree = port_host_session.last_physical_plan.tree_string()
    assert "Gpu" not in tree and "HostToDevice" not in tree
