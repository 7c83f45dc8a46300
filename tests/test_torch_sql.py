"""PyTorch port: the SQL front end and the expressions it reaches, against
the JAX package on the CPU.

* the lexer's tokens over every query text of the JAX package's
  ``benchmarks/tpch_like.py``, and the port's seven verbatim copies;
* the parser's plans: output names (``_c<i>``, aliases, the hidden
  ``__agg_i``/``__having_i`` columns), HAVING, arithmetic over aggregates,
  DISTINCT, CTEs and subqueries, ORDER BY a computed expression and by a
  renamed column, aggregation without keys; rows and plan shapes equal;
* every construct the port lacks raises, naming it, "not ported yet";
  a string cast and a float group key while NaNs are possible run on the
  host instead, with the JAX package's rows;
* each expression module's new expressions in one projection per module
  (one JAX compile each) over seeded inputs with NULLs and the edge values
  of Java's integer rules: mixed-sign division, ``x / 0``, ``x % 0``,
  ``Long.MIN_VALUE``, NaN, ±inf, ±2^63 and ±2^31 ± 1 casts, Kleene truth
  tables.  Elementwise results are compared bit for bit (NaN equal to NaN,
  the sign of zero kept);
* aggregation without keys over several batches, over input a filter
  empties, over no batch at all, and over a NaN (the sort-path fallback).
  Sums and averages within 1e-9 relative: XLA on the CPU fuses the slot
  aggregate's per-chunk scale into the cross-chunk sum as an FMA under jit,
  where torch rounds the product first; counts and keys exact.
"""

import math
import struct
import types as pytypes

import numpy as np
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.benchmarks import tpch_like as JQ
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.dataframe import Column as JaxColumn
from spark_rapids_tpu.dataframe import DataFrame as JaxDataFrame
from spark_rapids_tpu.exprs import arithmetic as JA
from spark_rapids_tpu.exprs import base as JB
from spark_rapids_tpu.exprs import cast as JC
from spark_rapids_tpu.exprs import conditional as JCo
from spark_rapids_tpu.exprs import nullexprs as JN
from spark_rapids_tpu.exprs import predicates as JP
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.plan.logical import InMemoryScan as JaxScan
from spark_rapids_tpu.plan.overrides import TpuOverrides
from spark_rapids_tpu.session import TpuSparkSession
from spark_rapids_tpu.sql.lexer import tokenize as jax_tokenize

from spark_rapids_tpu_torch import functions as PF
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.benchmarks import datagen as PD
from spark_rapids_tpu_torch.benchmarks import tpch_like as PQ
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.dataframe import Column, DataFrame
from spark_rapids_tpu_torch.exprs import arithmetic as PA
from spark_rapids_tpu_torch.exprs import base as PB
from spark_rapids_tpu_torch.exprs import cast as PC
from spark_rapids_tpu_torch.exprs import conditional as PCo
from spark_rapids_tpu_torch.exprs import nullexprs as PN
from spark_rapids_tpu_torch.exprs import predicates as PP
from spark_rapids_tpu_torch.plan.logical import InMemoryScan
from spark_rapids_tpu_torch.session import GpuSparkSession
from spark_rapids_tpu_torch.sql.lexer import tokenize

from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread, plan_shape, port_host_batch,
)

SETTINGS = {"spark.rapids.sql.variableFloatAgg.enabled": True,
            "spark.sql.shuffle.partitions": 1,
            "spark.rapids.sql.hasNans": False}
REL = 1e-9
I32 = (-(2 ** 31), 2 ** 31 - 1)
I64 = (-(2 ** 63), 2 ** 63 - 1)

JAX_NS = pytypes.SimpleNamespace(A=JA, B=JB, C=JC, Co=JCo, N=JN, P=JP, T=JT)
PORT_NS = pytypes.SimpleNamespace(A=PA, B=PB, C=PC, Co=PCo, N=PN, P=PP, T=T)


def _same(g, w) -> bool:
    """Bit-for-bit equality of two collected values: NaN equals NaN and
    the sign of a float zero counts."""
    if isinstance(w, float) and isinstance(g, float):
        return struct.pack("<d", g) == struct.pack("<d", w) or (
            math.isnan(g) and math.isnan(w))
    return type(g) is type(w) and g == w


def _close(g, w) -> bool:
    if isinstance(w, float) and isinstance(g, float):
        return (math.isnan(g) and math.isnan(w)) or math.isclose(
            g, w, rel_tol=REL, abs_tol=0.0)
    return type(g) is type(w) and g == w


def assert_rows(got, want, same=_same):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        for j, (gv, wv) in enumerate(zip(g, w)):
            assert same(gv, wv), (i, j, gv, wv)


def _sessions():
    return (TpuSparkSession(JaxConf(SETTINGS)),
            GpuSparkSession(RapidsConf(SETTINGS), device="cpu"))


def _frames(pydict, batch_rows=None):
    """The same table as a JAX and a port DataFrame, cut into batches of
    ``batch_rows`` rows (one batch by default); ``pydict`` holds JAX
    types."""
    js, ps = _sessions()
    n = len(next(iter(pydict.values()))[1])
    step = batch_rows or max(n, 1)
    jbs = [JaxHostBatch.from_pydict({k: (t, list(v)[s:s + step])
                                     for k, (t, v) in pydict.items()})
           for s in range(0, n, step)]
    pbs = [port_host_batch(b) for b in jbs]
    jdf = JaxDataFrame(JaxScan(jbs, jbs[0].schema, 1), js)
    pdf = DataFrame(InMemoryScan(pbs, pbs[0].schema, 1), ps)
    return jdf, pdf


# -- lexer and the query texts ----------------------------------------------


def test_lexer_tokens_match_jax():
    for name, text in JQ.QUERIES.items():
        want = [(t.kind, t.value, t.pos) for t in jax_tokenize(text)]
        assert [(t.kind, t.value, t.pos) for t in tokenize(text)] == want, \
            name


def test_port_queries_are_the_reference_texts():
    assert sorted(PQ.QUERIES) == sorted(JQ.QUERIES)  # all 22
    for name, text in PQ.QUERIES.items():
        assert text == JQ.QUERIES[name], name


# -- the parser's plans against the JAX package's ----------------------------


def _table(rng, n):
    a = rng.randint(-5, 12, n)
    b = rng.randint(0, 6, n)
    d = (rng.rand(n) * 100 - 30).round(3)
    s = rng.choice(["bb", "apple", "", "zed", "é中"], n)
    return {
        "k": (JT.LONG, list(range(n))),
        "a": (JT.INT, [None if i % 7 == 3 else int(v)
                       for i, v in enumerate(a)]),
        "b": (JT.LONG, [None if i % 5 == 1 else int(v)
                        for i, v in enumerate(b)]),
        "d": (JT.DOUBLE, [None if i % 9 == 4 else float(v)
                          for i, v in enumerate(d)]),
        "s": (JT.STRING, [None if i % 11 == 6 else str(v)
                          for i, v in enumerate(s)]),
    }


SQL_CASES = {
    "select-names": "SELECT k, a + b, d * 2 AS dd, -a, a % 3, a / b, "
                    "CASE WHEN a > 0 THEN d WHEN a < -2 THEN -d END AS c, "
                    "if(b > 2, 1, 0) AS f, coalesce(b, 0) AS g, "
                    "abs(a) AS h, isnull(s) AS i FROM t "
                    "WHERE NOT (a > 8 OR b IS NULL) AND s IN ('bb', 'apple') "
                    "AND a BETWEEN -3 AND 10 AND s <> 'zed' ORDER BY k",
    "having-postagg": "SELECT s, count(*), sum(a) / count(*) AS ratio, "
                      "max(d) FROM t GROUP BY s HAVING count(*) > 2 "
                      "AND min(b) >= 0 ORDER BY s",
    "order": "SELECT k AS x, a, b FROM t WHERE a IS NOT NULL "
             "AND b IS NOT NULL ORDER BY a * 100 + b DESC, k LIMIT 9",
    "distinct": "SELECT DISTINCT s, b FROM t ORDER BY s, b",
    "cte-subquery": "WITH u AS (SELECT a, s, d FROM t WHERE a IS NOT NULL) "
                    "SELECT s, min(a) AS m, avg(d) FROM (SELECT * FROM u "
                    "WHERE d > 0) v GROUP BY s ORDER BY s",
    "keyless": "SELECT sum(d) AS total, count(*), avg(a), min(s IS NULL) "
               "FROM t WHERE b > 0",
    "join": "SELECT k, a, w FROM t JOIN (SELECT a AS wa, max(k) AS w "
            "FROM t GROUP BY a) m ON a = wa ORDER BY k",
}


@pytest.fixture(scope="module")
def sql_frames():
    rng = np.random.RandomState(7)
    return _frames(_table(rng, 240), batch_rows=64)


@pytest.mark.parametrize("case", list(SQL_CASES))
def test_sql_plan_matches_jax(sql_frames, case):
    jdf, pdf = sql_frames
    jdf.create_or_replace_temp_view("t")
    pdf.create_or_replace_temp_view("t")
    text = SQL_CASES[case]
    jq, pq = jdf.session.sql(text), pdf.session.sql(text)
    assert pq.columns == jq.columns
    want = jq.collect()
    assert want
    assert_rows(pq.collect(), want, same=_close)
    jplan = TpuOverrides(JaxConf(dict(
        SETTINGS, **{"spark.rapids.sql.fusion.enabled": False}))).apply(
            jq.plan)
    assert plan_shape(pdf.session.last_physical_plan) == plan_shape(jplan)


def _column_ops(df, F):
    a, b, d, s = df["a"], df["b"], df["d"], df["s"]
    return df.select(
        (a + b).alias("add"), (1 + a).alias("radd"), (a - 2).alias("sub"),
        (10 - a).alias("rsub"), (3 * d).alias("rmul"), (a / b).alias("div"),
        (a % 3).alias("mod"), (-d).alias("neg"), (a != b).alias("ne"),
        (a >= b).alias("ge"), ((a > 3) | (b < 2)).alias("or"),
        (~(a > 3)).alias("not"), a.isin(1, 2, 3).alias("isin"),
        s.isin(["bb", "zed"]).alias("s_isin"), a.between(0, 5).alias("btw"),
        a.is_null().alias("a_null"), s.is_not_null().alias("s_set"),
        d.cast("int").alias("d_int"),
        F.when(a > 0, d).when(a < -2, F.lit(-1.0)).otherwise(F.lit(0.0))
        .alias("case"), F.when(b > 2, a).column.alias("case_no_else"),
        F.lit(7).alias("seven"))


def test_column_operators_and_functions_match_jax(sql_frames):
    """The Column operators and ``lit``/``when``/``otherwise`` build the
    JAX package's expressions: same names, types and values."""
    jdf, pdf = sql_frames
    jq, pq = _column_ops(jdf, JF), _column_ops(pdf, PF)
    assert [(f.name, f.dtype.name) for f in pq.schema] == \
        [(f.name, f.dtype.name) for f in jq.schema]
    assert_rows(pq.collect(), jq.collect())


# -- refusals -----------------------------------------------------------------


def _refusal_session():
    sess = GpuSparkSession(RapidsConf(SETTINGS), device="cpu")
    sess.create_dataframe({"a": (T.INT, [1, 2]), "d": (T.DOUBLE, [1.0, 2.0]),
                           "s": (T.STRING, ["x", "y"])}
                          ).create_or_replace_temp_view("t")
    return sess


REFUSED = {
    "window": "SELECT a, row_number() OVER (ORDER BY a) FROM t",
    "window-agg": "SELECT a, sum(d) OVER (PARTITION BY a) FROM t",
    "explode": "SELECT explode(a) FROM t",
    "grouping-sets": "SELECT a, count(*) FROM t GROUP BY GROUPING SETS "
                     "((a), ())",
    "rollup": "SELECT a, count(*) FROM t GROUP BY ROLLUP (a)",
    "cube": "SELECT a, count(*) FROM t GROUP BY CUBE (a)",
    "union": "SELECT a FROM t UNION ALL SELECT a FROM t",
    "intersect": "SELECT a FROM t INTERSECT SELECT a FROM t",
    "except": "SELECT a FROM t EXCEPT SELECT a FROM t",
    "cast-to-string": "SELECT CAST(a AS string) FROM t",
    "cast-from-string": "SELECT CAST(s AS int) FROM t",
    "time-part": "SELECT hour(a) FROM t",
    "date-format": "SELECT date_format(a, 'yyyy') FROM t",
    "string-length": "SELECT length(s) FROM t",
    "math": "SELECT sqrt(d) FROM t",
    "string-function": "SELECT upper(s) FROM t",
    "concat-op": "SELECT s || s FROM t",
    "float-group-key": "SELECT d, count(*) FROM t GROUP BY d",
}


#: the REFUSED cases the planner now places on the host (the reason its
#: explain line gives), as the JAX package does
FALLS_BACK = {"cast-to-string": "involves a string conversion (CPU only)",
              "cast-from-string": "involves a string conversion (CPU only)",
              "float-group-key": "grouping by floating point when NaNs "
                                 "are possible"}


def _fallback_sessions(case):
    """(port, JAX) sessions over the same view ``t`` for a FALLS_BACK
    case: SETTINGS, or the defaults for the float key (hasNans on)."""
    settings = {} if case == "float-group-key" else SETTINGS
    data = {"d": [1.0, float("nan"), 1.0, -0.0, 0.0, None]} \
        if case == "float-group-key" else \
        {"a": [1, 2, None], "s": ["7", " 8 ", "x"]}
    types = {"a": "INT", "d": "DOUBLE", "s": "STRING"}
    psess = GpuSparkSession(RapidsConf(settings), device="cpu")
    jsess = TpuSparkSession(JaxConf(settings))
    psess.create_dataframe({k: (getattr(T, types[k]), v)
                            for k, v in data.items()}
                           ).create_or_replace_temp_view("t")
    jsess.create_dataframe({k: (getattr(JT, types[k]), v)
                            for k, v in data.items()}
                           ).create_or_replace_temp_view("t")
    return psess, jsess


#: the REFUSED cases the port has since ported (windows, grouping sets,
#: set operations, the math and string functions, ``||``): they run, and
#: the rows equal the JAX package's
PORTED = ("window", "window-agg", "grouping-sets", "rollup", "cube",
          "union", "intersect", "except", "math", "string-length",
          "string-function", "concat-op")

#: ported cases the JAX package cannot run: ``hour`` of an INT (its numpy
#: and jax forms overflow int32 at the day's microseconds) gives the
#: port's hour of that many microseconds; ``date_format`` of an INT is
#: refused at resolution in both packages
PORTED_PAST_JAX = {"time-part": [(0,), (0,)]}
RESOLVE_ERROR = ("date-format",)


@pytest.mark.parametrize("case", list(REFUSED))
def test_unported_construct_raises(case):
    """Parsed constructs without a counterpart raise at ``sql()``.  A
    string cast and a float group key while NaNs are possible, which the
    JAX package keeps on the CPU, run on the host: the explain line names
    the reason and the rows equal the JAX package's (NaN equal to NaN;
    each NaN key a group of its own, -0.0 one group with 0.0, as in the
    JAX package's host aggregate).  The constructs ported since (windows,
    ROLLUP, CUBE, GROUPING SETS, UNION, INTERSECT, EXCEPT) run on the
    device and give the JAX host engine's rows (compared as a multiset:
    the texts have no ORDER BY), and so do the math and string functions
    and ``||``; ``hour`` of an INT runs where the JAX package overflows,
    and ``date_format`` of an INT is a TypeError in both packages."""
    if case in PORTED:
        sess = _refusal_session()
        got = sess.sql(REFUSED[case]).collect()
        jsess = TpuSparkSession(JaxConf({"spark.rapids.sql.enabled":
                                         False}))
        jsess.create_dataframe({"a": (JT.INT, [1, 2]),
                                "d": (JT.DOUBLE, [1.0, 2.0]),
                                "s": (JT.STRING, ["x", "y"])}
                               ).create_or_replace_temp_view("t")
        want = jsess.sql(REFUSED[case]).collect()
        if case == "math":
            # torch's CPU sqrt is not correctly rounded (1 ULP off
            # numpy's on sqrt(2)); CUDA's is: within 4 ULP here
            assert len(got) == len(want)
            for (g,), (w,) in zip(sorted(got), sorted(want)):
                assert abs(g - w) <= 4 * np.spacing(w)
        else:
            assert sorted(map(repr, got)) == sorted(map(repr, want))
        from spark_rapids_tpu_torch.session import _assert_on_gpu
        _assert_on_gpu(sess.last_physical_plan)  # no host exec but scans
        return
    if case in PORTED_PAST_JAX:
        sess = _refusal_session()
        assert sess.sql(REFUSED[case]).collect() == PORTED_PAST_JAX[case]
        return
    if case in RESOLVE_ERROR:
        jsess = TpuSparkSession(JaxConf({}))
        jsess.create_dataframe({"a": (JT.INT, [1, 2])}
                               ).create_or_replace_temp_view("t")
        for sess in (_refusal_session(), jsess):
            with pytest.raises(TypeError, match="date/timestamp"):
                sess.sql(REFUSED[case]).collect()
        return
    if case in FALLS_BACK:
        psess, jsess = _fallback_sessions(case)
        got = psess.sql(REFUSED[case]).collect()
        assert "cannot run on GPU because" in psess.last_explain
        assert FALLS_BACK[case] in psess.last_explain
        want = jsess.sql(REFUSED[case]).collect()
        assert repr(got) == repr(want)
        return
    sess = _refusal_session()
    with pytest.raises(NotImplementedError, match="not ported yet"):
        sess.sql(REFUSED[case]).collect()


def test_q10_refused_while_nans_are_possible():
    """TPC-H Q10 groups by the DOUBLE c_acctbal: with
    ``spark.rapids.sql.hasNans`` on (the default) the aggregate runs on
    the host between the device joins and the device sort, as the JAX
    package plans it.  Its rows are held to the JAX package's host engine
    (no compile here; the mixed plan against the JAX package's at the
    same settings is ``tests/test_torch_fallback.py``'s): keys, counts and
    order exact, sums within 1e-9 relative (the device joins may hand the
    host aggregate its rows in another order)."""
    from spark_rapids_tpu.benchmarks import datagen as JD
    from test_torch_tpch_sql import assert_rows_match
    sess = GpuSparkSession(RapidsConf(), device="cpu")
    PD.register_tpch(sess, sf=0.005, num_partitions=1)
    got = sess.sql(PQ.QUERIES["q10"]).collect()
    assert "!Aggregate cannot run on GPU because" in sess.last_explain
    assert "grouping by floating point" in sess.last_explain
    assert "CpuAggregate" in sess.last_physical_plan.tree_string()
    jsess = TpuSparkSession(JaxConf({"spark.rapids.sql.enabled": False}))
    JD.register_tpch(jsess, sf=0.005, num_partitions=1)
    want = jsess.sql(JQ.QUERIES["q10"]).collect()
    assert_rows_match(got, want, "q10")
    assert got

# -- each module's new expressions in one projection --------------------------


def _edge_table(rng, n=64):
    """Columns with NULLs and the edge values of Java's integer rules."""
    ints = [0, -1, 1, 7, -7, 3, -3, I32[0], I32[1], 2]
    longs = [0, -1, 1, 7, -7, I64[0], I64[1], 2 ** 40, -(2 ** 40), 3]
    dbls = [0.0, -0.0, 1.5, -1.5, 7.25, -7.25, float("nan"), float("inf"),
            float("-inf"), 2.0 ** 63, -(2.0 ** 63), 2.0 ** 63 - 1024.0,
            2.0 ** 31 - 1, 2.0 ** 31, -(2.0 ** 31) - 1, 2.0 ** 31 + 1,
            -(2.0 ** 31), 2147483647.5, 1e300, -1e300, 0.9, -0.9, 127.5,
            128.0, -129.0, 32767.9, 32768.0, 3.0]
    flts = [float("nan"), float("inf"), 2147483520.0, 2147483648.0,
            -2147483648.0, -2147483904.0, 3e9, -0.5, 1.75]

    def pick(vals, null_every):
        out = [vals[i] if i < len(vals) else vals[rng.randint(len(vals))]
               for i in range(n)]
        return [None if i % null_every == null_every - 1 else v
                for i, v in enumerate(out)]

    truth = [True, False, None]
    return {
        "a": (JT.INT, pick(ints, 9)),
        "b": (JT.INT, pick(ints[::-1], 8)),
        "x": (JT.LONG, pick(longs, 7)),
        "y": (JT.LONG, pick(longs[3:] + longs[:3], 10)),
        "d": (JT.DOUBLE, pick(dbls, 11)),
        "e": (JT.DOUBLE, pick(dbls[5:] + dbls[:5], 6)),
        "f": (JT.FLOAT, pick(flts, 12)),
        "p": (JT.BOOLEAN, [truth[i % 3] for i in range(n)]),
        "q": (JT.BOOLEAN, [truth[(i // 3) % 3] for i in range(n)]),
        "s": (JT.STRING, pick(["bb", "", "apple", "é中", "SHIP"], 13)),
        "t": (JT.STRING, pick(["apple", "bb", "MAIL", "", "x"], 5)),
        "dt": (JT.DATE, pick([0, -1, 8766, -719162, 2932896], 9)),
        "ts": (JT.TIMESTAMP, pick([0, -1, 86_400_000_000, -86_400_000_001,
                                   1_700_000_000_123_456], 7)),
    }


def _arith(M, c, lit):
    A = M.A
    return [A.Add(c("a"), c("b")), A.Subtract(c("a"), c("b")),
            A.Multiply(c("a"), c("b")), A.Add(c("x"), c("y")),
            A.Subtract(c("x"), c("y")), A.Add(c("a"), c("x")),
            A.Add(c("a"), c("d")), A.Add(lit(8766), lit(90)),
            A.Divide(c("a"), c("b")), A.Divide(c("d"), c("e")),
            A.Divide(c("x"), c("d")), A.IntegralDivide(c("a"), c("b")),
            A.IntegralDivide(c("x"), c("y")),
            A.IntegralDivide(c("x"), lit(-1)),
            A.Remainder(c("a"), c("b")), A.Remainder(c("x"), c("y")),
            A.Remainder(c("d"), c("e")), A.Remainder(c("x"), lit(-1)),
            A.Pmod(c("a"), c("b")), A.Pmod(c("x"), c("y")),
            A.Pmod(c("d"), c("e")), A.UnaryMinus(c("a")),
            A.UnaryMinus(c("x")), A.UnaryMinus(c("d")), A.Abs(c("a")),
            A.Abs(c("x")), A.Abs(c("d")), A.UnaryPositive(c("e"))]


def _preds(M, c, lit):
    P = M.P
    return [P.And(c("p"), c("q")), P.Or(c("p"), c("q")), P.Not(c("p")),
            P.EqualNullSafe(c("p"), c("q")), P.EqualNullSafe(c("a"), c("b")),
            P.EqualNullSafe(c("s"), c("t")), P.NotEquals(c("a"), c("b")),
            P.NotEquals(c("d"), c("e")), P.NotEquals(c("s"), lit("bb")),
            P.NotEquals(c("s"), c("t")),
            P.GreaterThanOrEqual(c("a"), c("b")),
            P.GreaterThanOrEqual(c("d"), c("e")),
            P.GreaterThanOrEqual(c("dt"), lit(8766)),
            P.In(c("a"), [lit(1), lit(-7), lit(None)]),
            P.In(c("x"), [lit(I64[0]), lit(3)]),
            P.In(c("s"), [lit("SHIP"), lit("MAIL"), lit("")]),
            P.In(c("s"), [lit("bb"), c("t")]),
            P.Not(P.In(c("d"), [lit(1.5), lit(float("nan"))]))]


def _nulls(M, c, lit):
    N = M.N
    return [N.IsNull(c("a")), N.IsNotNull(c("s")), N.IsNull(c("p")),
            N.IsNan(c("d")), N.IsNan(c("f")), N.IsNan(c("a")),
            N.NaNvl(c("d"), c("e")), N.NaNvl(c("f"), lit(0.5)),
            N.AtLeastNNonNulls(2, c("a"), c("d"), c("s")),
            N.AtLeastNNonNulls(1, c("e"), c("f")),
            N.Coalesce(c("a"), c("b")), N.Coalesce(c("d"), lit(0.0)),
            N.Coalesce(c("x"), c("a"), lit(5))]


def _conds(M, c, lit):
    Co, P = M.Co, M.P
    return [Co.If(c("p"), c("a"), c("b")),
            Co.If(P.GreaterThanOrEqual(c("a"), c("b")), c("d"), lit(1.5)),
            Co.If(c("q"), c("x"), c("a")),
            Co.CaseWhen([(c("p"), c("a")), (c("q"), c("b"))], lit(0)),
            Co.CaseWhen([(P.GreaterThanOrEqual(c("d"), c("e")), c("d"))]),
            Co.CaseWhen([(c("p"), lit(None)), (c("q"), c("x"))], c("y"))]


def _casts(M, c, lit):
    C, TT = M.C, M.T
    return [C.Cast(c("d"), TT.INT), C.Cast(c("d"), TT.LONG),
            C.Cast(c("d"), TT.SHORT), C.Cast(c("d"), TT.BYTE),
            C.Cast(c("f"), TT.INT), C.Cast(c("f"), TT.LONG),
            C.Cast(c("e"), TT.BOOLEAN), C.Cast(c("a"), TT.BOOLEAN),
            C.Cast(c("p"), TT.INT), C.Cast(c("p"), TT.DOUBLE),
            C.Cast(c("x"), TT.INT), C.Cast(c("x"), TT.SHORT),
            C.Cast(c("a"), TT.DOUBLE), C.Cast(c("x"), TT.FLOAT),
            C.Cast(c("d"), TT.FLOAT), C.Cast(c("f"), TT.DOUBLE),
            C.Cast(c("dt"), TT.TIMESTAMP), C.Cast(c("ts"), TT.DATE),
            C.Cast(c("ts"), TT.LONG), C.Cast(c("ts"), TT.DOUBLE),
            C.Cast(c("a"), TT.TIMESTAMP), C.Cast(c("dt"), TT.INT),
            C.Cast(c("a"), TT.DATE)]


MODULES = {"arithmetic": _arith, "predicates": _preds, "nullexprs": _nulls,
           "conditional": _conds, "cast": _casts}


@pytest.fixture(scope="module")
def edge_frames():
    return _frames(_edge_table(np.random.RandomState(11)))


@pytest.mark.parametrize("module", list(MODULES))
def test_expressions_match_jax(edge_frames, module):
    jdf, pdf = edge_frames
    build = MODULES[module]

    def exprs(M, df, Col):
        def c(name):
            return M.B.ColumnRef(name)
        out = build(M, c, M.B.Literal)
        return df.select(*[Col(M.B.Alias(e, f"e{i}"))
                           for i, e in enumerate(out)])

    jq = exprs(JAX_NS, jdf, JaxColumn)
    pq = exprs(PORT_NS, pdf, Column)
    assert [(f.name, f.dtype.name, f.nullable) for f in pq.schema] == \
        [(f.name, f.dtype.name, f.nullable) for f in jq.schema]
    assert_rows(pq.collect(), jq.collect())


# -- aggregation without keys -------------------------------------------------


def _agg_table(rng, n, nan=False):
    d = (rng.rand(n) * 1000 - 100).round(2)
    if nan:
        d[n // 2] = np.nan
    return {"i": (JT.LONG, [None if j % 6 == 2 else int(v) for j, v in
                            enumerate(rng.randint(-50, 1000, n))]),
            "d": (JT.DOUBLE, [None if j % 4 == 1 else float(v)
                              for j, v in enumerate(d)])}


def _keyless(df, F, where=None):
    if where is not None:
        df = df.filter(where(F))
    return df.agg(F.sum("i").alias("si"), F.count("i").alias("ci"),
                  F.avg("d").alias("ad"), F.min("d").alias("mind"),
                  F.max("i").alias("maxi"), F.count("*").alias("n"),
                  F.sum("d").alias("sd"))


@pytest.mark.parametrize("case", ["batches", "emptied", "nan"])
def test_keyless_aggregate_matches_jax(case):
    """One row in every case; over input a filter empties, the SQL
    defaults: sums, averages, min and max NULL, counts 0."""
    rng = np.random.RandomState(3)
    jdf, pdf = _frames(_agg_table(rng, 5000, nan=case == "nan"),
                       batch_rows=1024)
    where = (lambda F: F.col("i") > 10 ** 6) if case == "emptied" else None
    want = _keyless(jdf, JF, where).collect()
    got = _keyless(pdf, PF, where).collect()
    assert len(got) == 1
    assert_rows(got, want, same=_close)
    if case == "emptied":
        assert got == [(None, 0, None, None, None, 0, None)]


def test_keyless_aggregate_over_no_batch():
    """A scan with no batch at all: the merge still emits the row of SQL
    defaults."""
    sess = GpuSparkSession(RapidsConf(SETTINGS), device="cpu")
    schema = T.Schema([("i", T.LONG), ("d", T.DOUBLE)])
    df = DataFrame(InMemoryScan([], schema, 1), sess)
    assert _keyless(df, PF).collect() == \
        [(None, 0, None, None, None, 0, None)]
