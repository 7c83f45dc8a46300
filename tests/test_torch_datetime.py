"""PyTorch port, the date parts and date arithmetic (``exprs/datetime.py``),
``substring`` (``exprs/strings.py:Substring``) and ``count(DISTINCT)``
(``GroupedData.agg``'s two-level rewrite) against the JAX package.

The date expressions run over edge days (before 1970, 1900-02-28 and
03-01, 2000-02-29, 2100-03-01, year 1 and 9999) as DATE and as TIMESTAMP
(a microsecond before midnight too), with NULLs; every output buffer must
equal the JAX package's, and the valid rows Python's ``datetime``.
``substring`` runs over pos in {-5, -1, 0, 1, 3} x length in {None, 0, -1,
2, 100} on empty, NULL, long and multi-byte rows, with a row past
``num_rows``: the bytes equal the JAX package's, which counts UTF-8 bytes.
``count_distinct`` runs with NULL keys and values, keyed and keyless,
beside sum, avg, min, max and count, through the DataFrame API and SQL.
"""

import datetime as dt
import math

import numpy as np
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.batch import host_to_device as jax_to_device
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.exprs import base as JB
from spark_rapids_tpu.exprs import datetime as JDT
from spark_rapids_tpu.exprs import strings as JS
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch import functions as PF
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import host_to_device
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exprs import base as PB
from spark_rapids_tpu_torch.exprs import datetime as PDT
from spark_rapids_tpu_torch.exprs import strings as PS
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread, port_host_batch,
)

EPOCH = dt.date(1970, 1, 1)
DAYS = [dt.date(1900, 2, 28), dt.date(1900, 3, 1), dt.date(2000, 2, 29),
        dt.date(2000, 3, 1), dt.date(2100, 2, 28), dt.date(2100, 3, 1),
        dt.date(1969, 12, 31), dt.date(1970, 1, 1), dt.date(1969, 1, 1),
        dt.date(1600, 2, 29), dt.date(1, 1, 1), dt.date(9999, 12, 31),
        dt.date(1992, 1, 1), dt.date(1998, 12, 31), None]
MICROS_PER_DAY = 86_400_000_000
PARTS = {"Year": lambda d: d.year, "Month": lambda d: d.month,
         "DayOfMonth": lambda d: d.day,
         "DayOfWeek": lambda d: d.isoweekday() % 7 + 1,
         "DayOfYear": lambda d: d.timetuple().tm_yday,
         "Quarter": lambda d: (d.month - 1) // 3 + 1,
         "WeekDay": lambda d: d.weekday()}
SETTINGS = {"spark.rapids.sql.variableFloatAgg.enabled": True,
            "spark.sql.shuffle.partitions": 1}


def _days(d):
    return None if d is None else (d - EPOCH).days


def _date_table():
    """DATE ``d`` and ``d2``, TIMESTAMP ``ts`` (the day's last
    microsecond: one before the next midnight) and INT ``n``."""
    days = [_days(d) for d in DAYS]
    d2 = [None if x is None else 10 - x // 3 for x in days[::-1]]
    ts = [None if x is None else (x + 1) * MICROS_PER_DAY - 1 for x in days]
    n = [None, 1, -1, 0, 365, -366, 59, 1000, -1000, 2, 3, None, 7, -7, 4]
    return {"d": (JT.DATE, days), "d2": (JT.DATE, d2),
            "ts": (JT.TIMESTAMP, ts), "n": (JT.INT, n)}


def _eval_both(data, make, capacity=None):
    """(jax DevVal, port DevVal) of the expression ``make(module, col)``
    over the same table in each package."""
    jb = JaxHostBatch.from_pydict(data)
    jdev = jax_to_device(jb, capacity=capacity)
    pdev = host_to_device(port_host_batch(jb), "cpu", capacity=capacity)
    jv = make(JDT, JS, JB.ColumnRef).tpu_eval(JB.TpuEvalCtx(jdev))
    pexpr = PB.resolve(make(PDT, PS, PB.ColumnRef), pdev.schema)
    pv = pexpr.gpu_eval(PB.GpuEvalCtx(pdev))
    return jv, pv


def _assert_bits(jv, pv):
    import jax
    for field in ("data", "validity", "offsets"):
        a, b = getattr(jv, field), getattr(pv, field)
        assert (a is None) == (b is None), field
        if a is not None:
            a, b = np.asarray(jax.device_get(a)), b.numpy()
            assert a.dtype == b.dtype, (field, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("column", ["d", "ts"])
@pytest.mark.parametrize("part", sorted(PARTS))
def test_date_part_matches_jax_and_the_calendar(part, column):
    jv, pv = _eval_both(_date_table(),
                        lambda D, S, c: getattr(D, part)(c(column)))
    _assert_bits(jv, pv)
    got = pv.data.tolist()
    for i, d in enumerate(DAYS):
        assert bool(pv.validity[i]) == (d is not None)
        if d is not None:
            assert got[i] == PARTS[part](d), (part, d, got[i])


@pytest.mark.parametrize("fn,args", [("DateAdd", ("d", "n")),
                                     ("DateSub", ("d", "n")),
                                     ("DateDiff", ("d", "d2")),
                                     ("DateDiff", ("d2", "d"))])
def test_date_arithmetic_matches_jax(fn, args):
    jv, pv = _eval_both(_date_table(), lambda D, S, c: getattr(D, fn)(
        c(args[0]), c(args[1])))
    _assert_bits(jv, pv)


STRINGS = ["", None, "hello world", "é中文\U0001f642x", "ab",
           "p" * 300, "tail row past num_rows"]


@pytest.mark.parametrize("length", [None, 0, -1, 2, 100])
@pytest.mark.parametrize("pos", [-5, -1, 0, 1, 3])
def test_substring_matches_jax(pos, length):
    jb = JaxHostBatch.from_pydict({"s": (JT.STRING, STRINGS)})
    jdev = jax_to_device(jb, capacity=8)
    pdev = host_to_device(port_host_batch(jb), "cpu", capacity=8)
    # the last row lies past num_rows: its substring is empty
    jdev = type(jdev)(jdev.schema, jdev.columns, jdev.num_rows - 1,
                      jdev.capacity)
    pdev = type(pdev)(pdev.schema, pdev.columns, pdev.num_rows - 1,
                      pdev.capacity)
    jv = JS.Substring(JB.ColumnRef("s"), pos, length).tpu_eval(
        JB.TpuEvalCtx(jdev))
    pv = PS.Substring(PB.ColumnRef("s", T.STRING), pos, length).gpu_eval(
        PB.GpuEvalCtx(pdev))
    _assert_bits(jv, pv)


# -- count(DISTINCT) ----------------------------------------------------------


def _agg_table(types):
    rng = np.random.RandomState(21)
    n = 60
    g = [None if rng.rand() < 0.1 else int(x)
         for x in rng.randint(0, 4, n)]
    v = [None if rng.rand() < 0.2 else int(x)
         for x in rng.randint(0, 7, n)]
    x = [None if rng.rand() < 0.1 else float(y)
         for y in (rng.rand(n) * 100).round(2)]
    return {"g": (types.INT, g), "v": (types.LONG, v),
            "x": (types.DOUBLE, x)}


def _aggs(F):
    return [F.count_distinct("v").alias("cd"), F.sum("x").alias("sx"),
            F.avg("x").alias("ax"), F.min("v").alias("mn"),
            F.max("v").alias("mx"), F.count("v").alias("cv")]


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert math.isclose(a, b, rel_tol=1e-9), (g, w)
            else:
                assert a == b, (g, w)


@pytest.fixture(scope="module")
def sessions():
    jsess = TpuSparkSession(JaxConf(SETTINGS))
    psess = GpuSparkSession(RapidsConf(SETTINGS), device="cpu")
    jsess.create_dataframe(_agg_table(JT), num_partitions=3) \
        .create_or_replace_temp_view("t")
    psess.create_dataframe(_agg_table(T), num_partitions=3) \
        .create_or_replace_temp_view("t")
    return jsess, psess


@pytest.mark.parametrize("keyed", [True, False], ids=["keyed", "keyless"])
def test_count_distinct_matches_jax(sessions, keyed):
    jsess, psess = sessions
    out = []
    for sess, F in ((jsess, JF), (psess, PF)):
        df = sess.table("t")
        if keyed:
            df = df.group_by("g").agg(*_aggs(F)).order_by("g")
        else:
            df = df.agg(*_aggs(F))
        out.append((df.columns, df.collect()))
    (jcols, jrows), (pcols, prows) = out
    assert pcols == jcols
    _close(prows, jrows)
    assert len(prows) == (5 if keyed else 1)  # NULL is a group key too


@pytest.mark.parametrize("text", [
    "SELECT g, count(DISTINCT v) AS c, count(*) AS n FROM t GROUP BY g "
    "ORDER BY g",
    "SELECT count(DISTINCT v) AS c, sum(x) AS s FROM t",
    "SELECT g, year(date_add(g, 400)) AS y, count(DISTINCT v) AS c FROM t "
    "GROUP BY g, year(date_add(g, 400)) ORDER BY g"],
    ids=["keyed", "keyless", "date-key"])
def test_count_distinct_sql_matches_jax(sessions, text):
    jsess, psess = sessions
    want, got = jsess.sql(text), psess.sql(text)
    assert got.columns == want.columns
    _close(got.collect(), want.collect())


@pytest.mark.parametrize("text", ["SELECT count(DISTINCT g, v) FROM t",
                                  "SELECT sum(DISTINCT v) FROM t"])
def test_other_distinct_aggregates_raise(sessions, text):
    with pytest.raises(NotImplementedError):
        sessions[1].sql(text)


def test_column_functions_match_jax():
    """``year``, ``month``, ``dayofmonth`` and ``substring`` of
    ``functions``, in a projection."""
    days = [_days(d) for d in DAYS]
    strs = ["abc", None, "x", "", "été"] * 3
    out = []
    for Sess, conf, F, types in (
            (TpuSparkSession, JaxConf(SETTINGS), JF, JT),
            (lambda c: GpuSparkSession(c, device="cpu"),
             RapidsConf(SETTINGS), PF, T)):
        df = Sess(conf).create_dataframe(
            {"d": (types.DATE, days), "s": (types.STRING, strs)})
        out.append(df.select(F.year("d"), F.month("d"), F.dayofmonth("d"),
                             F.substring("s", 2, 2)).collect())
    assert out[1] == out[0]
