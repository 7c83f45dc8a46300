"""PyTorch port, the slice's ETL paths and front end against the JAX
package on the CPU: ``chip_smoke.py``'s two ETL paths at a small size
(the string functions over part through ``session.sql``; time, bitwise,
array functions and corr/covar over lineitem through the DataFrame API),
corr/covar at their edges, the new SQL names, ``functions.py``'s
signatures and the planner's placement node by node.

The port runs each path on its device path (CPU tensors, the device
settings) and on its host engine; both must give the JAX host engine's
rows (no JAX device pipeline is compiled): keys, counts and integer sums
exact, in order; float sums and corr/covar within 1e-9 relative (the
device sums in another order, the windows' means with it), NaN equal to
NaN.  Tables come in 3 batches, one a partition, so groups span
partitions and the merge concatenates partials.
"""

import inspect
import math

import numpy as np
import pytest

import chip_smoke as C

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.benchmarks import datagen as JDG
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.dataframe import DataFrame as JaxDataFrame
from spark_rapids_tpu.exprs import datetime as JD
from spark_rapids_tpu.exprs import strings as JS
from spark_rapids_tpu.plan.logical import InMemoryScan as JaxScan
from spark_rapids_tpu.plan.overrides import PlanMeta as JaxPlanMeta
from spark_rapids_tpu.plan.overrides import TpuOverrides
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch import functions as PF
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.dataframe import DataFrame
from spark_rapids_tpu_torch.exprs import datetime as PD
from spark_rapids_tpu_torch.exprs import strings as PS
from spark_rapids_tpu_torch.plan.logical import InMemoryScan
from spark_rapids_tpu_torch.plan.overrides import GpuOverrides, PlanMeta
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from torch_port_util import port_host_batch

REL = 1e-9
DEVICE = dict(C.SQL_SETTINGS)
HOST = {"spark.rapids.sql.enabled": False}
PART_SF = 2         # 4,000 part rows
LINEITEM_SF = 0.05  # 3,000 lineitem rows


def _same(got, want) -> bool:
    if isinstance(want, float) and isinstance(got, float):
        if math.isnan(want) or math.isnan(got):
            return math.isnan(want) and math.isnan(got)
        return got == want or abs(got - want) <= REL * abs(want)
    return got == want and type(got) is type(want)


def _assert_rows(got, want, label, atol=0.0):
    assert len(got) == len(want), label
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            ok = _same(a, b) or (isinstance(a, float) and
                                 isinstance(b, float) and abs(a - b) <= atol)
            assert ok, f"{label} row {i}: {g} vs {w}"


def _frames(data, parts=3):
    """{engine: DataFrame} over ``data`` in ``parts`` batches, one a
    partition: the JAX host engine, the port's device path and the port's
    host engine."""
    n = len(next(iter(data.values()))[1])
    bounds = [n * i // parts for i in range(parts + 1)]
    jparts = [JaxHostBatch.from_pydict({
        k: (t, v[a:b]) for k, (t, v) in data.items()})
        for a, b in zip(bounds, bounds[1:])]
    out = {"jax": JaxDataFrame(JaxScan(jparts, jparts[0].schema, parts),
                               TpuSparkSession(JaxConf(dict(HOST))))}
    pparts = [port_host_batch(p) for p in jparts]
    for key, conf in (("device", DEVICE), ("host", HOST)):
        out[key] = DataFrame(InMemoryScan(pparts, pparts[0].schema, parts),
                             GpuSparkSession(RapidsConf(dict(conf)),
                                             device="cpu"))
    return out


@pytest.fixture(scope="module")
def part_frames():
    return _frames(JDG.gen_part(PART_SF))


@pytest.fixture(scope="module")
def lineitem_frames():
    return _frames(JDG.gen_lineitem(LINEITEM_SF))


def _part_query(df, F, S):
    view = C.etl_part_view(df, F, S)
    view.create_or_replace_temp_view("part_etl")
    return df.session.sql(C.ETL_PART_SQL)


def test_etl_part_path_matches_jax(part_frames):
    """Path (a) through ``session.sql`` over the ``part_etl`` view: every
    string function the JAX package places on its device, on the port's
    device path; rows equal the JAX host engine's and the numpy answer's
    (chip_smoke's check)."""
    want = _part_query(part_frames["jax"], JF, JS).collect()
    assert len(want) > 10
    for engine in ("device", "host"):
        q = _part_query(part_frames[engine], PF, PS)
        assert q.columns == C.ETL_PART_NAMES
        _assert_rows(q.collect(), want, f"ETL part ({engine})")
    C.check_sql_rows(want, C.etl_part_reference(JDG.gen_part(PART_SF)),
                     "numpy answer")


def test_etl_lineitem_path_matches_jax(lineitem_frames):
    """Path (b) through the DataFrame API: a TIMESTAMP made on the device,
    a string group key from ``from_unixtime(unix_timestamp(last_day))``,
    the time parts, ``date_format`` of ``TimeAdd``, the shifts and
    bitwise operators, the array functions and corr/covar."""
    want = C.etl_lineitem_query(lineitem_frames["jax"], JF, JD).collect()
    assert len(want) > 100
    for engine in ("device", "host"):
        q = C.etl_lineitem_query(lineitem_frames[engine], PF, PD)
        assert q.columns == C.ETL_LINEITEM_NAMES
        _assert_rows(q.collect(), want, f"ETL lineitem ({engine})")
    C.check_sql_rows(want, C.etl_lineitem_reference(
        JDG.gen_lineitem(LINEITEM_SF)), "numpy answer")


def _placement(meta, on_device, depth=0):
    out = [(depth, meta.node.name, on_device(meta))]
    for c in meta.children:
        out.extend(_placement(c, on_device, depth + 1))
    return out


@pytest.mark.parametrize("path", ["part", "lineitem"])
def test_etl_placement_matches_jax(part_frames, lineitem_frames, path):
    """The planner places every node of both paths where the JAX package's
    ``TpuOverrides`` does, at the device settings: all on the device but
    the scans."""
    if path == "part":
        jplan = _part_query(part_frames["jax"], JF, JS).plan
        pplan = _part_query(part_frames["device"], PF, PS).plan
    else:
        jplan = C.etl_lineitem_query(lineitem_frames["jax"], JF, JD).plan
        pplan = C.etl_lineitem_query(lineitem_frames["device"], PF, PD).plan
    jconf, pconf = JaxConf(dict(DEVICE)), RapidsConf(dict(DEVICE))
    jmeta, pmeta = JaxPlanMeta(jplan, jconf), PlanMeta(pplan, pconf)
    TpuOverrides(jconf).tag(jmeta)
    GpuOverrides(pconf).tag(pmeta)
    want = _placement(jmeta, lambda m: m.can_run_on_tpu)
    got = _placement(pmeta, lambda m: m.can_run_on_gpu)
    assert got == want
    assert all(on for _, name, on in got if name != "InMemoryScan")


def _stats_table(T=JT):
    """Groups: general (x near 1e9), a constant y (corr NaN), one row
    (covar_samp NaN), all-NULL pairs (NULL), and pairs NULL on one side
    only."""
    rng = np.random.RandomState(5)
    k, x, y = [], [], []
    for i in range(90):
        k.append(i % 3)
        x.append(float(rng.randn() * 1e6 + 1e9))
        y.append(float(rng.randn()) if i % 7 else None)
    k += [3, 3, 3, 4, 5, 5]
    x += [1.0, 2.0, 3.0, 7.0, None, 2.0]
    y += [4.0, 4.0, 4.0, 1.0, 1.0, None]
    ints = [int(v) for v in rng.randint(-100, 100, len(k))]
    return {"k": (T.INT, k), "x": (T.DOUBLE, x), "y": (T.DOUBLE, y),
            "i": (T.INT, ints)}


def _sum_scale(data, pairs):
    """The largest |term| the rewrite's SUMs see: centered products of
    each (x, y) pair over the rows where both are non-NULL."""
    k = np.asarray(data["k"][1])
    top = 0.0
    for xn, yn in pairs:
        x, y = (np.array([np.nan if v is None else v for v in data[n][1]],
                         dtype=np.float64) for n in (xn, yn))
        ok = ~np.isnan(x) & ~np.isnan(y)
        for g in np.unique(k[ok]):
            m = ok & (k == g)
            dx, dy = x[m] - x[m].mean(), y[m] - y[m].mean()
            top = max(top, np.abs(dx * dy).max(), (dx * dx).max(),
                      (dy * dy).max())
    return top


@pytest.mark.parametrize("keyed", [True, False], ids=["keyed", "keyless"])
def test_corr_covar_match_jax(keyed):
    """corr, covar_pop and covar_samp through the rewrite, keyed and
    keyless, beside a plain aggregate, over large-mean x (1e9: the
    centered form keeps its digits); a constant group gives NaN for corr,
    one row NaN for covar_samp, no complete pair NULL.  The device's
    float SUM (the slot path's fixed-point limbs, scaled to each chunk's
    largest |term|, ``kernels/hashagg.py``, as in the JAX package's) is
    exact to 2^-53 of that scale a row, so a small group's sum beside
    large terms is held within ``2^-46 * scale`` absolute besides 1e-9
    relative."""
    data = _stats_table()
    frames = _frames(data)
    atol = 2.0 ** -46 * _sum_scale(data, [("x", "y"), ("i", "x")])

    def q(df, F):
        aggs = (F.corr("x", "y").alias("c"),
                F.covar_pop("x", "y").alias("cp"),
                F.covar_samp(df["i"], df["x"]).alias("cs"),
                F.sum("i").alias("s"))
        if keyed:
            return df.group_by("k").agg(*aggs).order_by("k")
        return df.agg(*aggs)

    want = q(frames["jax"], JF).collect()
    _assert_rows(q(frames["host"], PF).collect(), want, "corr/covar (host)")
    _assert_rows(q(frames["device"], PF).collect(), want,
                 "corr/covar (device)", atol)
    if keyed:
        by_key = {r[0]: r for r in want}
        assert math.isnan(by_key[3][1]) and by_key[3][2] == 0.0
        assert math.isnan(by_key[4][1]) and math.isnan(by_key[4][3])
        assert by_key[5][1] is None and by_key[5][2] is None


SQL_TEXT = """
SELECT n AS nn, upper(s) AS a, ucase(s) AS b, lower(s) AS c, lcase(s) AS d,
       initcap(s) AS e, length(s) AS f, char_length(s) AS g,
       trim(s) AS h, ltrim(s) AS i2, rtrim(s) AS j, hex(n) AS k,
       substring_index(s, ' ', -1) AS l, concat(s, '|', s) AS m,
       s || '!' AS m2, concat_ws('-', s, s) AS n2,
       replace(s, 'a', 'AA') AS o, regexp_replace(s, '[a-c]', '') AS p,
       split_part(s, ' ', 2) AS q, lpad(s, 6, '*') AS r, rpad(s, 3) AS s2,
       hour(ts) AS t, minute(ts) AS u, second(ts) AS v, weekday(dt) AS w,
       unix_timestamp(dt) AS x, to_unix_timestamp(ts) AS y,
       from_unixtime(n) AS z, date_format(dt, 'yyyy-MM-dd') AS z1,
       shiftleft(n, 3) AS z2, shiftright(n, 1) AS z3,
       shiftrightunsigned(n, 1) AS z4,
       element_at(array(n, n * 2), 2) AS z5, size(array(n, 1)) AS z6,
       array_min(array(n, 5)) AS z7, array_max(array(n, 5)) AS z8,
       element_at(sort_array(array(n, 5, 0), false), 1) AS z9,
       array_contains(array(n, 5), 5) AS z10,
       array_position(array(n, 5), 5) AS z11
FROM t ORDER BY nn
"""


def _sql_table(sess, T):
    return sess.create_dataframe({
        "s": (T.STRING, ["  abc def ", "", None, "bb a", "x y z", "ac"]),
        "n": (T.INT, [5, -3, 0, 1000, None, 77]),
        "ts": (T.TIMESTAMP, [0, -1, 86_399_999_999, None, 1_700_000_000_123,
                             5 * 3_600_000_000]),
        "dt": (T.DATE, [0, -1, 11016, 19000, None, -700])})


@pytest.mark.parametrize("settings", [DEVICE, HOST], ids=["device", "host"])
def test_sql_names_match_jax(settings):
    """Every SQL name of the slice parses in both packages and gives the
    JAX host engine's rows (``||`` as concat)."""
    from spark_rapids_tpu_torch import types as T
    jsess = TpuSparkSession(JaxConf(dict(HOST)))
    _sql_table(jsess, JT).create_or_replace_temp_view("t")
    psess = GpuSparkSession(RapidsConf(dict(settings)), device="cpu")
    _sql_table(psess, T).create_or_replace_temp_view("t")
    want = jsess.sql(SQL_TEXT).collect()
    got = psess.sql(SQL_TEXT)
    _assert_rows(got.collect(), want, "SQL names")


def test_split_and_corr_through_sql_match_jax():
    """corr/covar through SQL (the host engines), and split: on the host
    at the device settings (array<string>)."""
    text = ("SELECT k, corr(x, y) AS c, covar_pop(x, y) AS cp, "
            "covar_samp(x, y) AS cs FROM t GROUP BY k ORDER BY k")
    from spark_rapids_tpu_torch import types as T
    jsess = TpuSparkSession(JaxConf(dict(HOST)))
    jsess.create_dataframe(_stats_table()).create_or_replace_temp_view("t")
    psess = GpuSparkSession(RapidsConf(dict(HOST)), device="cpu")
    psess.create_dataframe(_stats_table(T)).create_or_replace_temp_view("t")
    _assert_rows(psess.sql(text).collect(), jsess.sql(text).collect(),
                 "corr through SQL")
    split = "SELECT split(s, ' ') AS a FROM t"
    psess = GpuSparkSession(RapidsConf(dict(DEVICE)), device="cpu")
    jsess.create_dataframe({"s": (JT.STRING, ["a b", None, "", "c"])}
                           ).create_or_replace_temp_view("t")
    psess.create_dataframe({"s": (T.STRING, ["a b", None, "", "c"])}
                           ).create_or_replace_temp_view("t")
    assert psess.sql(split).collect() == jsess.sql(split).collect()
    assert "StringSplit has no GPU implementation" in psess.last_explain


#: the JAX package's functions not ported yet (the Python UDFs)
DEFERRED = {"udf", "pandas_udf"}


def test_functions_have_the_jax_signatures():
    """Every public function of the JAX package's ``functions.py`` but
    the deferred ones exists in the port with the same parameters and
    defaults; ``Column`` has the bitwise methods and ``getItem``."""
    def public(mod):
        return {n: f for n, f in vars(mod).items()
                if inspect.isfunction(f) and not n.startswith("_")
                and f.__module__ == mod.__name__}
    jax_fns, port_fns = public(JF), public(PF)
    assert set(jax_fns) - set(port_fns) == DEFERRED
    for name, fn in jax_fns.items():
        if name in DEFERRED:
            continue
        jp = [(p.name, p.default) for p in
              inspect.signature(fn).parameters.values()]
        pp = [(p.name, p.default) for p in
              inspect.signature(port_fns[name]).parameters.values()]
        assert pp == jp, name
    for attr in ("bitwiseAND", "bitwiseOR", "bitwiseXOR", "getItem",
                 "substr"):
        assert hasattr(PF.col("a"), attr)
    assert PF.bitwiseNOT is PF.bitwise_not


def test_column_ordinal_matches_get_item():
    from spark_rapids_tpu_torch import types as T
    sess = GpuSparkSession(RapidsConf(dict(DEVICE)), device="cpu")
    df = sess.create_dataframe({"a": (T.INT, [1, 2, 3])})
    arr = PF.array(PF.coalesce(df["a"], PF.lit(0)), PF.lit(9))
    rows = df.select(arr[1].alias("x"), arr.getItem(0).alias("y"),
                     PF.get_item(arr, 5).alias("z")).collect()
    assert rows == [(9, 1, None), (9, 2, None), (9, 3, None)]
    with pytest.raises(TypeError):
        arr["a"]
