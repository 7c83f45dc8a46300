"""PyTorch port, the slice's aggregates and array columns against the JAX
package on the CPU: ``first``/``last`` (with and without
``ignore_nulls``), the exact ``percentile`` rewrite, ``array`` with
``explode``/``posexplode`` (and ``explode_outer`` on the host), the
``broadcast`` hint and ``DataFrame.drop``.

Each query runs through the port's device path on CPU tensors (the device
settings: ``variableFloatAgg`` on, ``hasNans`` off) and through its host
engine, and must give the JAX host engine's rows: in order, keys, counts,
firsts and lasts exact, percentiles within 1e-9 relative (the device sums
the interpolation's two terms in another order than the host engine's
row-order ``np.sum``).  Tables come in 3 batches, one per partition, so
groups span partitions.  The host twins (``cpu_reduce_groups``,
``CpuGenerateExec``) are held to the JAX twins bit for bit, and the plans
to the JAX planner's shape (planning only).
"""

import math

import numpy as np
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.dataframe import DataFrame as JaxDataFrame
from spark_rapids_tpu.exprs import aggregates as JA
from spark_rapids_tpu.exprs.base import Literal as JaxLiteral
from spark_rapids_tpu.plan.logical import InMemoryScan as JaxScan
from spark_rapids_tpu.plan.overrides import TpuOverrides
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch import functions as PF
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.dataframe import DataFrame
from spark_rapids_tpu_torch.exprs import aggregates as PA
from spark_rapids_tpu_torch.exprs.base import ColumnRef
from spark_rapids_tpu_torch.plan.logical import InMemoryScan
from spark_rapids_tpu_torch.plan.overrides import GpuOverrides
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from torch_port_util import host_execs, plan_shape, port_host_batch

REL = 1e-9
DEVICE = {"spark.rapids.sql.variableFloatAgg.enabled": True,
          "spark.rapids.sql.hasNans": False,
          "spark.sql.shuffle.partitions": 4}
HOST = {"spark.rapids.sql.enabled": False, "spark.sql.shuffle.partitions": 4}


def _same_value(got, want) -> bool:
    if isinstance(want, float) and isinstance(got, float):
        if math.isnan(want) or math.isnan(got):
            return math.isnan(want) and math.isnan(got)
        return got == want or abs(got - want) <= REL * abs(want)
    if isinstance(want, list) and isinstance(got, list):
        return len(got) == len(want) and all(
            _same_value(g, w) for g, w in zip(got, want))
    return got == want and type(got) is type(want)


def _frames(data, parts=3):
    """{engine: DataFrame} over ``data`` cut into ``parts`` batches, one
    per partition, in both packages: the JAX host engine, the port's
    device path and the port's host engine."""
    n = len(next(iter(data.values()))[1])
    bounds = [n * i // parts for i in range(parts + 1)]
    jparts = [JaxHostBatch.from_pydict({
        k: (t, v[a:b]) for k, (t, v) in data.items()})
        for a, b in zip(bounds, bounds[1:])]
    jax = TpuSparkSession(JaxConf(dict(HOST)))
    out = {"jax": JaxDataFrame(JaxScan(jparts, jparts[0].schema, parts),
                               jax)}
    pparts = [port_host_batch(p) for p in jparts]
    for key, conf in (("device", DEVICE), ("host", HOST)):
        s = GpuSparkSession(RapidsConf(dict(conf)), device="cpu")
        out[key] = DataFrame(InMemoryScan(pparts, pparts[0].schema, parts),
                             s)
    return out


def _check(frames, query_jax, query_port, label):
    want_df = query_jax(frames["jax"], JF)
    want = want_df.collect()
    for engine in ("device", "host"):
        got_df = query_port(frames[engine], PF)
        assert got_df.columns == want_df.columns
        got = got_df.collect()
        assert len(got) == len(want), f"{label} ({engine})"
        for i, (g, w) in enumerate(zip(got, want)):
            for name, a, b in zip(got_df.columns, g, w):
                assert _same_value(a, b), \
                    f"{label} ({engine}) row {i} {name}: {a!r} vs {b!r}"
    return want


def _first_last_table(n=300, seed=3):
    rng = np.random.RandomState(seed)
    k = rng.randint(0, 12, n)
    v = rng.rand(n).round(3)
    return {"k": (JT.INT, [int(x) for x in k]),
            "v": (JT.DOUBLE, [None if i % 4 == 1 or k[i] == 11 else
                              float(x) for i, x in enumerate(v)]),
            "i": (JT.LONG, list(range(n))),
            "b": (JT.BOOLEAN, [bool(x % 3) for x in range(n)])}


@pytest.mark.parametrize("ignore", [False, True])
def test_first_last_match_jax(ignore):
    """Groups spanning three partitions, one all-NULL group (k = 11); the
    pick is the group's first (last) row in input order on both sides."""
    frames = _frames(_first_last_table())

    def q(df, F):
        return (df.group_by("k")
                .agg(F.first("v", ignore_nulls=ignore).alias("fv"),
                     F.last("v", ignore_nulls=ignore).alias("lv"),
                     F.first("i").alias("fi"), F.last("i").alias("li"),
                     F.first("b", ignore_nulls=ignore).alias("fb"),
                     F.count("v").alias("n"))
                .order_by("k"))

    rows = _check(frames, q, q, f"first/last ignore_nulls={ignore}")
    by_key = {r[0]: r for r in rows}
    assert by_key[11][1] is None and by_key[11][2] is None
    data = _first_last_table()
    ks = data["k"][1]
    assert by_key[0][3] == ks.index(0)  # input order across partitions
    assert by_key[0][4] == len(ks) - 1 - ks[::-1].index(0)


def test_first_last_keyless():
    frames = _frames(_first_last_table())
    _check(frames,
           lambda df, F: df.agg(F.first("v", True).alias("a"),
                                F.last("i").alias("b")),
           lambda df, F: df.agg(F.first("v", True).alias("a"),
                                F.last("i").alias("b")), "keyless")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cls", ["First", "Last"])
def test_first_last_host_twin_is_jax_twin(cls, seed):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(0, 6, 40)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    n = int(sizes.sum())
    values = rng.randint(-50, 50, n).astype(np.int64)
    validity = rng.rand(n) > 0.4
    for ignore in (False, True):
        got, ok = getattr(PA, cls)(
            ColumnRef("x", T.LONG), ignore).cpu_reduce_groups(
                values, validity, starts)
        jfn = getattr(JA, cls)(JaxLiteral(0, JT.LONG), ignore)
        for g, (a, c) in enumerate(zip(starts, sizes)):
            want = jfn.cpu_reduce(values[a:a + c], validity[a:a + c])
            assert (want is None) == (not ok[g])
            if want is not None:
                assert got[g] == want


def _percentile_table(seed=4, n=240):
    rng = np.random.RandomState(seed)
    k = rng.randint(0, 8, n)
    x = (rng.rand(n) * 100).round(2)
    vals = [None if kk == 6 or i % 9 == 2 else float(v)
            for i, (kk, v) in enumerate(zip(k, x))]
    keys = [int(v) for v in k] + [99]  # 99: a one-row group
    vals.append(42.5)
    return {"k": (JT.INT, keys), "x": (JT.DOUBLE, vals),
            "y": (JT.INT, [int(v) for v in rng.randint(0, 50, n + 1)])}


def test_percentile_matches_jax_and_numpy():
    """p = 0, 0.25, 0.5, 0.9 and 1 of a DOUBLE and an INT column beside
    min/avg, with an all-NULL group (k = 6) and a one-row group (k =
    99)."""
    data = _percentile_table()
    frames = _frames(data)

    def q(df, F):
        return (df.group_by("k")
                .agg(F.min("x").alias("mn"),
                     F.percentile("x", 0.0).alias("p0"),
                     F.percentile("x", 0.25).alias("p25"),
                     F.percentile("x", 0.5).alias("p50"),
                     F.percentile("x", 0.9).alias("p90"),
                     F.percentile("x", 1.0).alias("p100"),
                     F.percentile("y", 0.5).alias("y50"),
                     F.avg("x").alias("avg"))
                .order_by("k"))

    rows = _check(frames, q, q, "percentile")
    keys, xs = data["k"][1], data["x"][1]
    for r in rows:
        vals = np.array([x for k, x in zip(keys, xs)
                         if k == r[0] and x is not None])
        if not len(vals):
            assert r[2:7] == (None,) * 5
            continue
        for p, got in zip((0, 25, 50, 90, 100), r[2:7]):
            want = float(np.percentile(vals, p))
            assert abs(got - want) <= 1e-9 * max(1.0, abs(want))
    assert [r for r in rows if r[0] == 99][0][2:7] == (42.5,) * 5


def test_percentile_keyless_and_sql():
    data = _percentile_table()
    frames = _frames(data)
    _check(frames,
           lambda df, F: df.agg(F.percentile("x", 0.75).alias("p"),
                                F.count("x").alias("n")),
           lambda df, F: df.agg(F.percentile("x", 0.75).alias("p"),
                                F.count("x").alias("n")), "keyless")
    for key in ("jax", "device", "host"):
        frames[key].create_or_replace_temp_view("t")
    text = "SELECT k, percentile(x, 0.5) AS m FROM t GROUP BY k ORDER BY k"
    _check(frames, lambda df, F: df.session.sql(text),
           lambda df, F: df.session.sql(text), "sql percentile")


def _array_table(n=90, seed=6):
    rng = np.random.RandomState(seed)
    return {"id": (JT.LONG, list(range(n))),
            "s": (JT.STRING, [f"row-{i}" * (i % 4) for i in range(n)]),
            "a": (JT.INT, [int(v) for v in rng.randint(-9, 9, n)]),
            "d": (JT.DOUBLE, [float(v) for v in rng.rand(n).round(2)])}


@pytest.mark.parametrize("pos", [False, True])
def test_create_array_and_explode_match_jax(pos):
    """array() of literals and columns, exploded on the device, the
    string column kept (its bytes grow), a filter in front that leaves one
    partition empty, then an aggregate over the exploded rows."""
    frames = _frames(_array_table())

    def q(df, F):
        df = df.filter(df["id"] >= 30)  # the first partition: no rows
        # hash() is never NULL, so the array is built on the device
        df = df.with_column("arr", F.array(F.lit(7), F.hash(df["a"]),
                                           F.lit(-1)))
        df = df.explode("arr", alias="e", pos=pos)
        return df.order_by("id", *(["pos"] if pos else []), "e")

    _check(frames, q, q, "explode")

    def agg(df, F):
        df = df.with_column("m", F.array(*[F.lit(i) for i in range(12)]))
        df = df.explode("m", alias="m")
        return (df.group_by("m")
                .agg(F.count("s").alias("n"), F.max("d").alias("mx"))
                .order_by("m"))

    _check(frames, agg, agg, "explode then aggregate")


def test_array_columns_through_filter_and_collect():
    """An array column rides a device filter (its elements gathered as a
    string's bytes are) and comes back one list a row; a nullable input
    makes the array on the host."""
    frames = _frames(_array_table())

    def q(df, F):
        df = df.with_column("arr", F.array(F.hash(df["a"]),
                                           F.hash(df["id"])))
        return df.filter(df["a"] > 0).select("id", "arr")

    rows = _check(frames, q, q, "array filter")
    assert all(isinstance(r[1], list) and len(r[1]) == 2 for r in rows)
    plan = GpuOverrides(RapidsConf(dict(DEVICE))).apply(
        q(frames["device"], PF).plan)
    assert host_execs(plan) == []

    def nullable(df, F):
        df = df.with_column("n", F.when(df["a"] > 0, df["a"]).otherwise(None))
        return df.select("id", F.array(df["n"], F.lit(1)).alias("arr")) \
            .order_by("id")

    rows = _check(frames, nullable, nullable, "nullable array")
    assert any(r[1][0] is None for r in rows)


def test_explode_outer_on_the_host():
    """Empty and NULL arrays: explode drops their rows, explode_outer
    keeps each once with a NULL element (and a NULL pos)."""
    arrays = [[1, 2], [], None, [3], [4, 5, 6], None, [], [7]]
    data = {"id": (JT.INT, list(range(len(arrays)))),
            "arr": (JT.ArrayType(JT.INT), arrays)}
    jb = JaxHostBatch.from_pydict(data)
    pdata = {"id": (T.INT, list(range(len(arrays)))),
             "arr": (T.ArrayType(T.INT), arrays)}
    jax = TpuSparkSession(JaxConf(dict(HOST)))
    jdf = jax.create_dataframe(jb, num_partitions=2)
    for outer in (False, True):
        for pos in (False, True):
            want = jdf.explode("arr", pos=pos, outer=outer).collect()
            for conf in (DEVICE, HOST):
                s = GpuSparkSession(RapidsConf(dict(conf)), device="cpu")
                df = s.create_dataframe(pdata, num_partitions=2)
                out = df.explode("arr", pos=pos, outer=outer)
                assert out.collect() == want, (outer, pos, conf)
                if outer and conf is DEVICE:
                    assert "explode_outer emits NULL-element rows" in \
                        s.last_explain
    assert len(jdf.explode("arr", outer=True).collect()) == 11


def test_array_plans_match_jax():
    """The array gate: an aggregate over a frame holding an array column
    goes to the host; project, filter and explode stay on the device;
    explode_outer is a host generate."""
    data = _array_table(20)
    jax = TpuSparkSession(JaxConf(dict(DEVICE)))
    port = GpuSparkSession(RapidsConf(dict(DEVICE)), device="cpu")
    jdf = jax.create_dataframe(JaxHostBatch.from_pydict(data))
    pdf = port.create_dataframe(port_host_batch(
        JaxHostBatch.from_pydict(data)))

    def shapes(build):
        jp = TpuOverrides(JaxConf(dict(
            DEVICE, **{"spark.rapids.sql.fusion.enabled": False}))).apply(
                build(jdf, JF).plan)
        pp = GpuOverrides(RapidsConf(dict(DEVICE))).apply(
            build(pdf, PF).plan)
        assert plan_shape(pp) == plan_shape(jp)
        assert host_execs(pp) == host_execs(jp)
        return host_execs(pp)

    def with_arr(df, F):
        return df.with_column("arr", F.array(F.hash(df["a"]), F.lit(2)))

    assert shapes(lambda df, F: with_arr(df, F).explode("arr")) == []
    assert shapes(lambda df, F: with_arr(df, F).filter(df["a"] > 0)
                  .explode("arr", pos=True)) == []
    assert shapes(lambda df, F: with_arr(df, F).order_by("id")) == \
        ["CpuSortExec"]
    assert "CpuAggregateExec" in shapes(
        lambda df, F: with_arr(df, F).group_by("id").agg(
            F.count("a").alias("n")))
    assert shapes(lambda df, F: with_arr(df, F).explode(
        "arr", outer=True)) == ["CpuGenerateExec"]
    assert shapes(lambda df, F: df.with_column(
        "arr", F.array(df["a"], F.lit(2))).explode("arr")) == \
        ["CpuProjectExec"]


def test_broadcast_hint_and_drop_match_jax():
    """broadcast(df) makes its side the build side whatever its size, as
    the JAX planner does; drop is a projection."""
    rng = np.random.RandomState(9)
    n = 4000
    big = {"k": (JT.LONG, [int(v) for v in rng.randint(0, 50, n)]),
           "v": (JT.DOUBLE, [float(v) for v in rng.rand(n)]),
           "w": (JT.STRING, [f"w{i % 7}" for i in range(n)])}
    small = {"sk": (JT.LONG, list(range(0, 60, 2))),
             "name": (JT.STRING, [f"n{i}" for i in range(30)])}
    conf = dict(DEVICE, **{"spark.sql.autoBroadcastJoinThreshold": 1})
    jax = TpuSparkSession(JaxConf(dict(conf)))
    jhost = TpuSparkSession(JaxConf(dict(HOST)))
    port = GpuSparkSession(RapidsConf(dict(conf)), device="cpu")

    def joined(s, F, to_batch):
        a = s.create_dataframe(to_batch(big), num_partitions=2)
        b = s.create_dataframe(to_batch(small))
        b = F.broadcast(b)
        return a.join(b, on=a["k"] == b["sk"], how="inner").drop("w", "x")

    def q(s, F, to_batch):
        return joined(s, F, to_batch).group_by("name").agg(
            F.count("v").alias("n"), F.sum("v").alias("sv")) \
            .order_by("name")

    def jbatch(d):
        return JaxHostBatch.from_pydict(d)

    def pbatch(d):
        return port_host_batch(JaxHostBatch.from_pydict(d))

    jp = TpuOverrides(JaxConf(dict(
        conf, **{"spark.rapids.sql.fusion.enabled": False}))).apply(
            q(jax, JF, jbatch).plan)
    pdf = q(port, PF, pbatch)
    pp = GpuOverrides(RapidsConf(dict(conf))).apply(pdf.plan)
    assert plan_shape(pp) == plan_shape(jp)
    assert "BroadcastHashJoin/inner/right" in str(plan_shape(pp))
    want = q(jhost, JF, jbatch).collect()
    got = pdf.collect()
    assert pdf.columns == ["name", "n", "sv"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert all(_same_value(a, b) for a, b in zip(g, w)), (g, w)
    assert joined(port, PF, pbatch).columns == \
        joined(jhost, JF, jbatch).columns == ["k", "v", "sk", "name"]
