"""PyTorch port, grouping sets, set operations and the central moments,
against the JAX package on the CPU.

* ``rollup``, ``cube``, ``grouping_sets`` and ``grouping_id``: the port's
  host engine against the JAX host engine, rows exact and in order; the
  port's device path against the JAX host engine under an ORDER BY, keys,
  counts, min and max exact, sums and averages within 1e-9 relative (the
  device sums in another order than the host's row-order ``np.sum``).
* ``GpuExpandExec`` and ``CpuExpandExec`` against ``TpuExpandExec`` and
  ``CpuExpandExec`` over an Expand node built directly (masked NULL keys
  of every type, a string key, a computed key), rows exact and in order.
* ``intersect``, ``subtract`` and SQL ``UNION``, ``UNION ALL``,
  ``INTERSECT``, ``EXCEPT`` (INTERSECT binding tighter), over columns with
  NULL, NaN and -0.0: host engine against host engine exactly, device
  path against the JAX device path; ``INTERSECT ALL``, ``EXCEPT ALL`` and
  ``UNION ALL DISTINCT`` raise as in the JAX package.
* ``stddev``, ``stddev_pop``, ``variance`` and ``var_pop``: the port's
  ``cpu_reduce_groups`` against the JAX ``cpu_reduce`` a group, bit for
  bit, on one-row, all-NULL, large-mean, NaN and infinite groups; the
  slot path and the sort path (and keyless) against the JAX host engine
  within 1e-9 relative (a two-pass update and Chan's merge on the device,
  ``np.var`` on the host).
"""

import math

import numpy as np
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.exprs import aggregates as JAg
from spark_rapids_tpu.exprs.base import ColumnRef as JColumnRef
from spark_rapids_tpu.exprs.base import Literal as JLiteral
from spark_rapids_tpu.exprs.arithmetic import Add as JAdd
from spark_rapids_tpu.dataframe import DataFrame as JDataFrame
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch import functions as PF
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.dataframe import DataFrame as PDataFrame
from spark_rapids_tpu_torch.exprs import aggregates as PAg
from spark_rapids_tpu_torch.exprs.arithmetic import Add as PAdd
from spark_rapids_tpu_torch.exprs.base import ColumnRef as PColumnRef
from spark_rapids_tpu_torch.exprs.base import Literal as PLiteral
from spark_rapids_tpu_torch.ops import gpu_exec as X
from spark_rapids_tpu_torch.plan import logical as PL
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

DEVICE = {"spark.rapids.sql.variableFloatAgg.enabled": True,
          "spark.sql.shuffle.partitions": 1,
          "spark.rapids.sql.hasNans": False}
HOST = {"spark.rapids.sql.enabled": False, "spark.sql.shuffle.partitions": 1}
REL = 1e-9
MOMENTS = ("stddev", "stddev_pop", "variance", "var_pop")


def _pick(rng, values, n, null_frac):
    out = [values[i] for i in rng.randint(0, len(values), n)]
    return [None if rng.rand() < null_frac else v for v in out]


def _table(seed: int, n: int = 60):
    rng = np.random.RandomState(seed)
    return {
        "g": (JT.STRING, _pick(rng, ["a", "bb", "été", ""], n, 0.1)),
        "h": (JT.INT, _pick(rng, [0, 1, 2, -3], n, 0.1)),
        "d": (JT.DATE, _pick(rng, [0, 10471, -365], n, 0.1)),
        "v": (JT.INT, _pick(rng, list(range(-20, 40)), n, 0.1)),
        "x": (JT.DOUBLE, [None if rng.rand() < 0.1 else
                          float(np.round(rng.randn() * 100, 2))
                          for _ in range(n)]),
    }


def _port_data(data):
    return {k: (T.type_from_name(t.name), v) for k, (t, v) in data.items()}


def _jax(confs):
    return TpuSparkSession(JaxConf(confs))


def _port(confs):
    return GpuSparkSession(RapidsConf(confs), device="cpu")


def _same(got, want) -> bool:
    if isinstance(want, float) and isinstance(got, float):
        if math.isnan(want) or math.isnan(got):
            return math.isnan(want) and math.isnan(got)
        return got == want or abs(got - want) <= REL * abs(want)
    return got == want and type(got) is type(want)


def _assert_rows(got, want, label, exact=False):
    assert len(got) == len(want), f"{label}: {len(got)} vs {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            ok = (a == b and type(a) is type(b)) or (
                isinstance(a, float) and isinstance(b, float) and
                math.isnan(a) and math.isnan(b)) if exact else _same(a, b)
            assert ok, f"{label} row {i}: {g} vs {w}"


def _grouping_query(F, df, kind):
    gd = {"rollup": lambda: df.rollup("g", "h"),
          "cube": lambda: df.cube("g", "h", "d"),
          "sets": lambda: df.grouping_sets(
              ["g", "h", "d"], [(0, 1), (2,), (), (0, 1)])}[kind]()
    return gd.agg(F.sum("v").alias("sv"), F.count("x").alias("cx"),
                  F.avg("x").alias("ax"), F.min("v").alias("mn"),
                  F.max("x").alias("mx"),
                  F.grouping_id().alias("gid"))


@pytest.mark.parametrize("kind", ["rollup", "cube", "sets"])
def test_grouping_sets_match_jax(kind):
    data = _table(4)
    want = _grouping_query(JF, _jax(HOST).create_dataframe(data), kind)
    want_rows = want.collect()
    host = _grouping_query(PF, _port(HOST).create_dataframe(
        _port_data(data)), kind)
    assert host.columns == want.columns
    _assert_rows(host.collect(), want_rows, f"{kind} host", exact=True)
    order = ["g", "h", "gid"] + (["d"] if kind != "rollup" else [])
    want_sorted = want.order_by(*order).collect()
    dev_session = _port(DEVICE)
    dev = _grouping_query(PF, dev_session.create_dataframe(
        _port_data(data), num_partitions=2), kind).order_by(*order)
    rows = dev.collect()
    plan = dev_session.last_physical_plan.tree_string()
    assert "GpuExpand" in plan and "Cpu" not in plan.replace(
        "CpuInMemoryScanExec", "")
    _assert_rows(rows, want_sorted, f"{kind} device")


def test_rollup_sql_and_repeated_sets_match_jax():
    """GROUP BY ROLLUP, CUBE and GROUPING SETS (with the bare-expression
    shorthand and a repeated set) through both parsers."""
    data = _table(6)
    texts = [
        "SELECT g, h, sum(v) AS s, grouping_id() AS gid FROM t "
        "GROUP BY ROLLUP(g, h)",
        "SELECT g, d, count(*) AS c FROM t GROUP BY CUBE(g, d)",
        "SELECT g, h, max(x) AS m FROM t "
        "GROUP BY GROUPING SETS ((g, h), g, (), (g, h))",
        "SELECT h + 1 AS h1, sum(x) AS s FROM t GROUP BY ROLLUP(h + 1)",
    ]
    jax, port = _jax(HOST), _port(HOST)
    jax.register_view("t", jax.create_dataframe(data))
    port.create_dataframe(_port_data(data)).create_or_replace_temp_view("t")
    for text in texts:
        want, got = jax.sql(text), port.sql(text)
        assert got.columns == want.columns
        _assert_rows(got.collect(), want.collect(), text, exact=True)


def _expand_plan(mods, data, session):
    """An Expand of three projections over the table: every column passed
    on, the keys g, h, d and v + 1 masked to NULL by set, a set index."""
    types, colref, lit, add, logical, dataframe = mods
    df = session.create_dataframe(data, num_partitions=2)
    fields = df.schema.fields
    keys = [colref("g", types.STRING, True), colref("h", types.INT, True),
            colref("d", types.DATE, True),
            add(colref("v", types.INT, True), lit(1))]
    projections = []
    for si, keep in enumerate([(0, 1, 2, 3), (1, 3), ()]):
        proj = [colref(f.name, f.dtype, f.nullable) for f in fields]
        proj += [k if i in keep else lit(None, k.dtype)
                 for i, k in enumerate(keys)]
        proj.append(lit(si, types.INT))
        projections.append(proj)
    names = [f.name for f in fields] + ["kg", "kh", "kd", "kv", "set"]
    return dataframe(logical.Expand(projections, names, df.plan), session)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_expand_exec_matches_jax(engine):
    data = _table(8, n=40)
    confs = HOST if engine == "host" else DEVICE
    jmods = (JT, JColumnRef, JLiteral, JAdd, JL, JDataFrame)
    pmods = (T, PColumnRef, PLiteral, PAdd, PL, PDataFrame)
    want = _expand_plan(jmods, data, _jax(confs))
    session = _port(confs)
    got = _expand_plan(pmods, _port_data(data), session)
    assert got.columns == want.columns
    rows = got.collect()
    plan = session.last_physical_plan.tree_string()
    assert ("GpuExpand" if engine == "device" else "CpuExpand") in plan
    _assert_rows(rows, want.collect(), f"expand {engine}", exact=True)


def _set_tables(seed: int):
    rng = np.random.RandomState(seed)
    doubles = [0.0, -0.0, 1.5, float("nan"), -2.0]

    def side(n):
        return {"a": (JT.INT, _pick(rng, [1, 2, 3], n, 0.2)),
                "b": (JT.DOUBLE, _pick(rng, doubles, n, 0.2)),
                "c": (JT.STRING, _pick(rng, ["x", "yy", ""], n, 0.2))}
    return side(30), side(25), side(20)


SET_TEXTS = [
    "SELECT a, b, c FROM l UNION SELECT a, b, c FROM r",
    "SELECT a, b, c FROM l UNION ALL SELECT a, b, c FROM r",
    "SELECT a, b, c FROM l INTERSECT SELECT a, b, c FROM r",
    "SELECT a, b, c FROM l EXCEPT SELECT a, b, c FROM r",
    "SELECT a, c FROM l UNION ALL SELECT a, c FROM r "
    "INTERSECT SELECT a, c FROM m",
    "SELECT a FROM l EXCEPT DISTINCT SELECT a FROM m UNION SELECT a FROM r",
]


def _views(session, tables, port: bool):
    for name, data in zip(("l", "r", "m"), tables):
        df = session.create_dataframe(_port_data(data) if port else data,
                                      num_partitions=2)
        df.create_or_replace_temp_view(name) if port else \
            session.register_view(name, df)


@pytest.mark.parametrize("text", SET_TEXTS)
def test_sql_set_operations_match_jax_host(text):
    tables = _set_tables(2)
    jax, port = _jax(HOST), _port(HOST)
    _views(jax, tables, False)
    _views(port, tables, True)
    want, got = jax.sql(text), port.sql(text)
    assert got.columns == want.columns
    _assert_rows(got.collect(), want.collect(), text, exact=True)


def test_dataframe_set_operations_on_the_device_match_jax():
    """intersect, and subtract under a distinct union, on both device
    paths (NaN keys group together there, under hasNans off)."""
    tables = _set_tables(3)
    jax, port = _jax(DEVICE), _port(DEVICE)
    _views(jax, tables, False)
    _views(port, tables, True)
    for build in (lambda s: s.table("l").intersect(s.table("r")),
                  lambda s: s.table("l").union(s.table("m")).distinct()
                  .subtract(s.table("r"))):
        want = build(jax).order_by("a", "b", "c")
        got = build(port).order_by("a", "b", "c")
        rows = got.collect()
        assert "GpuHashAggregate" in port.last_physical_plan.tree_string()
        _assert_rows(rows, want.collect(), "device set operation",
                     exact=True)


@pytest.mark.parametrize("text,message", [
    ("SELECT a FROM l INTERSECT ALL SELECT a FROM r", "INTERSECT ALL"),
    ("SELECT a FROM l EXCEPT ALL SELECT a FROM r", "EXCEPT ALL"),
    ("SELECT a FROM l UNION ALL DISTINCT SELECT a FROM r", "contradictory"),
])
def test_set_operation_errors_match_jax(text, message):
    tables = _set_tables(1)
    jax, port = _jax(HOST), _port(HOST)
    _views(jax, tables, False)
    _views(port, tables, True)
    errors = []
    for session in (jax, port):
        with pytest.raises((NotImplementedError, SyntaxError),
                           match=message) as info:
            session.sql(text)
        errors.append(type(info.value))
    assert errors[0] is errors[1]


def _moment_groups():
    """(values, validity, starts): one-row, all-NULL, large-mean, NaN,
    infinite and ordinary groups back to back."""
    rng = np.random.RandomState(11)
    groups = [
        [3.5], [None, None], [1e9 + v for v in rng.randn(40)],
        [1.0, float("nan"), 2.0], [float("inf"), 1.0],
        list(np.round(rng.randn(300) * 50, 2)), [2.0, None, 2.0],
        [None], [-0.0, 0.0], list(rng.randn(9) * 1e-3 + 7e12),
    ]
    values, validity, starts = [], [], []
    for g in groups:
        starts.append(len(values))
        values += [0.0 if v is None else float(v) for v in g]
        validity += [v is not None for v in g]
    return (np.array(values), np.array(validity, dtype=bool),
            np.array(starts, dtype=np.int64))


@pytest.mark.parametrize("name", ["StddevSamp", "StddevPop", "VarianceSamp",
                                  "VariancePop"])
def test_moment_cpu_reduce_groups_match_jax(name):
    values, validity, starts = _moment_groups()
    jfn = getattr(JAg, name)(JColumnRef("x", JT.DOUBLE))
    pfn = getattr(PAg, name)(PColumnRef("x", T.DOUBLE))
    got, ok = pfn.cpu_reduce_groups(values, validity, starts)
    bounds = list(starts) + [len(values)]
    for g in range(len(starts)):
        a, b = bounds[g], bounds[g + 1]
        want = jfn.cpu_reduce(values[a:b], validity[a:b])
        assert bool(ok[g]) == (want is not None), g
        if want is not None:
            assert np.float64(got[g]).tobytes() == \
                np.float64(want).tobytes(), (g, got[g], want)


def _moment_data(n=240):
    rng = np.random.RandomState(5)
    keys = rng.randint(0, 6, n)
    big = rng.rand(n) < 0.3
    x = np.where(big, 1e9 + rng.randn(n), np.round(rng.randn(n) * 20, 2))
    vals = [None if (k == 5 or rng.rand() < 0.1) else float(v)
            for k, v in zip(keys, x)]
    # group 4 has one valid row, group 5 none
    vals = [v if k != 4 else None for k, v in zip(keys, vals)]
    first4 = int(np.flatnonzero(keys == 4)[0])
    vals[first4] = 2.5
    return {"k": (JT.INT, [int(k) for k in keys]),
            "s": (JT.STRING, [f"key{k}" for k in keys]),
            "x": (JT.DOUBLE, vals),
            "i": (JT.LONG, [int(k) * 1000 + j for j, k in enumerate(keys)])}


@pytest.mark.parametrize("path", ["slot", "sort", "string-key", "keyless"])
def test_moments_on_both_device_paths_match_jax(path, monkeypatch):
    data = _moment_data()
    calls = {"slot": 0, "sort": 0}
    real_hash, real_sort = X.hash_group_aggregate, X.groupby_aggregate

    def spy_hash(*a, **k):
        calls["slot"] += 1
        return real_hash(*a, **k)

    def spy_sort(*a, **k):
        calls["sort"] += 1
        return real_sort(*a, **k)

    monkeypatch.setattr(X, "hash_group_aggregate", spy_hash)
    monkeypatch.setattr(X, "groupby_aggregate", spy_sort)
    confs = dict(DEVICE)
    if path == "sort":
        confs["spark.rapids.sql.agg.mxuHash.enabled"] = False
    keys = {"slot": ["k"], "sort": ["k"], "string-key": ["s"],
            "keyless": []}[path]

    def query(F, session, d):
        df = session.create_dataframe(d, num_partitions=2)
        aggs = [getattr(F, m)(c).alias(f"{m}_{c}") for m in MOMENTS
                for c in ("x", "i")]
        out = df.group_by(*keys).agg(*aggs) if keys else df.agg(*aggs)
        return out.order_by(*keys) if keys else out

    want = query(JF, _jax(HOST), data).collect()
    got = query(PF, _port(confs), _port_data(data)).collect()
    _assert_rows(got, want, f"moments {path}")
    if path == "slot":
        assert calls["slot"] >= 1
    elif path != "keyless":
        assert calls["slot"] == 0 and calls["sort"] >= 2
