"""PyTorch port, the window functions: ``exprs/windows.py`` and
``ops/window.py`` against the JAX package on the CPU.

The same seeded tables go through both packages' DataFrame APIs with the
same window columns: ``row_number``, ``rank``, ``dense_rank``, ``lag`` and
``lead`` (offsets, a default, a string column), and ``sum``, ``count``,
``avg``, ``min`` and ``max`` over ROWS and RANGE frames, running, bounded
and whole, with and without ORDER BY, over string and integer partition
keys and DOUBLE (NULL, NaN, -0.0 and 0.0, ties) and LONG order keys,
ascending and descending.

* The port's ``CpuWindowExec`` (``spark.rapids.sql.enabled`` off) against
  the JAX ``CpuWindowExec`` over many seeds: rows in order; keys, counts,
  ranks, offsets, min and max exact; float frame sums and averages within
  1e-9 relative, because the port's host twin takes a bounded frame's sum
  as a difference of running sums where the JAX twin sums each frame anew
  (a whole-partition sum is one ``np.sum`` in both, and exact).
* The port's ``GpuWindowExec`` on torch's CPU against the JAX
  ``TpuWindowExec`` on jax's CPU over a few seeds: rows in order, exact
  but for float sums and averages within 1e-9 relative (a frame sum is a
  difference of ``cumsum`` in both, summed in another order by XLA).
* The frame helpers and the planner: a bounded RANGE frame without one
  numeric order key falls back to the host, which raises as the JAX twin
  does; the Window nodes the DataFrame front end hoists (one per
  partition-and-order spec, by ``fingerprint()``).
"""

import math

import numpy as np
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch import functions as PF
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

DEVICE = {"spark.rapids.sql.variableFloatAgg.enabled": True,
          "spark.sql.shuffle.partitions": 1}
HOST = {"spark.rapids.sql.enabled": False, "spark.sql.shuffle.partitions": 1}
REL = 1e-9


def _pick(rng, values, n, null_frac):
    out = [values[i] for i in rng.randint(0, len(values), n)]
    return [None if rng.rand() < null_frac else v for v in out]


def _table(seed: int, n: int = 80, nan: bool = True):
    """Partition keys g (strings) and h (ints), order keys o (DOUBLE:
    NULL, NaN, -0.0, 0.0 and ties) and k (LONG, ties and NULLs), values v
    (INT), x (DOUBLE) and s (strings)."""
    rng = np.random.RandomState(seed)
    doubles = [0.0, -0.0, 1.5, -2.25, 3.0, 7.0, 0.5] + \
        ([float("nan")] if nan else [])
    return {
        "g": (JT.STRING, _pick(rng, ["a", "bb", "été", "", "z"], n, 0.1)),
        "h": (JT.INT, _pick(rng, [0, 1, 2, -3, 10], n, 0.1)),
        "o": (JT.DOUBLE, _pick(rng, doubles, n, 0.15)),
        "k": (JT.LONG, _pick(rng, list(range(-6, 7)) +
                             [2 ** 62, -(2 ** 62)], n, 0.1)),
        "v": (JT.INT, _pick(rng, list(range(-20, 40)), n, 0.15)),
        "x": (JT.DOUBLE, [None if rng.rand() < 0.15 else
                          float(np.round(rng.randn() * 100, 2))
                          for _ in range(n)]),
        "s": (JT.STRING, _pick(rng, ["p", "qq", "中文", ""], n, 0.2)),
    }


def _port_data(data):
    return {k: (T.type_from_name(t.name), v) for k, (t, v) in data.items()}


def window_columns(F, df):
    """The window columns, in either package's API."""
    W = F.Window
    by_g = W.partition_by("g").order_by("o")
    by_h = W.partition_by("h").order_by(df["k"].desc(), "v")
    whole = W.partition_by("g")
    keyless = W.order_by("k", "v")
    return [
        F.row_number().over(by_g).alias("rn"),
        F.rank().over(by_g).alias("rk"),
        F.dense_rank().over(by_g).alias("drk"),
        F.lag("v").over(by_g).alias("lag_v"),
        F.lead("x", 2).over(by_g).alias("lead_x"),
        F.lag("v", 3, 0).over(by_g).alias("lag_v_dflt"),
        F.lead("s").over(by_g).alias("lead_s"),
        F.sum("v").over(by_g).alias("run_sum_v"),
        F.avg("x").over(by_g).alias("run_avg_x"),
        F.count("x").over(by_g).alias("run_cnt_x"),
        F.min("x").over(by_g.rows_between(-2, 1)).alias("rows_min_x"),
        F.max("v").over(by_g.rows_between(-2, 1)).alias("rows_max_v"),
        F.sum("x").over(by_g.rows_between(-1, W.unboundedFollowing))
        .alias("rows_tail_x"),
        F.sum("v").over(whole).alias("all_sum_v"),
        F.avg("x").over(whole).alias("all_avg_x"),
        F.min("v").over(whole).alias("all_min_v"),
        F.max("x").over(whole).alias("all_max_x"),
        F.count("s").over(whole).alias("all_cnt_s"),
        F.rank().over(by_h).alias("rk_h"),
        F.sum("v").over(by_h.rows_between(W.unboundedPreceding, 0))
        .alias("rows_run_v"),
        F.sum("x").over(W.partition_by("h").order_by(df["k"].desc())
                        .range_between(-3, 2)).alias("range_desc_x"),
        F.count("v").over(W.partition_by("g").order_by("k")
                          .range_between(W.unboundedPreceding, 1))
        .alias("range_upto_v"),
        F.max("v").over(W.partition_by("h").order_by("o")
                        .range_between(-1, 2)).alias("range_float_v"),
        F.avg("v").over(W.partition_by("g").order_by("k")
                        .range_between(2, W.unboundedFollowing))
        .alias("range_from_v"),
        # DOUBLE partition keys: NaN, and -0.0 one partition with 0.0
        F.sum("v").over(W.partition_by("o").order_by("k")
                        .range_between(-2, 2)).alias("range_by_o"),
        F.rank().over(keyless).alias("rk_all"),
        F.sum("x").over(keyless).alias("run_all_x"),
        F.lead("h", 1).over(keyless).alias("lead_h"),
    ]


def _run(F, session, data):
    df = session.create_dataframe(data, num_partitions=2)
    df = df.select("g", "h", "o", "k", "v", "x", "s",
                   *window_columns(F, df))
    return df.columns, df.collect()


def _same(got, want) -> bool:
    if isinstance(want, float) and isinstance(got, float):
        if math.isnan(want) or math.isnan(got):
            return math.isnan(want) and math.isnan(got)
        return got == want or abs(got - want) <= REL * abs(want)
    return got == want and type(got) is type(want)


def _assert_rows(got, want, label):
    gc, gr = got
    wc, wr = want
    assert gc == wc
    assert len(gr) == len(wr), label
    for i, (g, w) in enumerate(zip(gr, wr)):
        for name, a, b in zip(gc, g, w):
            assert _same(a, b), f"{label} row {i} {name}: {a!r} vs {b!r}"


@pytest.mark.parametrize("seed", range(8))
def test_host_window_exec_matches_jax(seed):
    data = _table(seed)
    want = _run(JF, TpuSparkSession(JaxConf(HOST)), data)
    port = GpuSparkSession(RapidsConf(HOST), device="cpu")
    got = _run(PF, port, _port_data(data))
    assert "CpuWindowExec" in port.last_physical_plan.tree_string() or \
        "CpuWindow" in port.last_physical_plan.tree_string()
    _assert_rows(got, want, f"seed {seed}")


@pytest.mark.parametrize("seed", [0, 5])
def test_device_window_exec_matches_jax(seed):
    data = _table(seed, n=64)
    want = _run(JF, TpuSparkSession(JaxConf(DEVICE)), data)
    port = GpuSparkSession(RapidsConf(DEVICE), device="cpu")
    got = _run(PF, port, _port_data(data))
    plan = port.last_physical_plan.tree_string()
    assert "GpuWindow" in plan and "CpuWindow" not in plan
    _assert_rows(got, want, f"seed {seed}")


def test_window_nodes_are_hoisted_per_spec():
    """One Window node per (partition, order) spec, each distinct window
    expression (by fingerprint: frames and offsets included) one hidden
    column, arithmetic over windows projected above."""
    port = GpuSparkSession(RapidsConf(DEVICE), device="cpu")
    df = port.create_dataframe(_port_data(_table(1, n=16)))
    W = PF.Window
    spec = W.partition_by("g").order_by("o")
    out = df.select(
        "v", (PF.sum("v").over(spec) * 2).alias("twice"),
        PF.sum("v").over(spec.rows_between(-1, 0)).alias("rows"),
        PF.lag("v", 2).over(spec).alias("lag2"),
        PF.rank().over(W.order_by("k")).alias("rk"))
    node, windows = out.plan, []
    assert isinstance(node, L.Project)
    node = node.children[0]
    while isinstance(node, L.Window):
        windows.append(node)
        node = node.children[0]
    assert [len(w.window_exprs) for w in windows] == [1, 3]
    assert sorted(n for w in windows for n in w.output_names) == \
        ["__w0", "__w1", "__w2", "__w3"]
    rows = out.collect()
    assert len(rows) == 16


def test_bounded_range_needs_one_numeric_key():
    """The device refuses a bounded RANGE frame over two order keys (the
    planner puts the window on the host) and the host raises, as the JAX
    twin does."""
    data = _table(2, n=12)
    for F, session, d in (
            (JF, TpuSparkSession(JaxConf(DEVICE)), data),
            (PF, GpuSparkSession(RapidsConf(DEVICE), device="cpu"),
             _port_data(data))):
        df = session.create_dataframe(d)
        spec = F.Window.partition_by("g").order_by("k", "v") \
            .range_between(-1, 1)
        q = df.select("v", F.sum("v").over(spec).alias("w"))
        with pytest.raises(ValueError, match="exactly one"):
            q.collect()
    port = GpuSparkSession(RapidsConf(DEVICE), device="cpu")
    df = port.create_dataframe(_port_data(data))
    spec = PF.Window.partition_by("g").order_by("s").range_between(-1, 1)
    text = port.explain_plan(df.select(
        PF.sum("v").over(spec).alias("w")).plan)
    assert "!Window cannot run on GPU because bounded RANGE frame needs " \
        "a numeric order key" in text
