"""PyTorch port, the adaptive layer on one device (``plan/adaptive.py`` and
its consumers in ``ops/gpu_exec.py``), against the JAX package on the CPU
(mirrors ``tests/test_aqe.py`` and ``tests/test_adaptive.py``).

* ``plan_groups``, ``skew_flags`` and ``group_by_target`` give the JAX
  functions' groups, flags and metrics over a grid of sizes (all empty,
  median 0 with one hot partition, a hot one among equals, uniform,
  random; bytes and rows; with skew detection off);
* with the split on, coalescing on and off give the same rows, the JAX
  host engine's;
* a one-hot-key skewed join (inner, left and right, the hot side
  streamed) gives the JAX host engine's rows with ``skewSplitChunks`` > 1;
  a full join is never chunked;
* the shuffled-to-broadcast switch gives the static broadcast plan's
  rows, with ``replannedBroadcast`` 1 and the probe side's split elided.

Rows are compared as sorted lists (a join's output order is not part of
its contract), values exact.
"""

import numpy as np
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.plan import adaptive as JA
from spark_rapids_tpu.plan.physical import ExecContext as JExecContext
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.plan import adaptive as A
from spark_rapids_tpu_torch.plan.physical import ExecContext
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

SPLIT = {"spark.rapids.sql.tpu.exchange.collapseLocal": False,
         "spark.sql.shuffle.partitions": 8}
ADAPTIVE_OFF = {"spark.rapids.sql.tpu.adaptive.enabled": False}


def _grid():
    rng = np.random.RandomState(3)
    return {
        "empty": [0] * 8,
        "median-0-one-hot": [0, 0, 0, 5000, 0, 0, 0, 0],
        "hot-among-equals": [100, 100, 100, 100, 9000, 100, 100, 100],
        "uniform": [400] * 8,
        "random": [int(x) for x in rng.randint(0, 3000, 16)],
        "one": [700],
        "none": [],
    }


CONFS = {
    "default": {},
    "small-target": {"spark.rapids.sql.tpu.adaptive.coalesce.targetBytes":
                     1000,
                     "spark.rapids.sql.adaptive.targetPartitionRows": 1000},
    "low-floor": {"spark.rapids.sql.tpu.adaptive.skew.thresholdBytes": 50,
                  "spark.rapids.sql.tpu.adaptive.coalesce.targetBytes":
                  300,
                  "spark.rapids.sql.adaptive.targetPartitionRows": 300,
                  "spark.rapids.sql.adaptive.skewJoin."
                  "skewedPartitionFactor": 2.0},
}


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("sizes", list(_grid()))
def test_plan_groups_match_jax(sizes, conf):
    sz = _grid()[sizes]
    items = list(range(len(sz)))
    for unit in ("bytes", "rows"):
        for detect in (True, False):
            jctx = JExecContext(JaxConf(dict(CONFS[conf])), device=None)
            pctx = ExecContext(RapidsConf(dict(CONFS[conf])), None)
            want = JA.plan_groups(jctx, "op", items, sz, unit,
                                  detect_skew=detect)
            got = A.plan_groups(pctx, "op", items, sz, unit,
                                detect_skew=detect)
            assert got == want
            jm = {n: m.value for n, m in jctx.metrics.get("op", {}).items()}
            assert pctx.op_metric_values().get("op", {}) == jm
            assert A.skew_flags(pctx, sz, unit) == \
                JA.skew_flags(jctx, sz, unit)
            target = A.target_for(pctx, unit)
            assert target == JA.target_for(jctx, unit)
            assert A.group_by_target(items, sz, target) == \
                JA.group_by_target(items, sz, target)


def test_broadcast_sides_and_confs_match_jax():
    for how in ("inner", "left", "right", "full", "left_semi",
                "left_anti", "cross"):
        assert A.broadcast_build_sides(how) == JA.broadcast_build_sides(how)
    for settings in ({}, ADAPTIVE_OFF,
                     {"spark.rapids.sql.adaptive.coalescePartitions."
                      "enabled": False},
                     {"spark.rapids.sql.adaptive.replanJoins.enabled":
                      False},
                     {"spark.sql.autoBroadcastJoinThreshold": -1}):
        jctx = JExecContext(JaxConf(dict(settings)), device=None)
        pctx = ExecContext(RapidsConf(dict(settings)), None)
        for fn in ("enabled", "coalesce_enabled", "replan_joins_enabled",
                   "broadcast_threshold", "target_bytes", "target_rows"):
            assert getattr(A, fn)(pctx) == getattr(JA, fn)(jctx), fn


# -- queries ------------------------------------------------------------------

MIXED = {
    "k": ("INT", [i % 7 for i in range(180)]),
    "v": ("LONG", list(range(180))),
    "s": ("STRING", [f"name{i % 13}" + "pad" * (i % 3)
                     for i in range(180)]),
}
DIM = {"k": ("INT", [0, 1, 2, 3, 4, 5, 6]),
       "w": ("LONG", [10, 20, 30, 40, 50, 60, 70])}
HOT = {"k": ("INT", [0] * 300 + [1, 2, 3]), "v": ("LONG", list(range(303)))}
HOT_DIM = {"k": ("INT", [0, 1, 2, 3, 9]), "w": ("LONG", [7, 8, 9, 10, 11])}


def _frame(sess, types, data, parts):
    return sess.create_dataframe(
        {k: (getattr(types, t), v) for k, (t, v) in data.items()},
        num_partitions=parts)


def _jax_host(**extra):
    return TpuSparkSession(JaxConf(dict(
        SPLIT, **{"spark.rapids.sql.enabled": False}, **extra)))


def _port(**extra):
    return GpuSparkSession(RapidsConf(dict(SPLIT, **extra)), device="cpu")


def _coalesce_query(sess, types, F):
    df = _frame(sess, types, MIXED, 3)
    agg = df.repartition(5, "s").group_by("k", "s").agg(
        F.sum("v").alias("sv"), F.count("*").alias("n"))
    dim = _frame(sess, types, DIM, 2)
    return agg.join(dim, on="k", how="inner").order_by("s", "k")


def test_coalescing_on_and_off_give_the_same_rows():
    want = _coalesce_query(_jax_host(), JT, JF).collect()
    on, off = _port(), _port(**ADAPTIVE_OFF)
    got_on = _coalesce_query(on, T, F).collect()
    got_off = _coalesce_query(off, T, F).collect()
    assert got_on == want
    assert got_off == want
    assert on.last_metrics.get("aqeCoalescedPartitions", 0) > 0
    assert "aqeCoalescedPartitions" not in off.last_metrics
    assert on.last_metrics["coalescedTo"] >= 1  # the sort's reader


SKEW = {"spark.rapids.sql.tpu.adaptive.coalesce.targetBytes": 512,
        "spark.rapids.sql.tpu.adaptive.skew.thresholdBytes": 512,
        "spark.sql.autoBroadcastJoinThreshold": -1}


@pytest.mark.parametrize("how", ["inner", "left", "right", "full"])
def test_skewed_join_matches_jax_host(how):
    """The hot side is the one the join streams (the right side for a
    right join); a full join is grouped but never chunked."""
    def q(sess, types):
        hot, dim = _frame(sess, types, HOT, 3), _frame(sess, types,
                                                       HOT_DIM, 2)
        if how == "right":
            return dim.join(hot, on="k", how="right")
        return hot.join(dim, on="k", how=how)

    want = sorted(q(_jax_host(**SKEW), JT).collect(), key=repr)
    sess = _port(**SKEW)
    got = sorted(q(sess, T).collect(), key=repr)
    assert got == want
    m = sess.last_metrics
    if how == "full":
        assert "aqeSkewSplits" not in m and "skewSplitChunks" not in m
    else:
        assert m.get("aqeSkewSplits", 0) >= 1, m
        assert m.get("skewSplitChunks", 0) > 1, m
    off = _port(**SKEW, **ADAPTIVE_OFF)
    assert sorted(q(off, T).collect(), key=repr) == want
    assert "skewSplitChunks" not in off.last_metrics


def _switch_query(sess, types, F, hint=False):
    big = _frame(sess, types, MIXED, 3).group_by("k", "v").agg(
        F.count("s").alias("c"))
    dim = _frame(sess, types, DIM, 2).group_by("k").agg(
        F.sum("w").alias("sw")).with_column_renamed("k", "dk")
    if hint:
        dim = F.broadcast(dim)
    return big.join(dim, big["k"] == dim["dk"], how="inner")


def test_broadcast_switch_matches_the_static_broadcast_plan():
    want = sorted(_switch_query(_jax_host(), JT, JF).collect())
    switched = _port()
    got = sorted(_switch_query(switched, T, F).collect())
    plan = switched.last_physical_plan.tree_string()
    assert "GpuShuffledHashJoin" in plan
    assert switched.last_metrics.get("replannedBroadcast") == 1
    assert switched.last_metrics.get("shuffleElided", 0) >= 1
    static = _port()
    rows_static = sorted(_switch_query(static, T, F, hint=True).collect())
    assert "GpuBroadcastHashJoin" in static.last_physical_plan.tree_string()
    never = _port(**{"spark.sql.autoBroadcastJoinThreshold": -1})
    rows_never = sorted(_switch_query(never, T, F).collect())
    assert "replannedBroadcast" not in never.last_metrics
    assert got == rows_static == rows_never == want
