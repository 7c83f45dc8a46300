"""PyTorch port, the TPCxBB lane as a whole: the eight texts of
``benchmarks/tpcxbb_like.py`` (the port's copy) through ``session.sql`` of
both packages on the CPU.

Both packages register the TPCxBB tables from their own generators at the
JAX suite's ``SF = 0.05`` in 3 partitions.  The port runs its device path
on CPU tensors at the JAX suite's settings (``tests/compare.py``
``tpu_session``: the defaults, 4 shuffle partitions; the float sums then
aggregate on the host in both packages) and at the device settings
(``variableFloatAgg`` on, ``hasNans`` off: every operator on the device),
and as its host engine; each must give the JAX host engine's rows
(``spark.rapids.sql.enabled=false``): in order, keys and counts exact,
float sums, averages and ratios within 1e-9 relative, because the device
sums in another order than the host engine's row-order ``np.sum``.  The
physical plans must have the JAX planner's shape, exec by exec, and the
test mode must find the same host execs in both (planning only).
"""

import math

import numpy as np
import pytest

from spark_rapids_tpu.benchmarks import tpcxbb_like as JX
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.plan.overrides import TpuOverrides
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch.benchmarks import tpcxbb_like as PX
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.plan.overrides import GpuOverrides
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from torch_port_util import host_execs, plan_shape

SF = 0.05
PARTITIONS = 3
REL = 1e-9
SETTINGS = {
    "defaults": {"spark.sql.shuffle.partitions": 4},
    "device": {"spark.rapids.sql.variableFloatAgg.enabled": True,
               "spark.rapids.sql.hasNans": False,
               "spark.sql.shuffle.partitions": 4},
    "host": {"spark.rapids.sql.enabled": False,
             "spark.sql.shuffle.partitions": 4},
}
QUERIES = sorted(PX.QUERIES, key=lambda q: int(q[1:]))
GENERATORS = ["gen_item", "gen_customer", "gen_customer_demographics",
              "gen_customer_address", "gen_store", "gen_warehouse",
              "gen_date_dim", "gen_promotion", "gen_web_clickstreams",
              "gen_store_sales", "gen_store_returns", "gen_web_sales",
              "gen_web_returns", "gen_inventory"]


def _same_value(got, want) -> bool:
    if isinstance(want, float) and isinstance(got, float):
        if math.isnan(want) or math.isnan(got):
            return math.isnan(want) and math.isnan(got)
        return got == want or abs(got - want) <= REL * abs(want)
    return got == want and type(got) is type(want)


@pytest.fixture(scope="module")
def sessions():
    jax, port = {}, {}
    for key, conf in SETTINGS.items():
        jax[key] = TpuSparkSession(JaxConf(dict(conf)))
        JX.register_tpcxbb(jax[key], sf=SF, num_partitions=PARTITIONS)
        port[key] = GpuSparkSession(RapidsConf(dict(conf)), device="cpu")
        PX.register_tpcxbb(port[key], sf=SF, num_partitions=PARTITIONS)
    return jax, port


def test_port_texts_are_the_reference_texts():
    assert PX.QUERIES == JX.QUERIES
    assert len(PX.QUERIES) == 8


@pytest.mark.parametrize("gen", GENERATORS)
def test_generator_gives_the_jax_arrays(gen):
    takes_sf = gen not in ("gen_customer_demographics",
                           "gen_customer_address", "gen_store",
                           "gen_warehouse", "gen_date_dim", "gen_promotion")
    args = (SF,) if takes_sf else ()
    want, got = getattr(JX, gen)(*args), getattr(PX, gen)(*args)
    assert list(got) == list(want)
    for name in want:
        assert got[name][0].name == want[name][0].name
        w, g = want[name][1], got[name][1]
        if isinstance(w, list):  # NULLs as None
            assert g == w, name
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=name)


@pytest.mark.parametrize("engine", ["defaults", "device", "host"])
@pytest.mark.parametrize("q", QUERIES)
def test_text_matches_jax_host_engine(sessions, q, engine):
    jax, port = sessions
    want_df = jax["host"].sql(JX.QUERIES[q])
    got_df = port[engine].sql(PX.QUERIES[q])
    assert got_df.columns == want_df.columns
    want, got = want_df.collect(), got_df.collect()
    assert len(got) == len(want), f"{q}: {len(got)} rows, {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(got_df.columns, g, w):
            assert _same_value(a, b), \
                f"{q} ({engine}) row {i} column {name}: port {a!r}, " \
                f"JAX {b!r}"


@pytest.mark.parametrize("settings", ["defaults", "device"])
@pytest.mark.parametrize("q", QUERIES)
def test_text_plan_matches_jax_planner(sessions, q, settings):
    """Exec by exec, placement included; under the test mode both plans
    hold the same host execs, none at the device settings."""
    jax, port = sessions
    conf = SETTINGS[settings]
    jconf = JaxConf(dict(conf, **{"spark.rapids.sql.fusion.enabled":
                                  False}))
    want = TpuOverrides(jconf).apply(jax[settings].sql(JX.QUERIES[q]).plan)
    got = GpuOverrides(RapidsConf(dict(conf))).apply(
        port[settings].sql(PX.QUERIES[q]).plan)
    assert plan_shape(got) == plan_shape(want)
    assert host_execs(got) == host_execs(want)
    if settings == "device":
        assert host_execs(got) == []
