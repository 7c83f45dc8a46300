"""PyTorch port, the TPC-DS lane as a whole: all 105 TPC-DS-like texts
(``benchmarks/tpcds_like.py``, the port's copy: the reference's 103-query
list plus ``q14`` and ``ss_max``) through ``session.sql`` of both packages
on the CPU.

Both packages register the TPC-DS tables from their own generators at
generator sf 0.1 in 3 partitions, the scale of ``tests/test_tpcds_like.py``.
The port runs with the device-path settings (``variableFloatAgg`` on except
for q67 and q70, as the reference's suite runs them; ``hasNans`` off); its
rows must equal the JAX package's host engine's
(``spark.rapids.sql.enabled=false``, Python rows): in order, column names
equal, keys, counts and ranks exact; float sums, averages and moments
within 1e-9 relative, because the port's device path sums in another order
than the host engine's row-by-row ``np.sum`` (the slot aggregate's limb
sums, the sort path's segment sums, a window's frame sums as differences
of a running ``cumsum``).  The physical plans must have the JAX planner's
shape, exec by exec, by planning alone (``TpuOverrides(conf).apply`` with
fusion off): no text runs through the JAX device path, whose per-text
compiles make ``tests/test_tpcds_like.py`` the suite's longest file.
"""

import math

import pytest

from spark_rapids_tpu.benchmarks import tpcds_like as JQ
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.plan.overrides import TpuOverrides
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch.benchmarks import tpcds_like as PQ
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.plan.overrides import GpuOverrides
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from torch_port_util import plan_shape

SF = 0.1
PARTITIONS = 3
SETTINGS = {"spark.rapids.sql.variableFloatAgg.enabled": True,
            "spark.sql.shuffle.partitions": 1,
            "spark.rapids.sql.hasNans": False}
#: the reference's suite runs these two without variableFloatAgg
#: (tests/test_tpcds_like.py), so their float sums aggregate on the host
NO_VAR_AGG = {"q67", "q70"}
QUERIES = sorted(PQ.QUERIES)
REL = 1e-9


def _conf(q: str) -> dict:
    if q in NO_VAR_AGG:
        return dict(SETTINGS,
                    **{"spark.rapids.sql.variableFloatAgg.enabled": False})
    return dict(SETTINGS)


@pytest.fixture(scope="module")
def sessions():
    """The JAX host engine's session and the port's, one per setting,
    each over its own package's tables."""
    jax_host = TpuSparkSession(JaxConf({"spark.rapids.sql.enabled": False,
                                        "spark.sql.shuffle.partitions": 1}))
    JQ.register_tpcds(jax_host, sf=SF, num_partitions=PARTITIONS)
    jax_plan = TpuSparkSession(JaxConf(SETTINGS))
    JQ.register_tpcds(jax_plan, sf=SF, num_partitions=PARTITIONS)
    ports = {}
    for key in ("var", "novar"):
        conf = _conf("q67" if key == "novar" else "q3")
        ports[key] = GpuSparkSession(RapidsConf(conf), device="cpu")
        PQ.register_tpcds(ports[key], sf=SF, num_partitions=PARTITIONS)
    return jax_host, jax_plan, ports


def _port(ports, q):
    return ports["novar" if q in NO_VAR_AGG else "var"]


def _same_value(got, want) -> bool:
    if isinstance(want, float) and isinstance(got, float):
        if math.isnan(want) or math.isnan(got):
            return math.isnan(want) and math.isnan(got)
        return got == want or abs(got - want) <= REL * abs(want)
    return got == want and type(got) is type(want)


def test_port_texts_are_the_reference_texts():
    """The port's copy holds the JAX package's 105 texts, unchanged."""
    assert PQ.QUERIES == JQ.QUERIES
    assert len(PQ.QUERIES) == 105


@pytest.mark.parametrize("q", QUERIES)
def test_tpcds_text_matches_jax_host_engine(sessions, q):
    jax_host, _, ports = sessions
    want_df = jax_host.sql(JQ.QUERIES[q])
    got_df = _port(ports, q).sql(PQ.QUERIES[q])
    assert got_df.columns == want_df.columns
    want, got = want_df.collect(), got_df.collect()
    assert len(got) == len(want), f"{q}: {len(got)} rows, {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        for name, a, b in zip(got_df.columns, g, w):
            assert _same_value(a, b), \
                f"{q} row {i} column {name}: port {a!r}, JAX {b!r}"


@pytest.mark.parametrize("q", QUERIES)
def test_tpcds_plan_matches_jax_planner(sessions, q):
    """Exec by exec, placement included; with the test mode on, every text
    but q67 and q70 plans with no host exec but the scans, transitions and
    collapsed host exchanges."""
    _, jax_plan, ports = sessions
    jconf = JaxConf(dict(_conf(q), **{"spark.rapids.sql.fusion.enabled":
                                      False}))
    want = plan_shape(TpuOverrides(jconf).apply(jax_plan.sql(
        JQ.QUERIES[q]).plan))
    df = _port(ports, q).sql(PQ.QUERIES[q])
    got = plan_shape(GpuOverrides(RapidsConf(_conf(q))).apply(df.plan))
    assert got == want
    if q not in NO_VAR_AGG:
        from spark_rapids_tpu_torch.session import _assert_on_gpu
        conf = RapidsConf(dict(_conf(q),
                               **{"spark.rapids.sql.test.enabled": True}))
        _assert_on_gpu(GpuOverrides(conf).apply(df.plan))
