"""PyTorch port, the 22 TPC-H texts with the partitioned exchange on
(``spark.rapids.sql.tpu.exchange.collapseLocal`` off), against the JAX
package on the CPU, at generator sf 0.1.

* rows: the port's split run gives the JAX host engine's rows (its
  exchanges split too) and the port's collapsed run's rows, in order;
  floats within 1e-9 relative (the device sums floats in fixed-point
  limbs, the host engine with ``np.sum``, in another order);
* placement: every logical node lands on the same side as in the JAX
  package, and the physical plan has the JAX package's shape exec by exec
  (coalescing readers included), the collapse on and off (planning
  only);
* the split ran where the plan has a partitioned exchange: one sync per
  split exchange.
"""

import math

import pytest

from spark_rapids_tpu.benchmarks import datagen as JD
from spark_rapids_tpu.benchmarks import tpch_like as JQ
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.plan.overrides import PlanMeta as JaxPlanMeta
from spark_rapids_tpu.plan.overrides import TpuOverrides
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch.benchmarks import datagen as PD
from spark_rapids_tpu_torch.benchmarks import tpch_like as PQ
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.plan.overrides import GpuOverrides, PlanMeta
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from torch_port_util import plan_shape

SF = 0.1
PARTITIONS = 3
TEXTS = sorted(PQ.QUERIES, key=lambda q: int(q[1:]))
SPLIT = {"spark.rapids.sql.tpu.exchange.collapseLocal": False}
DEVICE = {"spark.rapids.sql.hasNans": False,
          "spark.rapids.sql.variableFloatAgg.enabled": True}
REL = 1e-9


@pytest.fixture(scope="module")
def sessions():
    """The JAX host engine's session (split), and the port's split and
    collapsed sessions, each over its own package's tables."""
    jax_host = TpuSparkSession(JaxConf(dict(
        SPLIT, **{"spark.rapids.sql.enabled": False})))
    JD.register_tpch(jax_host, sf=SF, num_partitions=PARTITIONS)
    split = GpuSparkSession(RapidsConf(dict(DEVICE, **SPLIT)), device="cpu")
    PD.register_tpch(split, sf=SF, num_partitions=PARTITIONS)
    collapsed = GpuSparkSession(RapidsConf(DEVICE), device="cpu")
    PD.register_tpch(collapsed, sf=SF, num_partitions=PARTITIONS)
    return jax_host, split, collapsed


def _same(got, want) -> bool:
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float) and isinstance(a, float):
                if math.isnan(b) or math.isnan(a):
                    if not (math.isnan(a) and math.isnan(b)):
                        return False
                elif a != b and abs(a - b) > REL * abs(b):
                    return False
            elif a != b or type(a) is not type(b):
                return False
    return True


@pytest.mark.parametrize("q", TEXTS)
def test_split_text_matches_jax_host_engine(sessions, q):
    jax_host, split, collapsed = sessions
    want = jax_host.sql(JQ.QUERIES[q]).collect()
    got = split.sql(PQ.QUERIES[q]).collect()
    assert _same(got, want), f"{q}: port {got[:3]}, JAX {want[:3]}"
    syncs = [m["shuffleSyncs"] for m in split.last_op_metrics.values()
             if m.get("shuffleSplitDispatches")]
    assert all(n == 1 for n in syncs), syncs
    assert _same(collapsed.sql(PQ.QUERIES[q]).collect(), got)


def _walk(meta, on_device, depth=0):
    out = [(depth, meta.node.name, on_device(meta))]
    for c in meta.children:
        out.extend(_walk(c, on_device, depth + 1))
    return out


@pytest.mark.parametrize("collapse", [True, False], ids=["collapsed",
                                                         "split"])
def test_split_placement_matches_jax(sessions, collapse):
    jax_host, split, _ = sessions
    settings = dict(DEVICE, **{"spark.rapids.sql.tpu.exchange."
                               "collapseLocal": collapse})
    for q in TEXTS:
        jplan = jax_host.sql(JQ.QUERIES[q]).plan
        pplan = split.sql(PQ.QUERIES[q]).plan
        jconf, pconf = JaxConf(dict(settings)), RapidsConf(dict(settings))
        jmeta, pmeta = JaxPlanMeta(jplan, jconf), PlanMeta(pplan, pconf)
        TpuOverrides(jconf).tag(jmeta)
        GpuOverrides(pconf).tag(pmeta)
        assert _walk(pmeta, lambda m: m.can_run_on_gpu) == \
            _walk(jmeta, lambda m: m.can_run_on_tpu), q
        want = plan_shape(TpuOverrides(JaxConf(dict(
            settings, **{"spark.rapids.sql.fusion.enabled": False})))
            .apply(jplan))
        assert plan_shape(GpuOverrides(pconf).apply(pplan)) == want, q
