"""PyTorch port, the eighth slice as a whole: the fifteen TPC-H texts the
seven of ``tests/test_torch_tpch_sql.py`` leave out (Q2, Q4, Q7, Q8, Q9,
Q11, Q13, Q15-Q22: residual join conditions, nested-loop and cross joins,
the date parts, ``substring`` and ``COUNT(DISTINCT)``) through
``session.sql`` of both packages on the CPU.

Both packages register the TPC-H tables from their own generators at
SF 1 in 3 partitions: at SF 0.02 Q2 and Q20 return no rows and Q19 a NULL
in both, so they would hold nothing to each other.  Column names must be
equal, rows in the same order (every query is ordered or has one row),
keys, dates and counts exact, and sums and averages within 1e-9 relative,
for the reason ``tests/test_torch_tpch_sql.py`` gives.  The physical plan
must have the reference's shape, exec by exec.  The JAX side runs each
text once (module fixture): its compiles are most of this file's time.

Q4, Q13 and Q21 join with a residual condition.  They run again in the
port on a one-device mesh (``spark.rapids.shuffle.ici.enabled``, growth
factor 1), where a join without a condition runs fused and a join with
one never does: their rows are held to the JAX package's default mode.
"""

import numpy as np
import pytest

from spark_rapids_tpu.benchmarks import datagen as JD
from spark_rapids_tpu.benchmarks import tpch_like as JQ
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.plan.overrides import TpuOverrides
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch.benchmarks import datagen as PD
from spark_rapids_tpu_torch.benchmarks import tpch_like as PQ
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.kernels import cuda_tier
from spark_rapids_tpu_torch.ops import gpu_exec as X
from spark_rapids_tpu_torch.session import GpuSparkSession

from test_torch_tpch_sql import MESH, SETTINGS, assert_rows_match
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from torch_port_util import plan_shape

SF = 1
PARTITIONS = 3
QUERIES = ["q2", "q4", "q7", "q8", "q9", "q11", "q13", "q15", "q16", "q17",
           "q18", "q19", "q20", "q21", "q22"]
#: the texts whose plan holds a nested-loop join (a CROSS JOIN)
NESTED_LOOP = {"q11", "q15", "q22"}
#: the texts whose joins carry a residual condition
CONDITIONED = ["q4", "q13", "q21"]
#: the mesh at growth factor 1: a fused join's static string byte
#: capacities grow by the factor times the row expansion, join by join,
#: and at the default 2 Q21's two fused joins leave its filter hashing 16
#: times its live bytes (85 s of plain CPU hashing here); at 1 both joins
#: fit their static capacities and run fused
MESH_GROWTH_1 = dict(MESH, **{
    "spark.rapids.sql.tpu.mesh.spmd.join.growthFactor": 1.0})


@pytest.fixture(scope="module")
def jax_rows():
    """The JAX package's (columns, rows, plan shape) per text."""
    sess = TpuSparkSession(JaxConf(SETTINGS))
    JD.register_tpch(sess, sf=SF, num_partitions=PARTITIONS)
    plan_conf = JaxConf(dict(SETTINGS,
                             **{"spark.rapids.sql.fusion.enabled": False}))
    out = {}
    for q in QUERIES:
        df = sess.sql(JQ.QUERIES[q])
        out[q] = (df.columns, df.collect(),
                  plan_shape(TpuOverrides(plan_conf).apply(df.plan)))
    return out


@pytest.fixture(scope="module")
def port_session():
    sess = GpuSparkSession(RapidsConf(SETTINGS), device="cpu")
    PD.register_tpch(sess, sf=SF, num_partitions=PARTITIONS)
    return sess


@pytest.fixture(scope="module")
def mesh_session():
    sess = GpuSparkSession(RapidsConf(dict(SETTINGS, **MESH_GROWTH_1)),
                           device="cpu")
    PD.register_tpch(sess, sf=SF, num_partitions=PARTITIONS)
    return sess


def _tokens(shape):
    tok, kids = shape
    yield tok
    for k in kids:
        yield from _tokens(k)


@pytest.mark.parametrize("query", QUERIES)
def test_sql_query_matches_jax(jax_rows, port_session, query):
    want_cols, want_rows, want_shape = jax_rows[query]
    cuda_tier.reset_launch_counts()
    df = port_session.sql(PQ.QUERIES[query])
    assert df.columns == want_cols
    assert_rows_match(df.collect(), want_rows, query)
    # CPU tensors take the plain versions, never a kernel
    assert all(cuda_tier.launch_count(n) == 0 for n in cuda_tier.SOURCES)
    shape = plan_shape(port_session.last_physical_plan)
    assert shape == want_shape, query
    nlj = [t for t in _tokens(shape) if t.startswith("NestedLoopJoin")]
    assert bool(nlj) == (query in NESTED_LOOP), (query, nlj)


def test_rows_at_this_scale(jax_rows):
    """SF 1 gives the texts rows to compare: Q2 13, Q20 one, Q19 a
    non-NULL sum (Q22's customers all have orders here: no rows)."""
    counts = {q: len(jax_rows[q][1]) for q in QUERIES}
    assert counts["q2"] == 13 and counts["q20"] == 1, counts
    assert jax_rows["q19"][1][0][0] is not None
    assert all(counts[q] for q in QUERIES if q != "q22"), counts


@pytest.mark.parametrize("query", CONDITIONED)
def test_conditioned_join_query_on_mesh_matches_jax(jax_rows, mesh_session,
                                                    monkeypatch, query):
    """On a one-device mesh a join without a condition may run fused; a
    join with one runs host-driven, with its condition: the rows stay the
    JAX package's."""
    fused, conditioned = [], []
    real_fused, real_join = X._HashJoinBase._join_fused, X.hash_join

    def join_fused(self, *args, **kwargs):
        fused.append(self.condition)
        return real_fused(self, *args, **kwargs)

    def hash_join(*args, condition=None, **kwargs):
        if condition is not None:
            conditioned.append(condition)
        return real_join(*args, condition=condition, **kwargs)

    monkeypatch.setattr(X._HashJoinBase, "_join_fused", join_fused)
    monkeypatch.setattr(X, "hash_join", hash_join)
    sess = mesh_session
    want_cols, want_rows, _ = jax_rows[query]
    df = sess.sql(PQ.QUERIES[query])
    assert df.columns == want_cols
    assert_rows_match(df.collect(), want_rows, query)
    assert conditioned, "no join ran with its condition"
    assert all(c is None for c in fused), fused
    assert sess.last_metrics.get("meshJoinsFused", 0) == len(fused)
    assert "joinOverflowFallback" not in sess.last_metrics


def _q22(session, datagen):
    """Q22's columns and rows over customer and orders at SF 0.2, every
    order placed by one of the first 150 customers: half the customers
    have none, so the anti join keeps rows (at SF 1 every customer has
    orders and Q22 is empty)."""
    orders = datagen.gen_orders(0.2)
    dtype, custkeys = orders["o_custkey"]
    orders["o_custkey"] = (dtype, np.minimum(custkeys, 150))
    for name, data in (("customer", datagen.gen_customer(0.2)),
                       ("orders", orders)):
        session.create_dataframe(data, num_partitions=PARTITIONS) \
            .create_or_replace_temp_view(name)
    df = session.sql(PQ.QUERIES["q22"])
    return df.columns, df.collect()


def test_q22_with_customers_without_orders_matches_jax():
    want_cols, want_rows = _q22(TpuSparkSession(JaxConf(SETTINGS)), JD)
    got_cols, got_rows = _q22(
        GpuSparkSession(RapidsConf(SETTINGS), device="cpu"), PD)
    assert want_rows and got_cols == want_cols
    assert_rows_match(got_rows, want_rows, "q22")
