"""The port's join column pruning (``spark.rapids.sql.tpu.columnPruning
.enabled``, ``plan/overrides.py:_prune_columns``), which the out-of-core
run turns on: every join's inputs are projected down to the columns read
above the join.  The JAX package has no such pass, so the 22 TPC-H texts
with pruning on are held to the JAX host engine's rows over the same
generated tables (SF 0.2 in 3 partitions, ``spark.sql.shuffle.partitions``
4: joins on both sides of exchanges), within the tolerance
``tests/test_torch_tpch_sql.py`` states.  Off, the default, the plan is
the JAX package's exec by exec (``tests/test_torch_tpch_sql*.py``)."""

import pytest

from spark_rapids_tpu.benchmarks import datagen as JD
from spark_rapids_tpu.benchmarks import tpch_like as JQ
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch.benchmarks import datagen as PD
from spark_rapids_tpu_torch.benchmarks import tpch_like as PQ
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.overrides import _prune_columns
from spark_rapids_tpu_torch.session import GpuSparkSession

from test_torch_tpch_sql import SETTINGS, assert_rows_match
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from torch_port_util import plan_shape

SF = 0.2
PARTITIONS = 3
QUERIES = sorted(PQ.QUERIES, key=lambda q: int(q[1:]))
CONF = dict(SETTINGS, **{"spark.sql.shuffle.partitions": 4})
PRUNE = {"spark.rapids.sql.tpu.columnPruning.enabled": True}


@pytest.fixture(scope="module")
def jax_rows():
    sess = TpuSparkSession(JaxConf(dict(CONF, **{
        "spark.rapids.sql.enabled": False})))
    JD.register_tpch(sess, sf=SF, num_partitions=PARTITIONS)
    return {q: sess.sql(JQ.QUERIES[q]).collect() for q in QUERIES}


@pytest.fixture(scope="module")
def sessions():
    out = {}
    for name, extra in (("pruned", PRUNE), ("plain", {})):
        sess = GpuSparkSession(RapidsConf(dict(CONF, **extra)),
                               device="cpu")
        PD.register_tpch(sess, sf=SF, num_partitions=PARTITIONS)
        out[name] = sess
    return out


def _joins(op):
    if "Join" in type(op).__name__:
        yield op
    for c in op.children:
        yield from _joins(c)


@pytest.mark.parametrize("query", QUERIES)
def test_pruned_rows_match_jax_host(jax_rows, sessions, query):
    sess = sessions["pruned"]
    df = sess.sql(PQ.QUERIES[query])
    assert_rows_match(df.collect(), jax_rows[query], query)
    # no join carries a column nothing above it reads: each input is at
    # most as wide as unpruned, and the plan differs only by projects
    plain = sessions["plain"].plan_physical(df.plan)
    pruned = sess.last_physical_plan
    for a, b in zip(_joins(pruned), _joins(plain)):
        for ca, cb in zip(a.children, b.children):
            assert len(ca.output_schema) <= len(cb.output_schema), query

    def no_projects(shape):
        tok, kids = shape
        kids = [no_projects(k) for k in kids]
        if tok == "Project" and len(kids) == 1:
            return kids[0]
        return (tok, kids)

    assert no_projects(plan_shape(pruned)) == \
        no_projects(plan_shape(plain)), query


def test_q18_joins_carry_only_what_is_read(sessions):
    """Q18's three joins: customer with orders 2 + 4 columns, that with
    lineitem 5 + 2, the semi join its left side's 6 (the five grouped
    columns and the summed quantity)."""
    sess = sessions["pruned"]
    sess.sql(PQ.QUERIES["q18"]).collect()
    widths = sorted(len(j.output_schema)
                    for j in _joins(sess.last_physical_plan))
    assert widths == [6, 6, 7], widths  # unpruned: 17, 33, 33


def test_pruning_leaves_the_users_plan_and_the_cache(sessions):
    sess = sessions["pruned"]
    cached = sess.table("lineitem").cache()
    cached.create_or_replace_temp_view("lineitem_c")
    df = sess.sql("SELECT o_orderdate, sum(l_quantity) AS q FROM orders "
                  "JOIN lineitem_c ON o_orderkey = l_orderkey "
                  "GROUP BY o_orderdate")
    before = [type(n).__name__ for n in _walk(df.plan)]
    pruned = _prune_columns(df.plan, None)
    assert [type(n).__name__ for n in _walk(df.plan)] == before
    rel = [n for n in _walk(pruned) if isinstance(n, L.CachedRelation)]
    orig = [n for n in _walk(df.plan) if isinstance(n, L.CachedRelation)]
    assert rel and rel[0] is orig[0]  # the shared cache is not rebuilt
    assert sorted(df.collect()) == sorted(
        sessions["plain"].sql(
            "SELECT o_orderdate, sum(l_quantity) AS q FROM orders JOIN "
            "lineitem ON o_orderkey = l_orderkey GROUP BY o_orderdate"
        ).collect())
    cached.unpersist()


def _walk(plan):
    yield plan
    for c in plan.children:
        yield from _walk(c)
