"""PyTorch port, the SQL slice as a whole: TPC-H Q1, Q3, Q5, Q6, Q10, Q12
and Q14 as SQL text (``benchmarks/tpch_like.py``, the port's verbatim
copy) through ``session.sql`` of both packages on the CPU.

Both packages register the TPC-H tables from their own generators at
SF 0.02 in 3 partitions, as ``tests/test_tpch_like.py`` does.  Column names
must be equal, rows in the same order (every query here is ordered or has
one row), keys, dates and counts exact, and sums and averages within 1e-9
relative: the slot aggregate's float sums recombine limb rows with a
per-chunk scale that XLA on the CPU fuses into the cross-chunk sum as an
FMA under jit, where torch rounds the product first, so the last bits of a
float sum may differ.  The physical plan must have the reference's shape,
exec by exec (the JAX side planned with map fusion off, so filters stay
execs of their own as in the port).

Q10 groups by the DOUBLE ``c_acctbal``, which the JAX package keeps on the
CPU while NaNs are possible: both packages run with
``spark.rapids.sql.hasNans`` off, and with it on the port refuses Q10
(``tests/test_torch_sql.py``).  The join queries also run fused on a
one-device mesh (``spark.rapids.shuffle.ici.enabled``, the JAX side's mesh
pinned to one device as ``tests/test_torch_join_slice.py`` pins it, for
Q3; the other fused queries are held to the JAX package's rows of its
default mode, the same answer).  The JAX side runs each query once per
mode (module fixture): its compiles are most of this file's time.
"""

import math
import os
import subprocess
import sys
import textwrap

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
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from torch_port_util import plan_shape

SETTINGS = {"spark.rapids.sql.variableFloatAgg.enabled": True,
            "spark.sql.shuffle.partitions": 1,
            "spark.rapids.sql.hasNans": False}
MESH = {"spark.rapids.shuffle.ici.enabled": True}
SF = 0.02
PARTITIONS = 3
#: the seven texts of this slice; the other fifteen are
#: tests/test_torch_tpch_sql_more.py's, at a scale where they have rows
QUERIES = sorted(["q1", "q3", "q5", "q6", "q10", "q12", "q14"])
#: per join query: (joins, joins that overflow at the default growth
#: factor and rerun host-driven) at this scale
JOINS = {"q3": (2, 2), "q5": (4, 2), "q10": (2, 2), "q12": (1, 1)}
REL = 1e-9
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_jax(extra, names, plan=False):
    sess = TpuSparkSession(JaxConf(dict(SETTINGS, **extra)))
    JD.register_tpch(sess, sf=SF, num_partitions=PARTITIONS)
    out = {}
    for q in names:
        df = sess.sql(JQ.QUERIES[q])
        shape = None
        if plan:
            shape = plan_shape(TpuOverrides(JaxConf(dict(
                SETTINGS, **extra,
                **{"spark.rapids.sql.fusion.enabled": False}))).apply(
                    df.plan))
        out[q] = (df.columns, df.collect(), shape)
    return out


@pytest.fixture(scope="module")
def jax_rows():
    """The JAX package's (columns, rows, plan shape) per query and mode."""
    import spark_rapids_tpu.parallel.mesh_shuffle as MS
    real = MS.make_mesh
    out = {"default": _run_jax({}, QUERIES, plan=True)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MS, "make_mesh", lambda n_devices=None: real(1))
        out["mesh"] = _run_jax(MESH, ["q3"])
    return out


def _port_session(extra):
    sess = GpuSparkSession(RapidsConf(dict(SETTINGS, **extra)),
                           device="cpu")
    PD.register_tpch(sess, sf=SF, num_partitions=PARTITIONS)
    return sess


def assert_rows_match(got, want, label):
    """Same row count and order; ints and strings exact, floats within
    ``REL`` relative (both NaN-free here)."""
    assert len(got) == len(want), label
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), (label, i)
        for gv, wv in zip(g, w):
            if isinstance(wv, float):
                assert isinstance(gv, float) and math.isclose(
                    gv, wv, rel_tol=REL, abs_tol=0.0), (label, i, gv, wv)
            else:
                assert gv == wv, (label, i, gv, wv)


def test_query_texts_are_the_reference_texts():
    for q, text in PQ.QUERIES.items():
        assert text == JQ.QUERIES[q], q


@pytest.mark.parametrize("query", QUERIES)
def test_sql_query_matches_jax(jax_rows, query):
    want_cols, want_rows, want_shape = jax_rows["default"][query]
    assert want_rows, query  # every query has rows at this scale
    sess = _port_session({})
    for i in range(2):
        cuda_tier.reset_launch_counts()
        df = sess.sql(PQ.QUERIES[query])
        assert df.columns == want_cols
        assert_rows_match(df.collect(), want_rows, query)
        # CPU tensors take the plain versions, never a kernel
        assert all(cuda_tier.launch_count(n) == 0 for n in cuda_tier.SOURCES)
        assert plan_shape(sess.last_physical_plan) == want_shape, query


@pytest.mark.parametrize("query", list(JOINS))
def test_sql_join_query_fused_on_mesh_matches_jax(jax_rows, query):
    """Every join of the query runs fused.  A fused join's static pair
    capacity is its probe side's capacity times the growth factor (2);
    where the WHERE clause, above the joins, leaves a join unfiltered the
    true pair count is larger, so that join overflows and reruns
    host-driven, as the JAX package's does (its ``meshFallbacks``).  The
    capacities compound join by join, so no one factor fits all four
    queries (Q5's fourth join at 64 would size 2^36 string bytes);
    ``tests/test_torch_join_slice.py`` holds fused outputs that fit."""
    want_cols, want_rows, _ = jax_rows["default"][query]
    if query in jax_rows["mesh"]:  # the JAX side fused too
        assert_rows_match(jax_rows["mesh"][query][1], want_rows, query)
    sess = _port_session(MESH)
    df = sess.sql(PQ.QUERIES[query])
    assert df.columns == want_cols
    assert_rows_match(df.collect(), want_rows, query)
    fused, overflowed = JOINS[query]
    assert sess.last_metrics == {"meshJoinsFused": fused,
                                 "joinOverflowFallback": overflowed}


def test_sql_queries_run_without_jax():
    """The seven texts through ``session.sql`` in a process that never
    imports jax or the JAX package."""
    code = textwrap.dedent(f"""
        import sys
        from spark_rapids_tpu_torch.benchmarks import datagen as D
        from spark_rapids_tpu_torch.benchmarks.tpch_like import QUERIES
        from spark_rapids_tpu_torch.config import RapidsConf
        from spark_rapids_tpu_torch.session import GpuSparkSession
        s = GpuSparkSession(RapidsConf({SETTINGS!r}), device="cpu")
        D.register_tpch(s, sf={SF}, num_partitions={PARTITIONS})
        counts = [len(s.sql(QUERIES[q]).collect()) for q in {QUERIES!r}]
        assert all(counts), counts
        print("jax" in sys.modules,
              any(m.split(".")[0] == "spark_rapids_tpu" for m in sys.modules))
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]
