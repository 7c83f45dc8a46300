"""PyTorch port, the join slice as a whole: TPC-H Q3 (two equi-joins, a
three-key aggregate, ORDER BY revenue DESC, LIMIT 10) through the port on
the CPU against the JAX package, in each way the port runs a join:

* broadcast, as the planner picks it at this size (both joins);
* shuffled (``spark.sql.autoBroadcastJoinThreshold`` 0): shuffled hash
  joins over collapsed hash exchanges, host-driven;
* fused on a one-device mesh (``spark.rapids.shuffle.ici.enabled``): both
  joins through ``hash_join_static`` and joinProbe's plain version.

The tables come from each package's own generator at a small scale, cached
as batches of 1,024 rows.  Rows must be equal and in the same order, every
value bit for bit (both packages sum each group's floats in the same row
order), and the physical plan must have the same shape exec by exec.  The
JAX package's mesh is pinned to one device as ``tests/test_mesh_spmd_join
.py`` pins it; that package keeps a stage holding a single-partition
exchange (the LIMIT) out of mesh fusion, so its fused run is Q3 without
the LIMIT, whose first 10 rows are Q3's.  The JAX side runs once per mode
(module fixture): its compiles are most of this file's time.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.benchmarks import datagen as JD
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.dataframe import DataFrame as JaxDataFrame
from spark_rapids_tpu.plan.logical import InMemoryScan as JaxScan
from spark_rapids_tpu.plan.overrides import TpuOverrides
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch import functions as PF
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.benchmarks import datagen as PD
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.dataframe import DataFrame
from spark_rapids_tpu_torch.interop import host_batches
from spark_rapids_tpu_torch.kernels import cuda_tier
from spark_rapids_tpu_torch.parallel.exchange import PARTITIONINGS
from spark_rapids_tpu_torch.plan.logical import InMemoryScan
from spark_rapids_tpu_torch.plan.overrides import UnsupportedPlanError
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

SETTINGS = {"spark.rapids.sql.variableFloatAgg.enabled": True,
            "spark.sql.shuffle.partitions": 1}
SHUFFLED = {"spark.sql.autoBroadcastJoinThreshold": 0}
MESH = {"spark.rapids.shuffle.ici.enabled": True}
GROWTH_KEY = "spark.rapids.sql.tpu.mesh.spmd.join.growthFactor"
MODES = {"broadcast": {}, "shuffled": SHUFFLED, "mesh": {**SHUFFLED, **MESH}}
BATCH_ROWS = 1024
SF = 0.05  # customer 75, orders 750, lineitem 3,000 rows
TABLES = {"customer": "gen_customer", "orders": "gen_orders",
          "lineitem": "gen_lineitem"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def q3(tables, F, limit=True):
    """TPC-H Q3 as the repo defines it (benchmarks/tpch_like.py Q3)."""
    c = tables["customer"].filter(F.col("c_mktsegment") == "BUILDING")
    o = tables["orders"].filter(F.col("o_orderdate") < 9204)
    li = tables["lineitem"].filter(F.col("l_shipdate") > 9204)
    q = (c.join(o, F.col("c_custkey") == F.col("o_custkey"))
          .join(li, F.col("o_orderkey") == F.col("l_orderkey"))
          .group_by("o_orderkey", "o_orderdate", "o_shippriority")
          .agg(F.sum("l_extendedprice").alias("revenue"))
          .order_by(F.col("revenue").desc(), "o_orderdate"))
    return q.limit(10) if limit else q


def _jax_tables(sess):
    out = {}
    for name, gen in TABLES.items():
        data = getattr(JD, gen)(SF)
        n = len(next(iter(data.values()))[1])
        parts = [JaxHostBatch.from_pydict({
            k: (t, np.asarray(v)[s:s + BATCH_ROWS])
            for k, (t, v) in data.items()}) for s in range(0, n, BATCH_ROWS)]
        out[name] = JaxDataFrame(JaxScan(parts, parts[0].schema, 1),
                                 sess).cache()
    return out


def _port_tables(sess):
    out = {}
    for name, gen in TABLES.items():
        parts = host_batches(getattr(PD, gen)(SF), BATCH_ROWS)
        out[name] = DataFrame(InMemoryScan(parts, parts[0].schema, 1),
                              sess).cache()
    return out


def _shape(op):
    """The plan as nested (exec, children) tokens, either package's: the
    class name without its package prefix, plus what tells two execs of one
    class apart.  The JAX package's coalesced shuffle reader above a range
    exchange (adaptive partition coalescing, not ported) is skipped."""
    name = type(op).__name__
    if name == "TpuCoalescedShuffleReaderExec":
        return _shape(op.children[0])
    tok = name.replace("Tpu", "").replace("Gpu", "").replace("Exec", "")
    if tok == "ShuffleExchange":
        kind = getattr(op, "kind", None)
        tok += "/" + (PARTITIONINGS[kind] if kind else
                      type(op.partitioning).__name__)
    if "HashJoin" in tok:
        tok += f"/{op.how}/{getattr(op, 'broadcast_side', '')}"
    if tok == "HashAggregate":
        tok += "/" + op.mode
    return (tok, tuple(_shape(c) for c in op.children))


@pytest.fixture(scope="module")
def jax_q3():
    """Per mode: the JAX package's Q3 rows and plan shape (planned with map
    fusion off, so filters stay execs of their own as in the port)."""
    import spark_rapids_tpu.parallel.mesh_shuffle as MS
    real = MS.make_mesh
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MS, "make_mesh", lambda n_devices=None: real(1))
        for mode, extra in MODES.items():
            settings = dict(SETTINGS, **extra)
            sess = TpuSparkSession(JaxConf(settings))
            tables = _jax_tables(sess)
            plan = TpuOverrides(JaxConf(dict(
                settings, **{"spark.rapids.sql.fusion.enabled": False}))
            ).apply(q3(tables, JF).plan)
            if mode == "mesh":
                rows = q3(tables, JF, limit=False).collect()[:10]
                m = sess.last_metrics
                # both joins fused (the count is per stage build), and no
                # overflow rerun
                assert m["meshJoinsFused"] >= 2 and m["meshFallbacks"] == 0, m
            else:
                rows = q3(tables, JF).collect()
            out[mode] = (rows, _shape(plan))
    return out


def _port_session(extra):
    return GpuSparkSession(RapidsConf(dict(SETTINGS, **extra)), device="cpu")


@pytest.mark.parametrize("mode", list(MODES))
def test_q3_matches_jax(jax_q3, mode):
    want_rows, want_shape = jax_q3[mode]
    assert len(want_rows) == 10
    sess = _port_session(MODES[mode])
    tables = _port_tables(sess)
    for i in range(2):  # the second collect reads the cached batches
        cuda_tier.reset_launch_counts()
        assert q3(tables, PF).collect() == want_rows
        # CPU tensors take the plain versions, never a kernel
        assert all(cuda_tier.launch_count(n) == 0 for n in cuda_tier.SOURCES)
        fused = sess.last_metrics.get("meshJoinsFused", 0)
        assert fused == (2 if mode == "mesh" else 0), sess.last_metrics
        assert "joinOverflowFallback" not in sess.last_metrics
        if i == 0:  # planned before the caches filled, as the JAX plan was
            assert _shape(sess.last_physical_plan) == want_shape


def test_q3_overflow_reruns_host_driven(jax_q3):
    """A growth factor far too small: both fused joins overflow their
    static pair capacity, rerun host-driven and count it; rows unchanged."""
    sess = _port_session({**MODES["mesh"], GROWTH_KEY: 0.01})
    assert q3(_port_tables(sess), PF).collect() == jax_q3["mesh"][0]
    assert sess.last_metrics == {"meshJoinsFused": 2,
                                 "joinOverflowFallback": 2}


def test_q3_broadcast_joins_fuse_on_mesh(jax_q3):
    """Broadcast joins fuse too under a mesh: the build subtrees hold no
    exchange and share nothing with the stream side."""
    sess = _port_session(MESH)
    assert q3(_port_tables(sess), PF).collect() == jax_q3["broadcast"][0]
    assert sess.last_metrics == {"meshJoinsFused": 2}


@pytest.mark.parametrize("sf", [0.05, 1.5])
def test_datagen_matches_jax(sf):
    for gen in ("gen_orders", "gen_customer"):
        want, got = getattr(JD, gen)(sf), getattr(PD, gen)(sf)
        assert list(got) == list(want)
        for name in want:
            assert got[name][0].name == want[name][0].name, name
            g, w = np.asarray(got[name][1]), np.asarray(want[name][1])
            assert g.dtype.kind == w.dtype.kind, name
            np.testing.assert_array_equal(g, w, err_msg=name)


# -- every join type through the DataFrame API, against plain Python -------

LEFT = {"name": ["red", "green", None, "blue", "red", ""],
        "age": [1, 2, 3, 4, 5, 6]}
RIGHT = {"name": ["red", "blue", "missing", None, ""],
         "bonus": [10, 20, 30, 40, 50]}


def _frames(sess):
    left = sess.create_dataframe({"name": (T.STRING, LEFT["name"]),
                                  "age": (T.INT, LEFT["age"])})
    right = sess.create_dataframe({"name": (T.STRING, RIGHT["name"]),
                                   "bonus": (T.LONG, RIGHT["bonus"])})
    return left, right


def _python_join(how):
    """Nested-loop join of LEFT and RIGHT on ``name`` (NULL never equal),
    columns as the port's ``on=Column`` join lays them out."""
    lrows = list(zip(LEFT["name"], LEFT["age"]))
    rrows = list(zip(RIGHT["name"], RIGHT["bonus"]))
    out, r_hit = [], set()
    for lr in lrows:
        hits = [j for j, rr in enumerate(rrows)
                if lr[0] is not None and lr[0] == rr[0]]
        if how == "left_semi":
            out += [lr] if hits else []
            continue
        if how == "left_anti":
            out += [] if hits else [lr]
            continue
        out += [lr + rrows[j] for j in hits]
        r_hit.update(hits)
        if not hits and how in ("left", "full"):
            out.append(lr + (None, None))
    if how in ("right", "full"):
        out += [(None, None) + rr for j, rr in enumerate(rrows)
                if j not in r_hit]
    return out


@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "left_semi", "left_anti"])
@pytest.mark.parametrize("mode", ["broadcast", "shuffled", "mesh"])
def test_join_types_match_python(how, mode):
    sess = _port_session(MODES[mode])
    left, right = _frames(sess)
    rows = left.join(right, PF.col("name") == PF.col("name"), how).collect()
    assert sorted(rows, key=repr) == sorted(_python_join(how), key=repr)
    want_cols = ["name", "age"] + ([] if how.startswith("left_") else
                                   ["name_r", "bonus"])
    assert left.join(right, PF.col("name") == PF.col("name"),
                     how).columns == want_cols


@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "left_semi", "left_anti"])
@pytest.mark.parametrize("threshold", [10 << 20, 80, 0],
                         ids=["both-small", "left-only-small", "none"])
def test_join_strategy_matches_jax(how, threshold):
    """The planner picks the JAX package's strategy and build side from
    the same size estimates (measured in-memory scans: left 75 bytes,
    right 84): planned only, nothing runs; the JAX side with map fusion
    off, as in :func:`jax_q3`."""
    settings = dict(SETTINGS, **{
        "spark.sql.autoBroadcastJoinThreshold": threshold})
    jsess = TpuSparkSession(JaxConf(settings))
    jleft = jsess.create_dataframe({"name": (JT.STRING, LEFT["name"]),
                                    "age": (JT.INT, LEFT["age"])})
    jright = jsess.create_dataframe({"name": (JT.STRING, RIGHT["name"]),
                                     "bonus": (JT.LONG, RIGHT["bonus"])})
    want = TpuOverrides(JaxConf(dict(
        settings, **{"spark.rapids.sql.fusion.enabled": False}))).apply(
        jleft.join(jright, JF.col("name") == JF.col("name"), how).plan)
    sess = _port_session({"spark.sql.autoBroadcastJoinThreshold": threshold})
    left, right = _frames(sess)
    got = sess.plan_physical(left.join(
        right, PF.col("name") == PF.col("name"), how).plan)
    assert _shape(got) == _shape(want)


def test_using_join_matches_jax_schema():
    """USING joins (one key column out, coalesced for a full join) plan the
    JAX package's output schema, and run."""
    sess = _port_session({})
    jsess = TpuSparkSession(JaxConf(SETTINGS))
    left, right = _frames(sess)
    jleft = jsess.create_dataframe({"k": (JT.LONG, [1, 2, None]),
                                    "a": (JT.LONG, [1, 2, 3])})
    jright = jsess.create_dataframe({"k": (JT.LONG, [2, 3, None]),
                                     "b": (JT.LONG, [7, 8, 9])})
    pleft = sess.create_dataframe({"k": (T.LONG, [1, 2, None]),
                                   "a": (T.LONG, [1, 2, 3])})
    pright = sess.create_dataframe({"k": (T.LONG, [2, 3, None]),
                                    "b": (T.LONG, [7, 8, 9])})
    for how in ("inner", "left", "right", "full", "left_semi"):
        want = jleft.join(jright, on="k", how=how).schema
        got = pleft.join(pright, on="k", how=how).schema
        assert [(f.name, f.dtype.name, f.nullable) for f in got.fields] == \
            [(f.name, f.dtype.name, f.nullable) for f in want.fields], how
    full = pleft.join(pright, on="k", how="full").collect()
    assert sorted(full, key=repr) == sorted(
        [(1, 1, None), (2, 2, 7), (3, None, 8), (None, 3, None),
         (None, None, 9)], key=repr)
    assert sorted(left.join(right, on="name").collect()) == sorted(
        [("red", 1, 10), ("blue", 4, 20), ("red", 5, 10), ("", 6, 50)])


@pytest.mark.parametrize("build,reason", [
    (lambda l, r: l.join(r), "nested-loop and cross joins"),
    (lambda l, r: l.join(r, (PF.col("name") == PF.col("name")) &
                         (PF.col("age") < PF.col("bonus"))),
     "residual join condition"),
], ids=["cross", "residual-condition"])
def test_unported_join_is_refused(build, reason):
    left, right = _frames(_port_session({}))
    with pytest.raises(UnsupportedPlanError, match=reason):
        build(left, right).collect()


def test_q3_runs_without_jax():
    """Q3 in all three modes in a process that never imports jax or the
    JAX package."""
    code = textwrap.dedent(f"""
        import sys
        from spark_rapids_tpu_torch import functions as F
        from spark_rapids_tpu_torch.benchmarks import datagen as D
        from spark_rapids_tpu_torch.config import RapidsConf
        from spark_rapids_tpu_torch.dataframe import DataFrame
        from spark_rapids_tpu_torch.interop import host_batches
        from spark_rapids_tpu_torch.plan.logical import InMemoryScan
        from spark_rapids_tpu_torch.session import GpuSparkSession
        rows = []
        for extra in {list(MODES.values())!r}:
            s = GpuSparkSession(RapidsConf(dict({SETTINGS!r}, **extra)),
                                device="cpu")
            t = {{}}
            for name, gen in {TABLES!r}.items():
                parts = host_batches(getattr(D, gen)({SF}), {BATCH_ROWS})
                t[name] = DataFrame(InMemoryScan(parts, parts[0].schema, 1),
                                    s).cache()
    """) + textwrap.indent(textwrap.dedent(_source(q3)), "    ") + \
        textwrap.dedent("""
            rows.append(q3(t, F).collect())
        assert rows[0] == rows[1] == rows[2] and len(rows[0]) == 10
        print("jax" in sys.modules,
              any(m.split(".")[0] == "spark_rapids_tpu" for m in sys.modules))
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]


def _source(fn) -> str:
    import inspect
    return inspect.getsource(fn)
