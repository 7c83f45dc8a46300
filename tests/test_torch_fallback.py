"""PyTorch port, the planner's per-operator fallback, against the JAX
package on the CPU.

* placement parity: for all 22 TPC-H texts at the default settings, and
  for six texts under a matrix of gates (each ``spark.rapids.sql.exec.
  <Name>``, one ``spark.rapids.sql.expression.<Name>``, ``hasNans`` off,
  ``variableFloatAgg`` on, ``stringHashGroupJoin.enabled`` off,
  ``spark.rapids.sql.enabled`` off), plus a string cast and a string
  ``Min``, every logical node lands on the same side as in the JAX
  package (planning only: the tags of both planners, node by node);
* the physical plans of the 22 texts at the default settings have the
  JAX package's shape, exec by exec, transitions and host exchanges
  included;
* mixed plans' rows: Q1, Q6, Q10 and Q18 at the default settings, where
  float sums and a DOUBLE group key put aggregates on the host between
  device operators, equal the JAX package's at the same settings exactly
  (generator sf 0.1): the host aggregate sees the same rows in the same
  order on both sides;
* the transitions: no device exec reads a host child and no host exec a
  device child; a string column crosses to the host as bytes and
  offsets, and an empty device result crosses as no batch;
* the test mode (``spark.rapids.sql.test.enabled``), the explain output,
  ``session.range`` and ``union`` on the device, a cached relation with
  ``spark.rapids.sql.enabled`` off, and a partitioned shuffle, no longer
  refused.
"""

import logging

import numpy as np
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.benchmarks import datagen as JD
from spark_rapids_tpu.benchmarks import tpch_like as JQ
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.plan.overrides import PlanMeta as JaxPlanMeta
from spark_rapids_tpu.plan.overrides import TpuOverrides
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch import functions as PF
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.benchmarks import datagen as PD
from spark_rapids_tpu_torch.benchmarks import tpch_like as PQ
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.kernels import cuda_tier
from spark_rapids_tpu_torch.plan.overrides import (
    GpuOverrides, PlanMeta,
)
from spark_rapids_tpu_torch.plan.physical import (
    DeviceToHostExec, ExecContext, HostToDeviceExec,
)
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from torch_port_util import plan_shape

TEXTS = sorted(PQ.QUERIES, key=lambda q: int(q[1:]))
PLAN_SF = 0.01      # planning only: the tables just have to exist
ROWS_SF = 0.1       # the mixed plans' rows
MIXED = ["q1", "q6", "q10", "q18"]
GATED_TEXTS = ["q1", "q3", "q9", "q13", "q16", "q18"]
GATES = {
    **{f"exec-{n}": {f"spark.rapids.sql.exec.{n}": False}
       for n in ("Project", "Filter", "Aggregate", "Sort", "Join",
                 "Limit")},
    "expression-Multiply": {"spark.rapids.sql.expression.Multiply": False},
    "no-nans": {"spark.rapids.sql.hasNans": False},
    "variable-float-agg": {"spark.rapids.sql.variableFloatAgg.enabled":
                           True},
    "no-string-hash": {"spark.rapids.sql.stringHashGroupJoin.enabled":
                       False},
    "sql-disabled": {"spark.rapids.sql.enabled": False},
}
FUSION_OFF = {"spark.rapids.sql.fusion.enabled": False}


@pytest.fixture(scope="module")
def plan_sessions():
    """(JAX, port) sessions over the TPC-H views, for planning."""
    jsess = TpuSparkSession(JaxConf({}))
    JD.register_tpch(jsess, sf=PLAN_SF, num_partitions=2)
    psess = GpuSparkSession(RapidsConf({}), device="cpu")
    PD.register_tpch(psess, sf=PLAN_SF, num_partitions=2)
    return jsess, psess


def _jax_placement(plan, settings):
    conf = JaxConf(dict(settings))
    meta = JaxPlanMeta(plan, conf)
    TpuOverrides(conf).tag(meta)
    return _walk(meta, lambda m: m.can_run_on_tpu)


def _port_placement(plan, settings):
    conf = RapidsConf(dict(settings))
    meta = PlanMeta(plan, conf)
    GpuOverrides(conf).tag(meta)
    return _walk(meta, lambda m: m.can_run_on_gpu)


def _walk(meta, on_device, depth=0):
    out = [(depth, meta.node.name, on_device(meta))]
    for c in meta.children:
        out.extend(_walk(c, on_device, depth + 1))
    return out


def _assert_same_placement(jplan, pplan, settings):
    want = _jax_placement(jplan, settings)
    got = _port_placement(pplan, settings)
    assert got == want
    return got


@pytest.mark.parametrize("query", TEXTS)
def test_default_placement_matches_jax(plan_sessions, query):
    jsess, psess = plan_sessions
    got = _assert_same_placement(jsess.sql(JQ.QUERIES[query]).plan,
                                 psess.sql(PQ.QUERIES[query]).plan, {})
    # every text holds device operators; a scan is the host's by design
    assert any(on for _, _, on in got)
    assert all(not on for _, name, on in got if name == "InMemoryScan")


@pytest.mark.parametrize("gate", list(GATES))
@pytest.mark.parametrize("query", GATED_TEXTS)
def test_gated_placement_matches_jax(plan_sessions, query, gate):
    jsess, psess = plan_sessions
    got = _assert_same_placement(jsess.sql(JQ.QUERIES[query]).plan,
                                 psess.sql(PQ.QUERIES[query]).plan,
                                 GATES[gate])
    name = gate.split("-", 1)[1] if gate.startswith("exec-") else None
    if name and any(n == name for _, n, _ in got):
        assert all(not on for _, n, on in got if n == name)
    if gate == "sql-disabled":
        assert not any(on for _, _, on in got)


def _small(sess, types):
    return sess.create_dataframe({
        "k": (types.INT, [1, 2, None, 2]),
        "s": (types.STRING, ["b", None, "a", "c"]),
        "x": (types.DOUBLE, [1.5, -2.0, None, 4.0])})


@pytest.mark.parametrize("case", ["string-cast", "string-min"])
def test_frame_placement_matches_jax(case):
    """A string cast in a projection and a string ``Min`` put their node
    on the host in both packages; the rows are the JAX package's."""
    def build(df, F, types):
        if case == "string-cast":
            return df.select(df["k"].cast(types.STRING).alias("ks"), "x")
        return df.group_by("k").agg(F.min("s").alias("m"))

    jsess = TpuSparkSession(JaxConf({}))
    psess = GpuSparkSession(RapidsConf({}), device="cpu")
    jdf, pdf = build(_small(jsess, JT), JF, JT), build(_small(psess, T),
                                                       PF, T)
    got = _assert_same_placement(jdf.plan, pdf.plan, {})
    node = "Project" if case == "string-cast" else "Aggregate"
    assert [on for _, n, on in got if n == node] == [False]
    assert repr(pdf.collect()) == repr(jdf.collect())


@pytest.mark.parametrize("query", TEXTS)
def test_default_plan_shape_matches_jax(plan_sessions, query):
    """The physical plan exec by exec, host execs, transitions and host
    exchanges included, against the JAX package's with its map fusion
    off; every edge between the sides holds a transition."""
    jsess, psess = plan_sessions
    jplan = jsess.sql(JQ.QUERIES[query]).plan
    phys = GpuOverrides(RapidsConf({})).apply(
        psess.sql(PQ.QUERIES[query]).plan)
    want = plan_shape(TpuOverrides(JaxConf(dict(FUSION_OFF))).apply(jplan))
    assert plan_shape(phys) == want
    _assert_transitions(phys)


def _assert_transitions(op):
    for c in op.children:
        if op.is_gpu and not c.is_gpu:
            assert isinstance(op, HostToDeviceExec), op.describe()
        if not op.is_gpu and c.is_gpu:
            assert isinstance(op, DeviceToHostExec), op.describe()
        _assert_transitions(c)


@pytest.mark.parametrize("gate", ["sql-disabled", "exec-Sort", "exec-Join",
                                  "no-string-hash"])
def test_transitions_under_gates(plan_sessions, gate):
    _, psess = plan_sessions
    for query in TEXTS:
        phys = GpuOverrides(RapidsConf(dict(GATES[gate]))).apply(
            psess.sql(PQ.QUERIES[query]).plan)
        _assert_transitions(phys)
        if gate == "sql-disabled":
            assert "Gpu" not in phys.tree_string()


# -- mixed plans' rows --------------------------------------------------------


@pytest.fixture(scope="module")
def mixed_jax_rows():
    """The JAX package's rows of the mixed plans at the default settings,
    each text once."""
    sess = TpuSparkSession(JaxConf({}))
    JD.register_tpch(sess, sf=ROWS_SF, num_partitions=3)
    return {q: sess.sql(JQ.QUERIES[q]).collect() for q in MIXED}


@pytest.fixture(scope="module")
def mixed_port_session():
    sess = GpuSparkSession(RapidsConf({}), device="cpu")
    PD.register_tpch(sess, sf=ROWS_SF, num_partitions=3)
    return sess


#: the logical nodes each mixed plan puts on the host, and why
MIXED_HOST = {"q1": "aggregate Sum", "q6": "aggregate Sum",
              "q10": "grouping by floating point", "q18": "aggregate Sum"}


@pytest.mark.parametrize("query", MIXED)
def test_mixed_plan_rows_match_jax(mixed_jax_rows, mixed_port_session,
                                   query):
    """Rows equal exactly, in order (float bits included): both packages
    run the aggregate on the host over the same rows in the same order,
    and the device operators around it are the ones PRs 1-8 hold equal."""
    sess = mixed_port_session
    cuda_tier.reset_launch_counts()
    got = sess.sql(PQ.QUERIES[query]).collect()
    assert repr(got) == repr(mixed_jax_rows[query])
    assert got
    assert MIXED_HOST[query] in sess.last_explain
    tree = sess.last_physical_plan.tree_string()
    assert "CpuAggregate" in tree
    if query != "q6":  # Q6's keyless aggregate is its root
        assert "DeviceToHost" in tree and "HostToDevice" in tree
    # CPU tensors take the plain versions, never a kernel
    assert all(cuda_tier.launch_count(n) == 0 for n in cuda_tier.SOURCES)


def test_string_keys_cross_as_bytes(mixed_port_session):
    """Q1's device filter hands the host aggregate its string keys as
    bytes and offsets, never a Python string a row; the transition
    counts the bytes it moved."""
    sess = mixed_port_session
    phys = GpuOverrides(sess.conf).apply(sess.sql(PQ.QUERIES["q1"]).plan)
    d2h = _find(phys, DeviceToHostExec)
    ctx = ExecContext(sess.conf, sess.device)
    batches = [hb for p in d2h.partitions(ctx) for hb in p]
    assert batches
    for hb in batches:
        for f, c in zip(hb.schema.fields, hb.columns):
            assert (c.offsets is not None) == f.dtype.is_string
    moved = ctx.op_metric_values()[d2h.op_id]["d2hBytes"]
    assert moved >= sum(hb.num_rows for hb in batches) > 0


def _find(op, cls):
    if isinstance(op, cls):
        return op
    for c in op.children:
        hit = _find(c, cls)
        if hit is not None:
            return hit
    return None


def test_empty_device_result_crosses_as_no_batch():
    """A device filter that keeps no row hands the host aggregate no
    batch; the keyless aggregate still gives its one row of SQL
    defaults, as the JAX package's does."""
    def q(sess, types, F):
        df = _small(sess, types)
        return df.filter(df["x"] > 1e9).agg(F.sum("x").alias("sx"),
                                            F.count("*").alias("n"),
                                            F.max("s").alias("ms"))

    psess = GpuSparkSession(RapidsConf({}), device="cpu")
    got = q(psess, T, PF).collect()
    assert got == q(TpuSparkSession(JaxConf({})), JT, JF).collect()
    assert got == [(None, 0, None)]
    assert "DeviceToHost" in psess.last_physical_plan.tree_string()


def test_expression_gate_moves_its_node(plan_sessions):
    """``spark.rapids.sql.expression.Multiply=false`` puts every node that
    evaluates a product on the host, naming the gate."""
    _, psess = plan_sessions
    sess = GpuSparkSession(RapidsConf(dict(GATES["expression-Multiply"])),
                           device="cpu")
    sess.plan_physical(psess.sql(PQ.QUERIES["q9"]).plan)
    assert "expression Multiply disabled by spark.rapids.sql.expression." \
        "Multiply" in sess.last_explain


# -- the test mode, explain, range, union, cache, the refusal left ------------


def test_test_mode_raises_naming_the_host_exec():
    settings = {"spark.rapids.sql.test.enabled": True}
    sess = GpuSparkSession(RapidsConf(settings), device="cpu")
    PD.register_tpch(sess, sf=PLAN_SF, num_partitions=1)
    with pytest.raises(AssertionError, match="CpuAggregateExec"):
        sess.sql(PQ.QUERIES["q1"]).collect()
    on = GpuSparkSession(RapidsConf(dict(settings, **{
        "spark.rapids.sql.variableFloatAgg.enabled": True})), device="cpu")
    PD.register_tpch(on, sf=PLAN_SF, num_partitions=1)
    assert on.sql(PQ.QUERIES["q1"]).collect()


def test_explain_output(plan_sessions, caplog, capsys):
    _, psess = plan_sessions
    df = psess.sql(PQ.QUERIES["q1"])
    text = df.explain()
    assert capsys.readouterr().out.strip() == text.strip()
    lines = text.split("\n\n")[0].splitlines()
    assert lines[0].startswith("*") and "will run on GPU" in lines[0]
    assert any(ln.strip().startswith("!Aggregate cannot run on GPU because")
               for ln in lines)
    assert "CpuAggregate" in text.split("\n\n", 1)[1]
    for mode, want in (("ALL", "*Sort will run on GPU"),
                       ("NOT_ON_GPU", "!Aggregate")):
        sess = GpuSparkSession(RapidsConf({"spark.rapids.sql.explain":
                                           mode}), device="cpu")
        caplog.clear()
        with caplog.at_level(logging.INFO,
                             logger="spark_rapids_tpu_torch.session"):
            sess.plan_physical(df.plan)
        logged = "\n".join(r.getMessage() for r in caplog.records)
        assert want in logged
        if mode == "NOT_ON_GPU":
            assert "will run on GPU" not in logged


@pytest.mark.parametrize("settings", [{}, {"spark.rapids.sql.enabled":
                                           False}],
                         ids=["device", "host"])
def test_range_and_union_match_jax(settings):
    def q(sess, F):
        a = sess.range(5, 50, 3, num_partitions=2)
        b = sess.range(4)
        u = a.union(b)
        return u.filter(u["id"] % 2 == 0).select((u["id"] * 10).alias("t"))

    psess = GpuSparkSession(RapidsConf(dict(settings)), device="cpu")
    got = q(psess, PF).collect()
    assert got == q(TpuSparkSession(JaxConf(dict(settings))), JF).collect()
    assert len(got) > 5
    tree = psess.last_physical_plan.tree_string()
    if settings:
        assert "CpuRange" in tree and "CpuUnion" in tree
    else:
        assert "GpuRange" in tree and "GpuUnionExec" in tree


def test_cached_relation_plans_uncached_on_the_host():
    """With ``spark.rapids.sql.enabled`` off a cached DataFrame plans as
    its uncached child on the host: no device cache is made."""
    sess = GpuSparkSession(RapidsConf({"spark.rapids.sql.enabled": False}),
                           device="cpu")
    df = _small(sess, T).cache()
    got = df.filter(df["k"] > 1).collect()
    tree = sess.last_physical_plan.tree_string()
    assert "Cached" not in tree and "Gpu" not in tree
    assert df.plan.holder.partitions is None
    assert got == [(2, None, -2.0), (2, "c", 4.0)]


@pytest.mark.parametrize("settings", [{}, {"spark.rapids.sql.enabled":
                                           False}],
                         ids=["device", "host"])
def test_partitioned_shuffle_is_refused(settings):
    """The refusal is gone: with ``spark.rapids.sql.tpu.exchange.
    collapseLocal`` off both sides plan and run a partitioned exchange
    (split into ``spark.sql.shuffle.partitions`` partitions), with the
    collapsed plan's groups."""
    def groups(extra):
        sess = GpuSparkSession(RapidsConf(dict(settings, **extra)),
                               device="cpu")
        df = _small(sess, T)
        rows = df.group_by("k").agg(PF.count("*").alias("n")).collect()
        return sorted(rows, key=repr), sess

    split, sess = groups({"spark.rapids.sql.tpu.exchange.collapseLocal":
                          False})
    assert split == groups({})[0] == [(1, 1), (2, 2), (None, 1)]
    exchanges = [ln for ln in sess.last_physical_plan.tree_string()
                 .splitlines() if "ShuffleExchange" in ln]
    assert exchanges and all("HashPartitioning, 8" in ln
                             for ln in exchanges)
    if not settings:  # the device split ran once, one sync
        assert sess.last_metrics["shuffleSyncs"] == 1


def test_float_keys_group_as_the_jax_host_does():
    """Under ``hasNans`` a DOUBLE key groups on the host: each NaN row its
    own group, -0.0 with 0.0 (the first one seen names the group), NULL
    one group, in first-seen order, as the JAX package's host
    aggregate."""
    def q(sess, types, F):
        df = sess.create_dataframe({
            "d": (types.DOUBLE, [0.0, float("nan"), -0.0, None,
                                 float("nan"), 1.0, None, 0.0]),
            "v": (types.LONG, list(range(8)))})
        return df.group_by("d").agg(F.sum("v").alias("sv"),
                                    F.count("*").alias("n"))

    psess = GpuSparkSession(RapidsConf({}), device="cpu")
    got = q(psess, T, PF).collect()
    want = q(TpuSparkSession(JaxConf({})), JT, JF).collect()
    assert repr(got) == repr(want)
    assert len(got) == 5 and np.isnan(got[1][0])
