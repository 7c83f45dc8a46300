"""PyTorch port, the string path as a whole: TPC-H Q1 (string group keys,
string ORDER BY) through the port on the CPU against the JAX package, the
port's copy of the table generators, and the refusal of string
expressions the port does not have.  The LIKE query is in
``test_torch_strings.py`` beside the contains kernel's tests; string
expressions, gathers and sort words are in ``test_torch_string_exprs.py``.

lineitem comes from each package's own generator at a small scale and
arrives as two cached batches, so the merge aggregate concatenates the
string partials (bytes and lengths through the gatherScatter pack).  Both
packages must return the same rows in the same order, every value bit for
bit: on the sort path both sum each group's floats with one sequential
scatter-add in the same sorted row order.  The JAX side runs Q1 once
(module fixture): its compile is most of the file's time.
"""

import numpy as np
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.benchmarks import datagen as JD
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.dataframe import DataFrame as JaxDataFrame
from spark_rapids_tpu.plan.logical import InMemoryScan as JaxScan
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch import functions as PF
from spark_rapids_tpu_torch.benchmarks import datagen as PD
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.dataframe import Column, DataFrame
from spark_rapids_tpu_torch.interop import host_batches
from spark_rapids_tpu_torch.kernels import cuda_tier
from spark_rapids_tpu_torch.plan.logical import InMemoryScan
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

SETTINGS = {"spark.rapids.sql.variableFloatAgg.enabled": True,
            "spark.sql.shuffle.partitions": 1}
BATCH_ROWS = 2048
LINEITEM_SF = 0.068  # 4,080 rows: 2 batches


def q1(df, F):
    """TPC-H Q1 as the repo defines it (benchmarks/tpch_like.py Q1)."""
    return (df
            .filter(df["l_shipdate"] <= 10471)
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.sum("l_quantity").alias("sum_qty"),
                 F.sum("l_extendedprice").alias("sum_base_price"),
                 F.avg("l_quantity").alias("avg_qty"),
                 F.avg("l_extendedprice").alias("avg_price"),
                 F.avg("l_discount").alias("avg_disc"),
                 F.count("*").alias("count_order"))
            .order_by("l_returnflag", "l_linestatus"))


def _jax_rows(data, query):
    n = len(next(iter(data.values()))[1])
    parts = [JaxHostBatch.from_pydict({
        k: (t, np.asarray(v)[s:s + BATCH_ROWS]) for k, (t, v) in data.items()})
        for s in range(0, n, BATCH_ROWS)]
    sess = TpuSparkSession(JaxConf(SETTINGS))
    df = JaxDataFrame(JaxScan(parts, parts[0].schema, 1), sess).cache()
    return query(df, JF).collect()


def _port_df(data):
    parts = host_batches(data, BATCH_ROWS)
    sess = GpuSparkSession(RapidsConf(SETTINGS), device="cpu")
    return DataFrame(InMemoryScan(parts, parts[0].schema, 1), sess).cache()


@pytest.fixture(scope="module")
def q1_jax():
    """The JAX package's Q1 rows, once for this file."""
    return _jax_rows(JD.gen_lineitem(LINEITEM_SF), q1)


def test_q1_matches_jax(q1_jax):
    df = _port_df(PD.gen_lineitem(LINEITEM_SF))
    assert len(df.plan.children[0].batches) == 2
    for _ in range(2):  # the second collect reads the cached batches
        cuda_tier.reset_launch_counts()
        assert q1(df, PF).collect() == q1_jax
        # CPU tensors take the plain versions, never a kernel
        assert all(cuda_tier.launch_count(n) == 0 for n in cuda_tier.SOURCES)
    assert [r[:2] for r in q1_jax] == [(f, s) for f in PD.FLAGS
                                       for s in PD.STATUSES]


@pytest.mark.parametrize("sf", [0.05, 1.5])
def test_datagen_matches_jax(sf):
    for gen in ("gen_lineitem", "gen_part"):
        want, got = getattr(JD, gen)(sf), getattr(PD, gen)(sf)
        assert list(got) == list(want)
        for name in want:
            assert got[name][0].name == want[name][0].name, name
            g, w = np.asarray(got[name][1]), np.asarray(want[name][1])
            # str arrays: the same strings (the width numpy picks
            # follows the longest string a list happens to hold)
            assert g.dtype.kind == w.dtype.kind, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def _needle_columns(df, B, S, C):
    """``contains(p_type, p_type)`` (a needle column: every row holds
    itself) in one package's modules."""
    ref = B.ColumnRef("p_type", df.schema["p_type"].dtype)
    return C(S.StringContains(ref, ref))


@pytest.fixture(scope="module")
def part_batches():
    """(JAX, port) host batches of one part table, for every case."""
    jdata = JD.gen_part(0.01)
    n = len(next(iter(jdata.values()))[1])
    jparts = [JaxHostBatch.from_pydict({
        k: (t, np.asarray(v)[s:s + BATCH_ROWS])
        for k, (t, v) in jdata.items()}) for s in range(0, n, BATCH_ROWS)]
    return jparts, host_batches(PD.gen_part(0.01), BATCH_ROWS)


@pytest.mark.parametrize("build,reason", [
    (lambda df, F, *_: df.filter(df["p_name"].like("%gr_en%")),
     "pattern '%gr_en%' is not ported"),
    (lambda df, F, *_: df.filter(df["p_brand"] < "Brand#3"),
     "string comparisons are not ported"),
    (lambda df, F, *mods: df.filter(_needle_columns(df, *mods)),
     "pattern must be a literal"),
    (lambda df, F, *_: df.group_by("p_brand").agg(F.min("p_name").alias("m")),
     "Min over strings is not ported"),
    (lambda df, F, *_: df.filter(df["p_size"].like("1%")),
     "Like: the input is not a string"),
], ids=["like-underscore", "string-order", "column-needle", "string-min",
        "like-on-int"])
def test_unported_string_expression_is_refused(part_batches, build, reason):
    """What the device path cannot run falls back: the node runs on the
    host, its explain line names the reason, and the rows equal the JAX
    package's at the same settings (exactly: both place the node on the
    host, which filters and groups the same rows in the same order).  A
    LIKE over an INT column the JAX package would place on its device,
    which has no string bytes for it, so that case holds the port to the
    JAX package's host engine (``spark.rapids.sql.enabled`` false)."""
    from spark_rapids_tpu.dataframe import Column as JColumn
    from spark_rapids_tpu.exprs import base as JB
    from spark_rapids_tpu.exprs import strings as JS
    from spark_rapids_tpu_torch.exprs import base as PB
    from spark_rapids_tpu_torch.exprs import strings as PS
    jparts, parts = part_batches
    sess = GpuSparkSession(RapidsConf(SETTINGS), device="cpu")
    df = DataFrame(InMemoryScan(parts, parts[0].schema, 1), sess)
    got = build(df, PF, PB, PS, Column).collect()
    node = "Aggregate" if "Min" in reason else "Filter"
    assert f"!{node} cannot run on GPU because" in sess.last_explain
    assert reason in sess.last_explain
    assert "Cpu" in sess.last_physical_plan.tree_string()
    jconf = dict(SETTINGS)
    if "input is not a string" in reason:
        jconf["spark.rapids.sql.enabled"] = False
    jdf = JaxDataFrame(JaxScan(jparts, jparts[0].schema, 1),
                       TpuSparkSession(JaxConf(jconf)))
    want = build(jdf, JF, JB, JS, JColumn).collect()
    assert got == want
    assert got
