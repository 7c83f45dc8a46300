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
from spark_rapids_tpu_torch.exprs.base import ColumnRef
from spark_rapids_tpu_torch.exprs.strings import StringContains
from spark_rapids_tpu_torch.interop import host_batches
from spark_rapids_tpu_torch.kernels import cuda_tier
from spark_rapids_tpu_torch.plan.logical import InMemoryScan
from spark_rapids_tpu_torch.plan.overrides import UnsupportedPlanError
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


@pytest.mark.parametrize("build,reason", [
    (lambda df: df.filter(df["p_name"].like("%gr_en%")),
     "pattern '%gr_en%' is not ported"),
    (lambda df: df.filter(df["p_brand"] < "Brand#3"),
     "string comparisons are not ported"),
    (lambda df: df.filter(Column(StringContains(
        ColumnRef("p_name", df.schema["p_name"].dtype),
        ColumnRef("p_type", df.schema["p_type"].dtype)))),
     "pattern must be a literal"),
    (lambda df: df.group_by("p_brand").agg(PF.min("p_name").alias("m")),
     "Min over strings is not ported"),
    (lambda df: df.filter(df["p_size"].like("1%")),
     "Like: the input is not a string"),
], ids=["like-underscore", "string-order", "column-needle", "string-min",
        "like-on-int"])
def test_unported_string_expression_is_refused(build, reason):
    parts = host_batches(PD.gen_part(0.01), BATCH_ROWS)
    sess = GpuSparkSession(RapidsConf(SETTINGS), device="cpu")
    df = DataFrame(InMemoryScan(parts, parts[0].schema, 1), sess)
    with pytest.raises(UnsupportedPlanError, match=reason):
        build(df).collect()
