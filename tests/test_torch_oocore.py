"""The port's out-of-core run (``benchmarks/oocore_run.py``) at a size
the CPU takes: lineitem at 60,000 rows from parquet, cached under a
64 KiB device budget and a 256 KiB host store, so the disk tier is
reached.  Q1 and Q18, and Q18 split into partitions whose shuffle pieces
spill, give the JAX host engine's rows over the same files."""

import numpy as np
import pytest

from spark_rapids_tpu.benchmarks.tpch_like import QUERIES as JAX_QUERIES
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch.benchmarks import oocore_run
from spark_rapids_tpu_torch.benchmarks.tpch_like import QUERIES

from torch_port_util import one_torch_thread  # noqa: F401

SF = 0.01                 # lineitem 60,000 rows
TABLES = ("lineitem", "orders", "customer")
TINY = {"spark.rapids.memory.host.spillStorageSize": 256 << 10,
        "spark.rapids.sql.reader.batchSizeRows": 8192}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return oocore_run.generate_dataset(
        SF, str(tmp_path_factory.mktemp("oocore")), tables=TABLES)


@pytest.fixture(scope="module")
def jax_rows(data_root):
    """The JAX host engine's rows over the same parquet files."""
    s = TpuSparkSession(JaxConf({"spark.rapids.sql.enabled": False}))
    for name in TABLES:
        s.read.parquet(f"{data_root}/{name}").create_or_replace_temp_view(
            name)
    return {q: s.sql(JAX_QUERIES[q]).collect() for q in ("q1", "q18")}


def assert_rows(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                np.testing.assert_allclose(a, b, rtol=1e-9)
            else:
                assert a == b


def test_oocore_run_spills_to_disk_with_the_right_answers(data_root,
                                                          jax_rows):
    """The run's answers agree on the card's path alone: no query
    engaged the fault ladder."""
    res = oocore_run.run(SF, 64 << 10, ["q1", "q18"], extra_conf=TINY,
                         device="cpu", root=data_root, tables=TABLES)
    for q, r in res.items():
        assert r["agree"], q
        assert not any(r["faults"].values()), (q, r["faults"])
        assert r["spilled_to_host"] > 0 and r["spilled_to_disk"] > 0, q
        assert r["unspilled"] > 0, q


@pytest.mark.parametrize("split", [False, True])
def test_rows_under_a_tiny_budget_match_jax(data_root, jax_rows, split):
    extra = dict(TINY)
    if split:
        extra.update({"spark.rapids.sql.tpu.exchange.collapseLocal": False,
                      "spark.sql.shuffle.partitions": 4})
    s = oocore_run.session(True, data_root, 64 << 10, extra, device="cpu",
                           tables=TABLES)
    for q in ("q1", "q18"):
        for _ in range(2):  # the fill, then the cache read back
            assert_rows(s.sql(QUERIES[q]).collect(), jax_rows[q])
            assert not any(k in s.last_metrics
                           for k in oocore_run.FAULT_COUNTERS), q
    m = s.runtime.catalog.metrics
    assert m["spilled_to_host"] > 0 and m["spilled_to_disk"] > 0
    assert m["unspilled"] > 0
    if split:
        assert s.last_metrics.get("shufflePieces", 0) > 0
    assert s.runtime.catalog.verify_accounting() == []
    for name in TABLES:
        s.table(name).unpersist()
    assert s.runtime.catalog.tier_bytes() == {"device": 0, "host": 0,
                                              "disk": 0}
