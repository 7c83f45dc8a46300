"""PyTorch port, the slice as a whole: bench.py's headline query through the
port (on the CPU) against the JAX package.

The table arrives as several cached batches (the shape a scan hands over,
where the merge aggregate concatenates one partial per batch through the
gatherScatter pack) and as the one cached batch bench.py itself builds.
Both packages must return the same rows in the same order.  Every value,
float sums and averages included, must match bit for bit: at these sizes
(one 16384-row limb chunk per batch) both packages sum the same exact limb
rows, and both sum floats with one sequential scatter-add per group on the
sort path.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.dataframe import DataFrame as JaxDataFrame
from spark_rapids_tpu.plan.logical import InMemoryScan as JaxScan
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch import functions as PF
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.dataframe import DataFrame
from spark_rapids_tpu_torch.kernels import cuda_tier
from spark_rapids_tpu_torch.plan.logical import InMemoryScan
from spark_rapids_tpu_torch.plan.overrides import UnsupportedPlanError
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    headline_data, headline_query, one_torch_thread, port_host_batch,
)
SETTINGS = {"spark.rapids.sql.variableFloatAgg.enabled": True,
            "spark.sql.shuffle.partitions": 1}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tables(n_batches, rows):
    rng = np.random.RandomState(42)
    jparts = [JaxHostBatch.from_pydict(headline_data(rng, rows))
              for _ in range(n_batches)]
    return jparts, [port_host_batch(b) for b in jparts]


@pytest.mark.parametrize("n_batches,rows,extra", [
    (4, 4096, {}),
    (1, 16384, {}),
    # a slot table too small for the keys: every batch raises the flag
    # and both packages re-run the update on the exact sort path
    (2, 2048, {"spark.rapids.sql.agg.mxuHash.tableSlots": 64}),
], ids=["four-batches", "one-batch", "sort-path-rerun"])
def test_headline_matches_jax(n_batches, rows, extra):
    settings = dict(SETTINGS, **extra)
    jparts, pparts = _tables(n_batches, rows)
    jsess = TpuSparkSession(JaxConf(dict(
        settings, **{"spark.rapids.sql.tpu.pallas.interpret": True})))
    want = headline_query(JaxDataFrame(
        JaxScan(jparts, jparts[0].schema, 1), jsess).cache(), JF).collect()
    psess = GpuSparkSession(RapidsConf(settings), device="cpu")
    df = DataFrame(InMemoryScan(pparts, pparts[0].schema, 1), psess).cache()
    for _ in range(2):  # the second collect reads the cached batches
        cuda_tier.reset_launch_counts()
        got = headline_query(df, PF).collect()
        assert got == want
        # CPU tensors take the plain pack, never a kernel launch
        assert cuda_tier.launch_count("gatherScatter") == 0
    assert len(want) > 100
    update = psess.last_physical_plan
    while getattr(update, "mode", None) != "update":
        update = update.children[0]
    assert update._hash_disabled == bool(extra)  # the sort path re-ran


def test_float_sum_needs_variable_float_agg():
    psess = GpuSparkSession(RapidsConf(), device="cpu")
    _, pparts = _tables(1, 64)
    df = DataFrame(InMemoryScan(pparts, pparts[0].schema, 1), psess)
    with pytest.raises(UnsupportedPlanError, match="variableFloatAgg"):
        headline_query(df, PF).collect()


def test_slice_runs_without_jax():
    """The port runs the slice and the string path (its generator, a LIKE
    filter, string group keys) in a process that never imports jax or the
    JAX package."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from spark_rapids_tpu_torch import functions as F, types as T
        from spark_rapids_tpu_torch.batch import HostBatch
        from spark_rapids_tpu_torch.config import RapidsConf
        from spark_rapids_tpu_torch.dataframe import DataFrame
        from spark_rapids_tpu_torch.plan.logical import InMemoryScan
        from spark_rapids_tpu_torch.session import GpuSparkSession
        rng = np.random.RandomState(1)
        parts = [HostBatch.from_pydict({
            "k": (T.INT, rng.randint(0, 5, 100)),
            "x": (T.DOUBLE, rng.rand(100))}) for _ in range(3)]
        s = GpuSparkSession(RapidsConf(
            {"spark.rapids.sql.variableFloatAgg.enabled": True}),
            device="cpu")
        df = DataFrame(InMemoryScan(parts, parts[0].schema, 1), s).cache()
        rows = (df.filter(df["x"] > 0.5).group_by("k")
                .agg(F.sum("x").alias("s"), F.count("x").alias("c"))
                .order_by("k").collect())
        assert [r[0] for r in rows] == sorted({r[0] for r in rows})
        from spark_rapids_tpu_torch.benchmarks.datagen import gen_part
        from spark_rapids_tpu_torch.interop import host_batches
        parts = host_batches(gen_part(0.5), 256)
        df = DataFrame(InMemoryScan(parts, parts[0].schema, 1), s).cache()
        brands = (df.filter(df["p_name"].like("%green%")).group_by("p_brand")
                  .agg(F.count("*").alias("c")).order_by("p_brand")
                  .collect())
        assert [r[0] for r in brands] == sorted({r[0] for r in brands})
        print(len(rows), len(brands), "jax" in sys.modules,
              any(m.split(".")[0] == "spark_rapids_tpu" for m in sys.modules))
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["5", "25", "False", "False"]
