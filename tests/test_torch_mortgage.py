"""PyTorch port, the mortgage ETL lane as a whole: the four entry points of
``benchmarks/mortgage_like.py`` (the port's copy) and its CSV entry,
against the JAX package on the CPU.

Both packages register ``perf_raw`` and ``acq_raw`` from their own
generators at the JAX suite's ``SF = 0.05`` (6,000 performance rows, 250
loans) in 3 partitions.  The port runs its device path on CPU tensors with
the device settings (``variableFloatAgg`` on, ``hasNans`` off, so every
aggregate but the string ``coalesce``'s project plans on the device) and
as its host engine (``spark.rapids.sql.enabled=false``); both must give
the JAX host engine's rows (``spark.rapids.sql.enabled=false``): in order,
keys, counts, hashes and maxima exact; sums, averages and percentiles
within 1e-9 relative, because the device sums in another order than the
host engine's row-order ``np.sum`` (the sort path's segment sums, the
slot aggregate's limb sums).  The physical plans must have the JAX
planner's shape, exec by exec, at the device settings and at the JAX
suite's defaults, and the test mode must find the same host execs in
both (planning only: no pipeline runs through the JAX device path).
"""

import math

import numpy as np
import pytest

from spark_rapids_tpu.benchmarks import mortgage_like as JM
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.plan.overrides import TpuOverrides
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch.benchmarks import mortgage_like as PM
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.plan.overrides import GpuOverrides
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from torch_port_util import host_execs, plan_shape

SF = 0.05
PARTITIONS = 3
REL = 1e-9
DEVICE = {"spark.rapids.sql.variableFloatAgg.enabled": True,
          "spark.rapids.sql.hasNans": False,
          "spark.sql.shuffle.partitions": 4}
#: the JAX suite's session (tests/compare.py tpu_session)
DEFAULTS = {"spark.sql.shuffle.partitions": 4}
HOST = {"spark.rapids.sql.enabled": False, "spark.sql.shuffle.partitions": 4}
ENTRIES = ["run_mortgage", "simple_aggregates", "aggregates_with_join",
           "aggregates_with_percentiles"]


def _same_value(got, want) -> bool:
    if isinstance(want, float) and isinstance(got, float):
        if math.isnan(want) or math.isnan(got):
            return math.isnan(want) and math.isnan(got)
        return got == want or abs(got - want) <= REL * abs(want)
    return got == want and type(got) is type(want)


def assert_rows(got_df, want_df, label):
    assert got_df.columns == want_df.columns
    got, want = got_df.collect(), want_df.collect()
    assert len(got) == len(want), f"{label}: {len(got)} rows, {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(got_df.columns, g, w):
            assert _same_value(a, b), \
                f"{label} row {i} column {name}: port {a!r}, JAX {b!r}"


@pytest.fixture(scope="module")
def sessions():
    """The JAX host engine and planner, the port's device path (on CPU
    tensors) and host engine, each over its own package's tables."""
    jax = {}
    for key, conf in (("host", HOST), ("device", DEVICE),
                      ("defaults", DEFAULTS)):
        jax[key] = TpuSparkSession(JaxConf(dict(conf)))
        JM.register_mortgage(jax[key], sf=SF, num_partitions=PARTITIONS)
    port = {}
    for key, conf in (("host", HOST), ("device", DEVICE),
                      ("defaults", DEFAULTS)):
        port[key] = GpuSparkSession(RapidsConf(dict(conf)), device="cpu")
        PM.register_mortgage(port[key], sf=SF, num_partitions=PARTITIONS)
    return jax, port


def test_generators_give_the_jax_arrays():
    for jfn, pfn in ((JM.gen_performance, PM.gen_performance),
                     (JM.gen_acquisition, PM.gen_acquisition)):
        want, got = jfn(SF), pfn(SF)
        assert list(got) == list(want)
        for name in want:
            assert got[name][0].name == want[name][0].name
            np.testing.assert_array_equal(np.asarray(got[name][1]),
                                          np.asarray(want[name][1]),
                                          err_msg=name)


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_matches_jax_host_engine(sessions, entry, engine):
    jax, port = sessions
    assert_rows(getattr(PM, entry)(port[engine]),
                getattr(JM, entry)(jax["host"]), f"{entry} ({engine})")


@pytest.mark.parametrize("settings", ["device", "defaults"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_plan_matches_jax_planner(sessions, entry, settings):
    """Exec by exec, placement included; under the test mode both plans
    hold the same host execs (the string coalesce's project in
    run_mortgage; at the defaults the float sums' aggregates too)."""
    jax, port = sessions
    conf = DEVICE if settings == "device" else DEFAULTS
    jconf = JaxConf(dict(conf, **{"spark.rapids.sql.fusion.enabled":
                                  False}))
    want_plan = TpuOverrides(jconf).apply(
        getattr(JM, entry)(jax[settings]).plan)
    got_plan = GpuOverrides(RapidsConf(dict(conf))).apply(
        getattr(PM, entry)(port[settings]).plan)
    assert plan_shape(got_plan) == plan_shape(want_plan)
    assert host_execs(got_plan) == host_execs(want_plan)
    if settings == "device":
        assert host_execs(got_plan) == (
            ["CpuProjectExec"] if entry == "run_mortgage" else [])


@pytest.fixture(scope="module")
def csv_dirs(tmp_path_factory):
    """The generators' tables as CSV files (pyarrow), read back by both
    packages (the reference's Run.csv entry)."""
    import pyarrow as pa
    import pyarrow.csv as pacsv
    root = tmp_path_factory.mktemp("mortgage_csv")
    dirs = {}
    for name, data in (("perf_raw", PM.gen_performance(SF)),
                       ("acq_raw", PM.gen_acquisition(SF))):
        d = root / name
        d.mkdir()
        table = pa.table({k: pa.array(np.asarray(v)) for k, (_, v) in
                          data.items()})
        pacsv.write_csv(table, str(d / "part-0.csv"))
        dirs[name] = str(d)
    return dirs


def _csv_entry(session, dirs):
    for name, path in dirs.items():
        session.register_view(name, session.read.csv(path))
    return session


@pytest.mark.parametrize("engine", ["device", "host"])
def test_csv_entry_matches_jax_host_engine(csv_dirs, engine):
    """run_mortgage over CSV files: the period column infers as DATE in
    both packages (``to_date`` of a DATE is the identity)."""
    jax = _csv_entry(TpuSparkSession(JaxConf(dict(HOST))), csv_dirs)
    port = _csv_entry(GpuSparkSession(RapidsConf(dict(
        DEVICE if engine == "device" else HOST)), device="cpu"), csv_dirs)
    jdf = jax.table("perf_raw")
    pdf = port.table("perf_raw")
    assert [(f.name, f.dtype.name) for f in pdf.schema.fields] == \
        [(f.name, f.dtype.name) for f in jdf.schema.fields]
    assert pdf.schema.field("monthly_reporting_period").dtype.name == "date"
    assert_rows(PM.run_mortgage(port), JM.run_mortgage(jax),
                f"run_mortgage over csv ({engine})")
