"""The port's fault ladder against the JAX package's
(``tests/test_faults.py`` sets the cases): the error classes, the
``faults.spec`` grammar and the retry policy's delays the same; every
wired fault site recovered with the JAX host engine's rows and the
counters the spec implies; the host completion, the raw error with the
fallback off, interrupts never retried, the partition watchdog, and the
runtime's recovery."""

import time

import numpy as np
import pytest
import torch

from spark_rapids_tpu.benchmarks import datagen as jax_datagen
from spark_rapids_tpu.benchmarks.tpch_like import QUERIES as JAX_QUERIES
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.fault import errors as JE
from spark_rapids_tpu.fault import inject as JI
from spark_rapids_tpu.fault.retry import RetryPolicy as JaxRetryPolicy
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch.benchmarks import datagen
from spark_rapids_tpu_torch.benchmarks.tpch_like import QUERIES
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.dataframe import DataFrame
from spark_rapids_tpu_torch.fault import inject
from spark_rapids_tpu_torch.fault.errors import (
    DeviceLostError, ErrorClass, KernelLaunchError, PartitionTimeout,
    classify_error, mark_non_retryable,
)
from spark_rapids_tpu_torch.fault.inject import InjectedFault, parse_spec
from spark_rapids_tpu_torch.fault.retry import RetryPolicy
from spark_rapids_tpu_torch.fault.watchdog import partition_deadline
from spark_rapids_tpu_torch.interop import host_batches
from spark_rapids_tpu_torch.mem.catalog import SpillableBatch
from spark_rapids_tpu_torch.ops.gpu_exec import GpuFilterExec
from spark_rapids_tpu_torch.plan.logical import InMemoryScan
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import one_torch_thread  # noqa: F401

SF = 0.5             # lineitem 30,000 rows
BATCH_ROWS = 4096    # eight batches
COUNTERS = ("retryCount", "deviceLostCount", "partitionFallbackCount",
            "faultsInjected")


@pytest.fixture(autouse=True)
def _clean_registries():
    yield
    inject.uninstall()
    JI.uninstall()


# -- the error classes, the grammar, the policy ------------------------------


class XlaRuntimeError(Exception):
    """Named as the JAX package's classifier reads XLA's errors."""


@pytest.mark.parametrize("port_err,jax_err,want", [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"),
     XlaRuntimeError("RESOURCE_EXHAUSTED: Out of memory"),
     ErrorClass.RETRYABLE_OOM),
    (KernelLaunchError("gatherScatter", 2), None, ErrorClass.RETRYABLE_OOM),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     XlaRuntimeError("INTERNAL: TPU worker crashed"),
     ErrorClass.DEVICE_LOST),
    (RuntimeError("CUDA error: device-side assert triggered"), None,
     ErrorClass.DEVICE_LOST),
    (RuntimeError("CUDA error: unspecified launch failure"), None,
     ErrorClass.DEVICE_LOST),
    (RuntimeError("CUDA error: misaligned address"), None,
     ErrorClass.DEVICE_LOST),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"), None,
     ErrorClass.DEVICE_LOST),
    (RuntimeError("CUDA error: the launch timed out and was terminated"),
     None, ErrorClass.DEVICE_LOST),
    (KernelLaunchError("stringHash", 700), None, ErrorClass.NON_RETRYABLE),
    (KernelLaunchError("gatherScatter", 710), None,
     ErrorClass.NON_RETRYABLE),
    (KernelLaunchError("joinProbe", 1), None, ErrorClass.NON_RETRYABLE),
    (ValueError("bad input"), ValueError("bad input"),
     ErrorClass.NON_RETRYABLE),
    (RuntimeError("shape mismatch"), RuntimeError("shape mismatch"),
     ErrorClass.NON_RETRYABLE),
    (KeyboardInterrupt(), KeyboardInterrupt(), ErrorClass.NON_RETRYABLE),
    (SystemExit(1), SystemExit(1), ErrorClass.NON_RETRYABLE),
    (PartitionTimeout("late"), JE.PartitionTimeout("late"),
     ErrorClass.DEVICE_LOST),
    (DeviceLostError("gone"), JE.DeviceLostError("gone"),
     ErrorClass.DEVICE_LOST),
    (mark_non_retryable(torch.OutOfMemoryError("pinned")),
     JE.mark_non_retryable(XlaRuntimeError("RESOURCE_EXHAUSTED: x")),
     ErrorClass.NON_RETRYABLE),
    (InjectedFault("x", ErrorClass.DEVICE_LOST),
     JI.InjectedFault("x", JE.ErrorClass.DEVICE_LOST),
     ErrorClass.DEVICE_LOST),
])
def test_classify_error_matches_jax(port_err, jax_err, want):
    assert classify_error(port_err) is want
    if jax_err is not None:
        assert JE.classify_error(jax_err).value == want.value


@pytest.mark.parametrize("spec", [
    "", "dispatch:oom@3", "dispatch:oom@3;d2h:device_lost@1;"
    "spill:slow=200ms@2;h2d:oom@4+", "mesh:device_lost@2+",
    "scan:slow=1.5s@1", "unspill:slow@1", " exchange : oom @ 2 ",
    "nope:oom@1", "dispatch:frob@1", "dispatch:oom@0", "dispatch:oom",
    "dispatch:oom=5ms@1", "dispatch:slow=abc@1", "h2d:oom@x",
])
def test_parse_spec_matches_jax(spec):
    try:
        want = [repr(r) for r in JI.parse_spec(spec)]
    except ValueError:
        with pytest.raises(ValueError):
            parse_spec(spec)
        return
    assert [repr(r) for r in parse_spec(spec)] == want


@pytest.mark.parametrize("attempts,backoff", [(3, 50.0), (5, 0.0),
                                              (1, 7.5), (4, 1000.0)])
def test_retry_policy_delays_match_jax(attempts, backoff):
    port, jax = RetryPolicy(attempts, backoff), \
        JaxRetryPolicy(attempts, backoff)
    assert port.max_attempts == jax.max_attempts
    assert [port.delay_s(a) for a in range(8)] == \
        [jax.delay_s(a) for a in range(8)]
    assert RetryPolicy.from_conf(RapidsConf()).max_attempts == \
        JaxRetryPolicy.from_conf(JaxConf()).max_attempts


@pytest.mark.parametrize("site", inject.SITES)
def test_injection_fires_at_its_call(site):
    for kind, cls in (("oom", ErrorClass.RETRYABLE_OOM),
                      ("device_lost", ErrorClass.DEVICE_LOST)):
        inject.install(f"{site}:{kind}@2")
        inject.maybe_fire(site)
        with pytest.raises(InjectedFault) as ei:
            inject.maybe_fire(site)
        assert classify_error(ei.value) is cls
        inject.maybe_fire(site)  # one-shot: spent
    inject.install(f"{site}:slow=30ms@1+")
    t0 = time.monotonic()
    inject.maybe_fire(site)
    inject.maybe_fire(site)
    assert time.monotonic() - t0 >= 0.055


# -- the ladder through queries ----------------------------------------------


@pytest.fixture(scope="module")
def jax_q1():
    """The JAX host engine's Q1 over the same lineitem."""
    s = TpuSparkSession(JaxConf({"spark.rapids.sql.enabled": False}))
    s.create_dataframe(jax_datagen.gen_lineitem(SF)) \
        .create_or_replace_temp_view("lineitem")
    return s.sql(JAX_QUERIES["q1"]).collect()


@pytest.fixture(scope="module")
def lineitem(tmp_path_factory):
    data = datagen.gen_lineitem(SF)
    path = str(tmp_path_factory.mktemp("faults") / "lineitem.parquet")
    datagen.write_parquet(data, path, row_group_size=BATCH_ROWS)
    return host_batches(data, BATCH_ROWS), path


def session(lineitem, source: str, **conf):
    parts, path = lineitem
    settings = {"spark.rapids.sql.variableFloatAgg.enabled": True,
                "spark.sql.shuffle.partitions": 1}
    if source.startswith("cached"):
        settings["spark.rapids.memory.tpu.spillBudgetBytes"] = 64 << 10
        settings["spark.rapids.sql.tpu.spill.async.enabled"] = \
            source == "cached"
    if source == "split":
        settings.update({"spark.rapids.sql.tpu.exchange.collapseLocal": False,
                         "spark.sql.shuffle.partitions": 4})
    settings.update(conf)
    s = GpuSparkSession(RapidsConf(settings), device="cpu")
    if source == "parquet":
        df = s.read.parquet(path)
    else:
        df = DataFrame(InMemoryScan(parts, parts[0].schema, 1), s)
        if source.startswith("cached"):
            df = df.cache()
    df.create_or_replace_temp_view("lineitem")
    return s


def assert_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        np.testing.assert_allclose(np.array(g[2:], float),
                                   np.array(w[2:], float), rtol=1e-9)


#: spec -> (source, (retryCount, deviceLostCount, partitionFallbackCount,
#: faultsInjected)) the spec implies
SPECS = {
    "dispatch:oom@3": ("plain", (1, 0, 0, 1)),
    "dispatch:device_lost@2": ("plain", (1, 1, 0, 1)),
    "h2d:oom@2": ("plain", (1, 0, 0, 1)),
    "h2d:device_lost@1": ("plain", (1, 1, 0, 1)),
    "d2h:device_lost@1": ("plain", (1, 1, 0, 1)),
    # synchronous spills: the writer's error raises in the triggering call
    # (asynchronous ones surface at the handle's next get, maybe a later
    # query's)
    "spill:oom@1": ("cached-sync", (1, 0, 0, 1)),
    "spill:slow=50ms@2": ("cached", (0, 0, 0, 1)),
    "unspill:oom@1": ("cached", (1, 0, 0, 1)),
    "unspill:device_lost@2": ("cached", (1, 1, 0, 1)),
    "exchange:device_lost@1": ("split", (1, 1, 0, 1)),
    "exchange:oom@2": ("split", (1, 0, 0, 1)),
    "scan:device_lost@1": ("parquet", (1, 1, 0, 1)),
    # persistent: the device replays are used up, the host completes
    "dispatch:device_lost@1+": ("plain", (2, 3, 1, 3)),
    "dispatch:oom@2+": ("plain", (2, 0, 1, 3)),
}


@pytest.mark.parametrize("spec", list(SPECS))
def test_fault_site_recovers_with_jax_rows(spec, lineitem, jax_q1):
    source, want = SPECS[spec]
    s = session(lineitem, source)
    if source.startswith("cached"):  # fill the cache, no fault
        assert_rows(s.sql(QUERIES["q1"]).collect(), jax_q1)
    s.conf.set("spark.rapids.sql.tpu.faults.spec", spec)
    assert_rows(s.sql(QUERIES["q1"]).collect(), jax_q1)
    assert tuple(s.last_metrics.get(k, 0) for k in COUNTERS) == want
    assert not inject.active()  # uninstalled after the query
    assert s.runtime.catalog.verify_accounting() == []


def test_clean_query_leaves_every_counter_absent(lineitem, jax_q1):
    s = session(lineitem, "split")
    assert_rows(s.sql(QUERIES["q1"]).collect(), jax_q1)
    assert not any(k in s.last_metrics for k in COUNTERS)
    assert s.runtime.generation == 0


def test_fallback_off_surfaces_the_raw_error(lineitem):
    s = session(lineitem, "plain", **{
        "spark.rapids.sql.tpu.faults.spec": "dispatch:device_lost@1+",
        "spark.rapids.sql.tpu.fallback.onDeviceError": False})
    with pytest.raises(InjectedFault):
        s.sql(QUERIES["q1"]).collect()


@pytest.mark.parametrize("err", [KeyboardInterrupt, ValueError])
def test_interrupt_and_user_error_not_retried(lineitem, monkeypatch, err):
    s = session(lineitem, "plain")
    calls = []

    def raising(self, batch, *a, **k):
        calls.append(1)
        raise err("from the filter")

    monkeypatch.setattr(GpuFilterExec, "_run", raising)
    with pytest.raises(err):
        s.sql(QUERIES["q1"]).collect()
    assert len(calls) == 1


def test_allocator_oom_lowers_the_budget_for_its_query_only(
        lineitem, monkeypatch, jax_q1):
    """A real allocator OOM spills the cache and halves the budget for
    the replay; the next query runs at the configured budget."""
    budget = 1 << 30
    s = session(lineitem, "cached-sync",
                **{"spark.rapids.memory.tpu.spillBudgetBytes": budget})
    assert_rows(s.sql(QUERIES["q1"]).collect(), jax_q1)  # fill the cache
    catalog = s.runtime.catalog
    resident = catalog.device_bytes_in_use()
    assert resident > 0
    run = GpuFilterExec._run
    seen = []

    def oom_once(self, *a, **k):
        if not seen:
            seen.append(catalog.device_budget)
            raise torch.OutOfMemoryError("CUDA out of memory (test)")
        seen.append(catalog.device_budget)
        return run(self, *a, **k)

    monkeypatch.setattr(GpuFilterExec, "_run", oom_once)
    assert_rows(s.sql(QUERIES["q1"]).collect(), jax_q1)
    assert s.last_metrics.get("retryCount") == 1
    assert seen[0] == budget and seen[1] == resident // 2  # the replay's
    assert catalog.device_budget == budget
    monkeypatch.setattr(GpuFilterExec, "_run", run)
    assert_rows(s.sql(QUERIES["q1"]).collect(), jax_q1)
    assert catalog.device_budget == budget
    assert not any(k in s.last_metrics for k in COUNTERS)
    assert catalog.verify_accounting() == []


def test_write_spills_in_the_sessions_catalog(lineitem, tmp_path):
    """A write runs under the session's runtime: its split pieces count
    against the session's budget (and spill), and close when it ends."""
    s = session(lineitem, "split",
                **{"spark.rapids.memory.tpu.spillBudgetBytes": 64 << 10})
    catalog = s.runtime.catalog
    out = str(tmp_path / "written")
    stats = s.table("lineitem").repartition(4, "l_orderkey") \
        .write_parquet(out)
    assert stats["num_rows"] == sum(p.num_rows for p in lineitem[0])
    assert catalog.metrics["spilled_to_host"] > 0
    assert catalog.tier_counts() == {"device": 0, "host": 0, "disk": 0,
                                     "lost": 0, "spilling": 0}
    assert catalog.verify_accounting() == []
    assert s.read.parquet(out).count() == stats["num_rows"]


def test_watchdog_fires_into_the_thread():
    t0 = time.monotonic()
    with pytest.raises(PartitionTimeout):
        with partition_deadline(0.3, "test"):
            while time.monotonic() - t0 < 5:
                time.sleep(0.01)
    assert time.monotonic() - t0 < 1.0
    with partition_deadline(0.0, "off") as d:  # disarmed
        time.sleep(0.01)
    assert not d.fired


def test_partition_deadline_recovers_a_slow_partition(lineitem, jax_q1):
    """The deadline leaves room for the replay, which must finish inside
    it on a loaded host; the stall is far longer."""
    s = session(lineitem, "plain", **{
        "spark.rapids.sql.tpu.partition.timeoutSec": 0.8,
        "spark.rapids.sql.tpu.faults.spec": "dispatch:slow=6s@2"})
    t0 = time.monotonic()
    assert_rows(s.sql(QUERIES["q1"]).collect(), jax_q1)
    assert time.monotonic() - t0 < 5.0
    assert tuple(s.last_metrics.get(k, 0) for k in COUNTERS) == \
        (1, 1, 0, 1)
    assert s.runtime.generation == 1


def test_recovery_keeps_the_catalog_and_rescues_to_host(lineitem):
    s = session(lineitem, "plain")
    rt = s.runtime
    parts, _ = lineitem
    from spark_rapids_tpu_torch.batch import host_to_device
    h = rt.catalog.register(host_to_device(parts[0], "cpu"))
    catalog = rt.catalog
    rt.recover(rescue=True)
    assert rt.catalog is catalog and rt.generation == 1
    assert h.tier == SpillableBatch.TIER_HOST
    assert int(h.get().num_rows) == parts[0].num_rows
    rt.recover(rescue=False)  # a timeout: no copy, the handle is lost
    assert h.tier == SpillableBatch.TIER_LOST
    with pytest.raises(DeviceLostError) as ei:
        h.get()
    assert classify_error(ei.value) is ErrorClass.DEVICE_LOST
    h.close()
    assert catalog.verify_accounting() == []
