"""The port's asynchronous spill writers against the JAX package's
(``tests/test_spill_async.py`` sets the cases): a queued spill cancelled
by ``get``, a writer's fault surfacing at the next ``get``, the
synchronous mode's eager moves, the unspill fault site, and a cached
query's rows under a tiny budget in both modes against the JAX host
engine's."""

import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import host_to_device as jax_h2d
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.fault import inject as jax_inject
from spark_rapids_tpu.mem import catalog as JC
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import host_to_device
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.fault import inject
from spark_rapids_tpu_torch.fault.inject import InjectedFault
from spark_rapids_tpu_torch.mem import catalog as PC
from spark_rapids_tpu_torch.dataframe import DataFrame
from spark_rapids_tpu_torch.interop import host_batches
from spark_rapids_tpu_torch.plan.logical import InMemoryScan
from spark_rapids_tpu_torch.session import GpuSparkSession

from test_torch_mem import (
    TIERS, assert_same_rows, jax_batch, settings,
)
from torch_port_util import one_torch_thread, port_host_batch  # noqa: F401

DEVICE = PC.SpillableBatch.TIER_DEVICE
HOST = PC.SpillableBatch.TIER_HOST


@pytest.fixture(autouse=True)
def _clean_registries():
    yield
    inject.uninstall()
    jax_inject.uninstall()


def both(spec, **kw):
    """(JAX catalog, port catalog), each with ``spec`` installed for its
    own injector."""
    s = settings(**kw)
    return JC.BufferCatalog(JaxConf(s)), PC.BufferCatalog(RapidsConf(s))


def port_batch(i=0, rows=20):
    return host_to_device(port_host_batch(jax_batch(rows, seed=i)), "cpu")


def jax_dev(i=0, rows=20):
    return jax_h2d(jax_batch(rows, seed=i))


def test_get_cancels_queued_spill():
    """One writer stalled by a slow spill keeps the next spill queued; a
    get() of that handle cancels it, in both packages alike."""
    traces = []
    for mod, cat_i, make in ((jax_inject, 0, jax_dev),
                             (inject, 1, port_batch)):
        mod.install("spill:slow=300ms@1")
        cat = both(None, device_budget=1, async_spill=True, **{
            "spark.rapids.sql.tpu.spill.writer.threads": 1})[cat_i]
        h1 = cat.register(make(0), priority=1)
        h2 = cat.register(make(1), priority=2)  # h1's spill: stalled
        cat.register(make(2), priority=3)       # h2's spill: queued
        h2.get()
        assert h2.tier == DEVICE
        cat.drain_spills()
        traces.append((TIERS[h1.tier], TIERS[h2.tier],
                       cat.metrics["spill_cancelled"]))
        assert cat.verify_accounting() == [] if cat_i else True
        mod.uninstall()
    assert traces[0] == traces[1]
    assert traces[1][:2] == ("host", "device") and traces[1][2] >= 1


@pytest.mark.parametrize("site", ["spill", "unspill"])
def test_fault_surfaces_at_get_once(site):
    """A failing spill (on the writer) or unspill surfaces its classified
    error once at the consumer's get(); the next get() gives the rows."""
    inject.install(f"{site}:oom@1")
    cat = PC.BufferCatalog(RapidsConf(settings(device_budget=1,
                                               async_spill=True)))
    h1 = cat.register(port_batch(0), priority=1)
    cat.register(port_batch(1), priority=2)
    cat.drain_spills()
    assert h1.tier == (DEVICE if site == "spill" else HOST)
    with pytest.raises(InjectedFault):
        h1.get()
    assert_same_rows(h1.get(), jax_batch(20, seed=0))
    # the unspill spills the other handle (budget 1)
    assert cat.metrics["spilled_to_host"] == (0 if site == "spill" else 2)
    assert cat.verify_accounting() == []


def test_sync_mode_is_eager():
    cat = PC.BufferCatalog(RapidsConf(settings(device_budget=1,
                                               async_spill=False)))
    h1 = cat.register(port_batch(0), priority=1)
    cat.register(port_batch(1), priority=2)
    # no drain: the synchronous spill finished inside register
    assert h1.tier == HOST and h1._spill_task is None
    assert cat.metrics["spill_queue_depth_max"] == 0


def test_counters_equal_a_scan_after_every_move():
    cat = PC.BufferCatalog(RapidsConf(settings(
        device_budget=3000, host_budget=3000, async_spill=True)))
    hs = []
    for i in range(8):
        hs.append(cat.register(port_batch(i, rows=30 + i), priority=i % 3))
        assert cat.verify_accounting() == []
        if i % 3 == 2:
            hs[i - 2].get()
    cat.drain_spills()
    assert cat.verify_accounting() == []
    assert cat.metrics["spilled_to_disk"] > 0
    for h in hs[::2]:
        h.close()
    cat.drain_spills()
    assert cat.verify_accounting() == []


QUERY = ("SELECT k, count(*) AS n, sum(v) AS s FROM t WHERE v % 3 <> 1 "
         "GROUP BY k ORDER BY k")


def table(types):
    return {"k": (types.INT, [i % 7 for i in range(3000)]),
            "v": (types.LONG, list(range(3000)))}


@pytest.fixture(scope="module")
def jax_rows():
    s = TpuSparkSession(JaxConf({"spark.rapids.sql.enabled": False}))
    s.create_dataframe(table(JT), num_partitions=3) \
        .create_or_replace_temp_view("t")
    return s.sql(QUERY).collect()


@pytest.mark.parametrize("async_spill", [True, False])
def test_cached_query_under_tiny_budget_matches_jax(jax_rows, async_spill):
    want = jax_rows
    s = GpuSparkSession(RapidsConf(settings(
        device_budget=8192, host_budget=8192, async_spill=async_spill)),
        device="cpu")
    parts = host_batches(table(T), 500)  # six cached batches
    df = DataFrame(InMemoryScan(parts, parts[0].schema, 3), s).cache()
    df.create_or_replace_temp_view("t")
    for _ in range(2):
        assert s.sql(QUERY).collect() == want
    cat = s.runtime.catalog
    assert cat.metrics["spilled_to_host"] > 0
    assert cat.metrics["spilled_to_disk"] > 0
    assert cat.metrics["unspilled"] > 0
    assert s.last_metrics.get("unspillPrefetchHits", 0) > 0
    cat.drain_spills()
    assert cat.verify_accounting() == []
    df.unpersist()
    assert cat.tier_counts() == dict.fromkeys(TIERS.values(), 0)


def test_stress_many_threads_keep_the_counters_right():
    """More threads than cores register, read and close handles on one
    catalog while four writers spill under a budget of about two batches,
    with a short switch interval: the incremental counters must equal a
    scan, and every read must give its batch back."""
    import os
    import sys
    import threading
    cat = PC.BufferCatalog(RapidsConf(settings(
        device_budget=4000, host_budget=6000, async_spill=True, **{
            "spark.rapids.sql.tpu.spill.writer.threads": 4})))
    errors = []

    def work(t):
        try:
            mine = []
            for i in range(6):
                mine.append(cat.register(port_batch(t * 10 + i),
                                         priority=(t + i) % 3))
                for h in mine[-2:]:
                    assert int(h.get().num_rows) == 20
            for h in mine[::2]:
                h.close()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    cat.drain_spills()
    assert cat.verify_accounting() == []
