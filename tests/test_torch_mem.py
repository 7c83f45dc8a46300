"""The port's spill catalog, codecs and batch serializer against the JAX
package's (``spark_rapids_tpu/mem/``, ``native_rt.py``): the same frames
and bytes, the same victims and tier moves for the same registers,
priorities, budgets and byte sizes, and the OOM retry keyed on torch's
allocator error."""

import io

import numpy as np
import pytest
import torch

from spark_rapids_tpu import native_rt
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.batch import host_to_device as jax_h2d
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.mem import catalog as JC
from spark_rapids_tpu.mem import codec as jax_codec

from spark_rapids_tpu_torch.batch import device_to_host, host_to_device
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.mem import catalog as PC
from spark_rapids_tpu_torch.mem import codec as port_codec
from spark_rapids_tpu_torch.mem.serialize import (
    deserialize_host_batch, serialize_host_batch,
)

from torch_port_util import one_torch_thread, port_host_batch  # noqa: F401

TIERS = {0: "device", 1: "host", 2: "disk", 3: "lost", 4: "spilling"}


def jax_batch(rows: int, seed: int = 0, tail: str = "") -> JaxHostBatch:
    """A batch of every buffer kind.  ``tail`` ends each string: the
    catalogs' tests keep it ASCII, since the port counts a host string's
    UTF-8 bytes where the JAX package counts its characters (the host
    tier's byte counts differ by design on other text)."""
    r = np.random.RandomState(seed)
    return JaxHostBatch.from_pydict({
        "x": (JT.INT, [int(v) if v % 7 else None
                       for v in r.randint(0, 50, rows)]),
        "d": (JT.DOUBLE, list(r.rand(rows))),
        "s": (JT.STRING, [("ab" * (i % 4) + tail) if i % 5 else None
                          for i in range(rows)]),
        "dt": (JT.DATE, list(r.randint(0, 20000, rows))),
    })


def settings(device_budget, host_budget=1 << 20, async_spill=False,
             **extra):
    return {"spark.rapids.memory.tpu.spillBudgetBytes": device_budget,
            "spark.rapids.memory.host.spillStorageSize": host_budget,
            "spark.rapids.sql.tpu.spill.async.enabled": async_spill,
            **extra}


def catalogs(**kw):
    s = settings(**kw)
    return JC.BufferCatalog(JaxConf(s)), PC.BufferCatalog(RapidsConf(s))


def assert_same_rows(port_dev, jb: JaxHostBatch):
    got = device_to_host(port_dev).to_pydict()
    want = jb.to_pydict()
    assert list(got) == list(want)
    for k in want:
        g, w = got[k], want[k]
        assert [v is None for v in g] == [v is None for v in w], k
        for a, b in zip(g, w):
            if b is not None:
                assert a == b, k


# -- codecs and the serialized form -----------------------------------------


@pytest.mark.parametrize("codec,chunk,size", [
    ("copy", 0, 1000), ("copy", 64, 1000), ("zlib", 0, 1000),
    ("zlib", 100, 1000), ("zlib", 64, 0), ("uncompressed", 333, 1000),
])
def test_codec_frames_match_jax(codec, chunk, size):
    data = (b"spill frame bytes \x00\xff" * 60)[:size]
    frames = []
    for mod in (jax_codec, port_codec):
        f = io.BytesIO()
        enc = mod.write_chunked(f, data, mod.get_codec(codec), chunk)
        frames.append((f.getvalue(), enc))
        f.seek(0)
        assert mod.read_chunked(f, mod.get_codec(codec)) == data
    assert frames[0] == frames[1]


def test_get_codec_rejects():
    with pytest.raises(ValueError, match="unknown"):
        port_codec.get_codec("nope")
    with pytest.raises(ValueError, match="item 10"):
        port_codec.get_codec("nativelz")


@pytest.mark.parametrize("rows", [0, 1, 37])
def test_serialized_batch_matches_jax(rows):
    jb = jax_batch(rows, seed=rows, tail="é\u4e2d")
    pb = port_host_batch(jb)
    raw = serialize_host_batch(pb)
    assert raw == native_rt.serialize_host_batch(jb)
    back = deserialize_host_batch(raw, pb.schema)
    assert back.to_pydict() == jb.to_pydict()


# -- the catalog: victims and tier moves ------------------------------------

#: (device budget, host budget, [(rows, priority)] registered in turn)
SEQUENCES = {
    "fits": (1 << 30, 1 << 20, [(40, 0), (40, 0)]),
    "lowest priority first": (2000, 1 << 20,
                              [(40, 5), (40, 1), (40, 3), (40, 2)]),
    "ties by id": (2500, 1 << 20, [(40, 0)] * 5),
    "to disk past the host store": (1, 1500, [(40, 2), (40, 1), (40, 3)]),
    "shuffle output before input": (3000, 1 << 20, [
        (40, PC.PRIORITY_INPUT), (40, PC.PRIORITY_SHUFFLE_OUTPUT),
        (40, PC.PRIORITY_ON_DECK), (40, PC.PRIORITY_SHUFFLE_OUTPUT)]),
}


def run_sequence(cat, make, regs, get_index):
    handles, trace = [], []
    for i, (rows, prio) in enumerate(regs):
        handles.append(cat.register(make(rows, i), priority=prio))
        cat.drain_spills()
        trace.append(tuple(TIERS[h.tier] for h in handles))
    got = handles[get_index].get()
    cat.drain_spills()
    trace.append(tuple(TIERS[h.tier] for h in handles))
    return handles, got, trace


@pytest.mark.parametrize("async_spill", [False, True])
@pytest.mark.parametrize("name", list(SEQUENCES))
def test_catalog_tier_moves_match_jax(name, async_spill):
    device_budget, host_budget, regs = SEQUENCES[name]
    jcat, pcat = catalogs(device_budget=device_budget,
                          host_budget=host_budget, async_spill=async_spill)
    jbs = {}

    def jmake(rows, i):
        jbs[i] = jax_batch(rows, seed=i)
        return jax_h2d(jbs[i])

    def pmake(rows, i):
        return host_to_device(port_host_batch(jax_batch(rows, seed=i)),
                              "cpu")

    jh, _, jtrace = run_sequence(jcat, jmake, regs, 0)
    ph, got, ptrace = run_sequence(pcat, pmake, regs, 0)
    assert [h.device_bytes for h in ph] == \
        [JC.device_batch_bytes(jax_h2d(jbs[i])) for i in range(len(regs))]
    assert ptrace == jtrace
    for k in ("spilled_to_host", "spilled_to_disk", "unspilled"):
        assert pcat.metrics[k] == jcat.metrics[k], k
    assert pcat.device_bytes_in_use() == jcat.device_bytes_in_use()
    assert pcat.host_bytes_in_use() == jcat.host_bytes_in_use()
    assert pcat.verify_accounting() == []
    assert_same_rows(got, jbs[0])
    for i, h in enumerate(ph):  # every tier gives the batch back
        assert_same_rows(h.get(), jbs[i])
    assert pcat.verify_accounting() == []
    for h in ph:
        h.close()
    assert pcat.device_bytes_in_use() == 0 == pcat.host_bytes_in_use()
    assert pcat.tier_counts() == dict.fromkeys(TIERS.values(), 0)


def test_prefetch_hands_back_every_batch():
    _, pcat = catalogs(device_budget=1, host_budget=1500)
    jbs = [jax_batch(30, seed=i) for i in range(4)]
    hs = [pcat.register(host_to_device(port_host_batch(jb), "cpu"))
          for jb in jbs]
    pcat.drain_spills()
    # a register never spills the batch it registers: the last stays
    assert [h.tier == PC.SpillableBatch.TIER_DEVICE for h in hs] == \
        [False, False, False, True]
    for got, jb in zip(pcat.prefetch(hs, depth=2), jbs):
        assert_same_rows(got, jb)
    # each unspill spills the one before it (budget 1), the last included
    assert pcat.metrics["unspill_prefetch_hits"] == 4
    assert pcat.verify_accounting() == []


# -- the OOM retry -----------------------------------------------------------


def test_oom_retry_spills_and_reruns():
    _, pcat = catalogs(device_budget=1 << 30)
    hs = [pcat.register(host_to_device(port_host_batch(jax_batch(30, i)),
                                       "cpu")) for i in range(3)]
    calls = []

    def thunk():
        calls.append(1)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (test)")
        return "done"

    assert PC.run_with_oom_retry(pcat, thunk) == "done"
    assert len(calls) == 2
    assert all(h.tier == PC.SpillableBatch.TIER_HOST for h in hs)
    assert pcat.metrics["oom_spill_bytes"] == sum(h.device_bytes for h in hs)
    # a real allocator OOM halves the budget to what was resident
    assert pcat.device_budget == sum(h.device_bytes for h in hs) // 2
    assert pcat.verify_accounting() == []


@pytest.mark.parametrize("case", ["nothing spillable", "other error",
                                  "attempts used up"])
def test_oom_retry_gives_up(case):
    _, pcat = catalogs(device_budget=1 << 30)
    if case != "nothing spillable":
        pcat.register(host_to_device(port_host_batch(jax_batch(30)), "cpu"))
    err = ValueError("user error") if case == "other error" else \
        torch.OutOfMemoryError("CUDA out of memory (test)")
    calls = []

    def thunk():
        calls.append(1)
        raise err

    with pytest.raises(type(err)):
        PC.run_with_oom_retry(pcat, thunk,
                              retries=0 if case == "attempts used up"
                              else None)
    assert len(calls) == 1


def test_oom_retry_skips_pinned_handle():
    """A handle whose buffers the retrying work still holds is not
    spilled: it would free nothing and a later get() would copy again."""
    _, pcat = catalogs(device_budget=1 << 30)
    batches = [host_to_device(port_host_batch(jax_batch(30, i)), "cpu")
               for i in range(2)]
    hs = [pcat.register(b) for b in batches]
    freed = pcat.handle_alloc_failure(pinned=[batches[0]])
    assert hs[0].tier == PC.SpillableBatch.TIER_DEVICE
    assert hs[1].tier == PC.SpillableBatch.TIER_HOST
    assert freed == hs[1].device_bytes
    assert PC.is_device_oom(torch.OutOfMemoryError("x"))
    assert not PC.is_device_oom(RuntimeError("x"))
