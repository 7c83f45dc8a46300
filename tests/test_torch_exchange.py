"""PyTorch port, the partitioned exchange on one device, against the JAX
package on the CPU (mirrors ``tests/test_shuffle_split.py``).

* partition ids: hash (an int key, a string key, mixed keys), round
  robin, range (ascending, descending with NULLs last, NULLs first, a
  string key) and single partitioning give every row the JAX package's
  id, on the device and on the host; the range bounds are the JAX
  package's bound rows from the same sample;
* the split: over batches with strings, arrays and NULLs the port's
  device exchange gives the JAX device exchange's partitions (rows, order
  within each partition, ``_last_part_rows``, ``_last_part_bytes``), its
  host twin equals the JAX host twin, the split takes one host sync and
  the range sample three;
* ``gather_segments_kway`` equals the JAX function buffer for buffer,
  bytes and elements past the live totals (zeros) included;
* ``splitCoalesceMaxBytes`` gives per-batch pieces, with the same rows;
* ``CpuBroadcastExchangeExec.materialize`` equals the JAX one's.

Bit for bit throughout: no tolerance.
"""

import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import HostBatch as JHostBatch
from spark_rapids_tpu.batch import device_to_host_many as jax_to_host
from spark_rapids_tpu.batch import host_to_device as jax_to_device
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.exprs.base import ColumnRef as JColumnRef
from spark_rapids_tpu.exprs.base import SortOrder as JSortOrder
from spark_rapids_tpu.kernels.layout import (
    gather_segments_kway as jax_gather_segments,
)
from spark_rapids_tpu.parallel import exchange as JX
from spark_rapids_tpu.parallel import partitioning as JP
from spark_rapids_tpu.plan.physical import ExecContext as JExecContext
from spark_rapids_tpu.plan.physical import TpuExec
from spark_rapids_tpu.runtime.device import DeviceRuntime

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import HostBatch, device_to_host_many
from spark_rapids_tpu_torch.batch import host_to_device
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exprs.base import ColumnRef, SortOrder
from spark_rapids_tpu_torch.kernels.layout import gather_segments_kway
from spark_rapids_tpu_torch.ops.cpu_exec import CpuInMemoryScanExec
from spark_rapids_tpu_torch.parallel import exchange as PX
from spark_rapids_tpu_torch.parallel import partitioning as PP
from spark_rapids_tpu_torch.plan.physical import ExecContext, GpuExec

from torch_port_util import assert_device_bits
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
N_TARGETS = 4
SPLIT = {"spark.rapids.sql.tpu.exchange.collapseLocal": False}


def _columns(rows: int, seed: int) -> dict:
    """Names -> (type name, values): an INT key and a DOUBLE with NULLs, a
    STRING with NULLs, an array payload, a row number."""
    rng = np.random.RandomState(seed)
    return {
        "k": ("INT", [None if i % 9 == 4 else int(x) for i, x in
                      enumerate(rng.randint(-20, 23, rows))]),
        "s": ("STRING", [None if i % 7 == 3 else
                         f"key{(i * 5 + seed) % 11}" + "pad" * (i % 4)
                         for i in range(rows)]),
        "d": ("DOUBLE", [None if i % 5 == 2 else float(x) for i, x in
                         enumerate(rng.randn(rows).round(3))]),
        "a": ("ARRAY", [[i % 3, i % 7, i % 5][: 1 + i % 3]
                        for i in range(rows)]),
        "v": ("LONG", list(range(seed * 1000, seed * 1000 + rows))),
    }


def _pydict(cols: dict, types) -> dict:
    def dtype(name):
        return types.ArrayType(types.INT) if name == "ARRAY" else \
            getattr(types, name)
    return {k: (dtype(t), v) for k, (t, v) in cols.items()}


#: (rows of each input batch, grouped by input partition)
SHAPES = [[60, 45], [50]]


def _inputs():
    """The same batches for both packages, one list per input partition."""
    cols = [[_columns(n, seed=10 * p + b) for b, n in enumerate(part)]
            for p, part in enumerate(SHAPES)]
    jax_parts = [[jax_to_device(JHostBatch.from_pydict(_pydict(c, JT)))
                  for c in part] for part in cols]
    port_parts = [[host_to_device(HostBatch.from_pydict(_pydict(c, T)), CPU)
                   for c in part] for part in cols]
    host_parts = [[HostBatch.from_pydict(_pydict(c, T)) for c in part]
                  for part in cols]
    jhost_parts = [[JHostBatch.from_pydict(_pydict(c, JT)) for c in part]
                   for part in cols]
    return jax_parts, port_parts, host_parts, jhost_parts


SCHEMA_COLS = list(_columns(1, 0))


def _ref(types, name):
    dt = {"k": types.INT, "s": types.STRING, "d": types.DOUBLE,
          "v": types.LONG}[name]
    return dt


#: the partitionings under test: (kind, key columns, ascending, nulls
#: first) for range, (kind, key columns) otherwise
KINDS = {
    "hash-int": ("hash", ["k"]),
    "hash-string": ("hash", ["s"]),
    "hash-mixed": ("hash", ["k", "s", "d"]),
    "roundrobin": ("roundrobin", []),
    "range-asc": ("range", ["k", "v"], True, True),
    "range-desc-nulls-last": ("range", ["d"], False, False),
    "range-nulls-first": ("range", ["d", "v"], True, True),
    "range-string": ("range", ["s", "v"], True, False),
    "single": ("single", []),
}


def _make(kind: str, jax: bool, n: int = N_TARGETS):
    """The partitioning of ``kind`` in one package (range unprepared)."""
    spec = KINDS[kind]
    P, types = (JP, JT) if jax else (PP, T)
    col, order = (JColumnRef, JSortOrder) if jax else (ColumnRef, SortOrder)
    keys = [col(c, _ref(types, c)) for c in spec[1]]
    if spec[0] == "hash":
        return P.HashPartitioning(keys, n)
    if spec[0] == "roundrobin":
        return P.RoundRobinPartitioning(n)
    if spec[0] == "single":
        return P.SinglePartitioning()
    orders = [order(k, spec[2], spec[3]) for k in keys]
    return P.RangePartitioning(orders, [SCHEMA_COLS.index(c)
                                        for c in spec[1]], n)


def _rows(hbs) -> list:
    out = []
    for hb in hbs:
        d = hb.to_pydict()
        out.extend(tuple(tuple(x) if isinstance(x, list) else x
                         for x in r) for r in zip(*d.values()))
    return out


# -- partition ids ---------------------------------------------------------


@pytest.mark.parametrize("kind", list(KINDS))
def test_partition_ids_match_jax(kind):
    jax_parts, port_parts, host_parts, jhost_parts = _inputs()
    jp, pp = _make(kind, True), _make(kind, False)
    if isinstance(pp, PP.RangePartitioning):
        jsample = JX._sample_device_keys(jax_parts, jp.key_ordinals, 100)
        cols, rows = PX._sample_device_keys(port_parts, pp.key_ordinals, 100)
        assert list(zip(*[c.to_list() for c in cols])) == jsample
        assert rows == len(jsample) == 100
        jp.prepare(jsample)
        pp.prepare_columns(cols, rows)
        assert pp.bound_rows == jp.bound_rows
        pp.prepare(jsample)  # from key tuples, the same rows
        assert pp.bound_rows == jp.bound_rows
        assert len(pp.bound_rows) == N_TARGETS - 1
    for pi, (jpart, ppart, hpart, jhpart) in enumerate(zip(
            jax_parts, port_parts, host_parts, jhost_parts)):
        for jb, pb, hb, jhb in zip(jpart, ppart, hpart, jhpart):
            n = hb.num_rows
            if isinstance(jp, JP.RangePartitioning):
                want = jp.device_partition_ids_from_words(
                    jb, jp.encode_bounds_device())
            else:
                want = jp.device_partition_ids(jb, pi)
            want = np.asarray(want)[:n]
            got = pp.device_partition_ids(pb, pi)[:n].numpy()
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(pp.host_partition_ids(hb, pi),
                                          jp.host_partition_ids(jhb, pi))
            if kind != "single":
                assert len(set(want.tolist())) > 1


# -- the split --------------------------------------------------------------


class _JaxSource(TpuExec):
    def __init__(self, schema, parts):
        super().__init__([], schema)
        self._parts = parts

    def partitions(self, ctx):
        return [iter(list(p)) for p in self._parts]


class _PortSource(GpuExec):
    def __init__(self, schema, parts):
        super().__init__([], schema)
        self._parts = parts

    def partitions(self, ctx):
        return [iter(list(p)) for p in self._parts]


def _jax_split(kind, parts):
    DeviceRuntime.reset()
    try:
        conf = JaxConf(dict(SPLIT))
        ex = JX.TpuShuffleExchangeExec(_make(kind, True),
                                       _JaxSource(parts[0][0].schema, parts))
        ctx = JExecContext(conf, device=DeviceRuntime.get(conf).device)
        out = [_rows(jax_to_host(list(p))) for p in ex.partitions(ctx)]
        sizes = (getattr(ex, "_last_part_rows", None),
                 getattr(ex, "_last_part_bytes", None))
        ctx.close_deferred()
        return out, sizes
    finally:
        DeviceRuntime.reset()


def _port_split(kind, parts, extra=None):
    ex = PX.GpuShuffleExchangeExec(_make(kind, False),
                                   _PortSource(parts[0][0].schema, parts))
    ctx = ExecContext(RapidsConf(dict(SPLIT, **(extra or {}))), CPU)
    out = [_rows(device_to_host_many(list(p))) for p in ex.partitions(ctx)]
    metrics = ctx.op_metric_values().get(ex.op_id, {})
    return out, (getattr(ex, "_last_part_rows", None),
                 getattr(ex, "_last_part_bytes", None)), metrics


@pytest.mark.parametrize("kind", list(KINDS))
def test_split_matches_jax(kind):
    """Rows, their order within each partition and the recorded sizes
    equal the JAX device exchange's; one sync for the split, three for a
    range sample."""
    jax_parts, port_parts, _, _ = _inputs()
    want, want_sizes = _jax_split(kind, jax_parts)
    got, sizes, metrics = _port_split(kind, port_parts)
    assert got == want
    assert sizes == want_sizes
    assert sum(map(len, got)) == sum(map(sum, SHAPES))
    if kind != "single":
        assert metrics["shuffleSyncs"] == 1
        assert metrics["shufflePieces"] <= N_TARGETS
    assert metrics.get("rangeSampleSyncs", 0) == \
        (3 if kind.startswith("range") else 0)


@pytest.mark.parametrize("kind", list(KINDS))
def test_host_twin_matches_jax(kind):
    """The host exchange's partitions equal the JAX host twin's, and the
    device split's (rows in the same order within each partition)."""
    _, port_parts, host_parts, jhost_parts = _inputs()

    def jax_source_host(parts):
        class Src(JX.CpuExec):
            def __init__(self):
                super().__init__([], parts[0][0].schema)

            def partitions(self, ctx):
                return [iter(list(p)) for p in parts]
        return Src()

    jex = JX.CpuShuffleExchangeExec(_make(kind, True),
                                    jax_source_host(jhost_parts))
    want = [_rows(list(p)) for p in jex.partitions(
        JExecContext(JaxConf(dict(SPLIT)), device=None))]
    scan = CpuInMemoryScanExec([], host_parts[0][0].schema, 1)
    scan.partitions = lambda ctx: [iter(list(p)) for p in host_parts]
    pex = PX.CpuShuffleExchangeExec(_make(kind, False), scan)
    got = [_rows(list(p)) for p in pex.partitions(
        ExecContext(RapidsConf(dict(SPLIT)), CPU))]
    assert got == want
    device, _, _ = _port_split(kind, port_parts)
    assert device == got


def test_collapsed_exchange_hands_the_batches_on():
    """At the default (collapseLocal on) both exchanges give one
    partition: every input batch, in partition then batch order."""
    _, port_parts, host_parts, _ = _inputs()
    ex = PX.GpuShuffleExchangeExec(_make("hash-int", False),
                                   _PortSource(port_parts[0][0].schema,
                                               port_parts))
    ctx = ExecContext(RapidsConf({}), CPU)
    parts = ex.partitions(ctx)
    assert len(parts) == 1 and ex.num_partitions(ctx) == 1
    assert list(parts[0]) == [b for p in port_parts for b in p]


# -- the piece gather --------------------------------------------------------


def test_gather_segments_kway_matches_jax():
    """Windows that start past row 0, an empty window, a window reaching
    past a take_head (offsets growing past the live rows): every buffer
    equals the JAX function's, zeros past the live totals."""
    from spark_rapids_tpu.kernels.layout import take_head as jax_take_head
    from spark_rapids_tpu_torch.kernels.layout import take_head
    cols = [_columns(n, seed=s) for s, n in enumerate((40, 35, 50))]
    jb = [jax_to_device(JHostBatch.from_pydict(_pydict(c, JT)))
          for c in cols]
    pb = [host_to_device(HostBatch.from_pydict(_pydict(c, T)), CPU)
          for c in cols]
    jb[2], pb[2] = jax_take_head(jb[2], 20), take_head(pb[2], 20)
    starts, counts = [7, 25, 3], [30, 0, 17]
    caps = [1024, 256]  # the string bytes, the array elements
    want = jax_gather_segments(jb, starts, counts, 64, caps)
    got = gather_segments_kway(pb, starts, counts, 64, caps)
    assert_device_bits(want, got)
    assert int(got.num_rows) == 47


def test_coalesce_cap_gives_per_batch_pieces():
    """A partition over splitCoalesceMaxBytes stays as per-batch pieces:
    the same rows, one piece per (batch, target), still one sync."""
    _, port_parts, _, _ = _inputs()
    coalesced, _, m = _port_split("roundrobin", port_parts)
    capped, _, m_cap = _port_split(
        "roundrobin", port_parts,
        {"spark.rapids.sql.tpu.exchange.splitCoalesceMaxBytes": 1})
    assert capped == coalesced
    assert m["shufflePieces"] == N_TARGETS
    assert m_cap["shufflePieces"] == 3 * N_TARGETS
    assert m_cap["shuffleSyncs"] == 1


def test_cpu_broadcast_exchange_matches_jax():
    _, _, host_parts, jhost_parts = _inputs()

    class JSrc(JX.CpuExec):
        def __init__(self):
            super().__init__([], jhost_parts[0][0].schema)

        def partitions(self, ctx):
            return [iter(list(p)) for p in jhost_parts]

    want = JX.CpuBroadcastExchangeExec(JSrc()).materialize(
        JExecContext(JaxConf({}), device=None))
    scan = CpuInMemoryScanExec([], host_parts[0][0].schema, 1)
    scan.partitions = lambda ctx: [iter(list(p)) for p in host_parts]
    ex = PX.CpuBroadcastExchangeExec(scan)
    ctx = ExecContext(RapidsConf({}), CPU)
    got = ex.materialize(ctx)
    assert _rows([got]) == _rows([want])
    assert ex.materialize(ctx) is got  # once per exec
    assert [list(p) for p in ex.partitions(ctx)] == [[got]]
