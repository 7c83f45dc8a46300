"""Physical operator model (port of ``spark_rapids_tpu/plan/physical.py``).

Every physical op exposes ``partitions(ctx) -> List[Iterator[batch]]``, a
list of lazily evaluated per-partition batch iterators.  GPU execs yield
device :class:`ColumnBatch` es on ``ctx.device``; CPU execs yield host
:class:`HostBatch` es.  :class:`HostToDeviceExec` stages host batches onto
the device and :class:`DeviceToHostExec` copies device batches back for a
host operator; :func:`collect_host` drives a plan, its root on either
side, and brings the rows back.  Execution is eager, one partition
iterator at a time; the JAX package's whole-stage fusion
(``plan/pipeline.py``) is not ported.
:class:`HostToDeviceExec` stages read-ahead on a worker thread (see its
docstring), so host decode and the host-to-device copies overlap the
consumer's device work.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import (
    ColumnBatch, HostBatch, HostColumn, device_to_host_many,
    host_batch_bytes, host_to_device,
)
from spark_rapids_tpu_torch.config import STAGE_READAHEAD_BATCHES, RapidsConf

#: per-operator metrics that a query sums over its operators into
#: ``session.last_metrics`` (the scan lane's, and the nested-loop join's
#: left slices); readaheadDepthEffective takes the deepest instead
SUMMED_METRICS = ("scanDecodeWallNs", "scanH2dOverlapNs", "scanBytesDecoded",
                  "scanChunksSkipped", "rowGroupsRead", "rowGroupsTotal",
                  "nljChunks", "shufflePieces", "shuffleSyncs",
                  "rangeSampleSyncs", "shuffleSplitDispatches",
                  "shuffleBytes", "shuffleRows", "shuffleElided",
                  "coalescedTo", "aqeCoalescedPartitions", "aqeSkewSplits",
                  "skewSplitChunks", "replannedBroadcast")


class Metric:
    """A named, valued per-operator metric (GpuMetricNames analogue);
    ``add`` may be called from several threads."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def add(self, v) -> None:
        with self._lock:
            self.value += v


class ExecContext:
    """Per-query execution context: conf, the device to run on, the device
    mesh when one is installed, the query's counts (name -> count,
    ``add_metric``) and its per-operator metrics (``metric(op_id,
    name)``)."""

    def __init__(self, conf: RapidsConf, device: torch.device,
                 mesh: Optional[List[torch.device]] = None):
        self.conf = conf
        self.device = device
        self.mesh = mesh
        self.metrics: Dict[str, int] = {}
        self.op_metrics: Dict[str, Dict[str, Metric]] = {}
        #: device batches an operator keeps for the rest of the query (a
        #: shuffle split's pieces, a switched join's build side), by
        #: op_id: freed with the context when the query ends
        self.held: Dict[object, object] = {}
        self._lock = threading.Lock()

    def add_metric(self, name: str) -> None:
        self.metrics[name] = self.metrics.get(name, 0) + 1

    def metric(self, op_id: str, name: str) -> Metric:
        with self._lock:
            ops = self.op_metrics.setdefault(op_id, {})
            if name not in ops:
                ops[name] = Metric(name)
            return ops[name]

    def op_metric_values(self) -> Dict[str, Dict[str, float]]:
        """{op_id: {name: value}} of every per-operator metric."""
        return {op: {n: m.value for n, m in ms.items()}
                for op, ms in self.op_metrics.items()}

    def summed_metrics(self) -> Dict[str, float]:
        """The per-operator metrics of :data:`SUMMED_METRICS` summed over
        the operators that recorded them, and the deepest
        ``readaheadDepthEffective``; a name no operator recorded is
        absent."""
        out: Dict[str, float] = {}
        for ms in self.op_metrics.values():
            for name, m in ms.items():
                if name in SUMMED_METRICS:
                    out[name] = out.get(name, 0) + m.value
                elif name == "readaheadDepthEffective":
                    out[name] = max(out.get(name, 0), m.value)
        return out

    def mesh_spmd_active(self) -> bool:
        """True when joins between mesh exchanges run fused: a mesh is
        installed (``spark.rapids.shuffle.ici.enabled``).  One gate for
        every fusable exec, so a plan never half-fuses."""
        return self.mesh is not None


class PhysicalOp:
    is_gpu = False

    def __init__(self, children: List["PhysicalOp"], output_schema: T.Schema):
        self.children = list(children)
        self.output_schema = output_schema
        self.op_id = f"{type(self).__name__}@{id(self):x}"

    def partitions(self, ctx: ExecContext) -> List[Iterator]:
        raise NotImplementedError

    def num_partitions(self, ctx: ExecContext) -> int:
        """The partitions :meth:`partitions` will give: the first child's
        by default."""
        return self.children[0].num_partitions(ctx) if self.children else 1

    def describe(self) -> str:
        return type(self).__name__

    def tree_string(self, depth: int = 0) -> str:
        out = "  " * depth + self.describe() + "\n"
        for c in self.children:
            out += c.tree_string(depth + 1)
        return out


class GpuExec(PhysicalOp):
    is_gpu = True


class CpuExec(PhysicalOp):
    is_gpu = False


class _ReadAheadChannel:
    """Bounded staging channel between the read-ahead worker and the
    consumer: ``put`` and ``get`` wait on a condition variable and wake at
    once on :meth:`stop`.  ``put`` returns False once stopped (the consumer
    has left: the item is dropped); ``get`` returns None when stopped and
    drained."""

    def __init__(self, depth: int):
        self._items = collections.deque()
        self._depth = max(1, depth)
        self._cond = threading.Condition()
        self._stopped = False

    @property
    def stopped(self) -> bool:
        return self._stopped

    def put(self, item) -> bool:
        with self._cond:
            while not self._stopped and len(self._items) >= self._depth:
                self._cond.wait()
            if self._stopped:
                return False
            self._items.append(item)
            self._cond.notify_all()
            return True

    def get(self):
        with self._cond:
            while not self._stopped and not self._items:
                self._cond.wait()
            if self._items:
                item = self._items.popleft()
                self._cond.notify_all()
                return item
            return None

    def stop(self) -> None:
        """Drop what is queued and wake everyone: a blocked ``put``
        returns False at once."""
        with self._cond:
            self._stopped = True
            self._items.clear()
            self._cond.notify_all()


_STAGING_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}
_STAGING_LOCK = threading.Lock()


def _staging_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream that read-ahead staging copies on: one per device
    for the process, as the default stream is.  The caching allocator
    hands a freed block out again only on the stream that allocated it,
    so a new stream for each query (``torch.cuda.Stream()`` deals 32 in
    turn) would allocate every staged buffer anew."""
    with _STAGING_LOCK:
        stream = _STAGING_STREAMS.get(device)
        if stream is None:
            stream = _STAGING_STREAMS[device] = torch.cuda.Stream(device)
        return stream


def _batch_tensors(batch: ColumnBatch):
    yield batch.num_rows
    for c in batch.columns:
        yield c.data
        yield c.validity
        if c.offsets is not None:
            yield c.offsets


def _reads_device(op: PhysicalOp) -> bool:
    """True when ``op`` or an operator below it runs on the device."""
    return op.is_gpu or any(_reads_device(c) for c in op.children)


class HostToDeviceExec(GpuExec):
    """Stage host batches onto ``ctx.device`` (HostColumnarToGpu analogue).

    With ``spark.rapids.sql.tpu.stage.readAheadBatches`` > 0 a worker
    thread pulls the host batches (which drives the scan's decode) and
    stages up to that many ahead of the consumer.  On CUDA the worker
    copies on a side stream of its own, from pinned host buffers, and
    records an event after each batch's copies; the consumer makes its
    current stream wait on that event before it hands the batch on, and
    marks every tensor of the batch as used on its stream
    (``record_stream``), so the caching allocator does not hand their
    memory out again while the consumer's kernels may still read it.  The
    device is passed to the worker explicitly.  An exception in the worker
    is raised in the consumer; a consumer that stops early (a LIMIT)
    stops the worker, which closes the child's iterator.  The side stream
    is one per device (:func:`_staging_stream`).  With 0 every
    batch is staged on the consumer's thread and stream.  ``stageTime``
    (seconds) is the host time spent staging, ``h2dBytes`` the bytes of
    the device buffers staged (padding included: what the copies move).
    A child that reads device batches itself (a host operator between two
    device ones) is staged at depth 0: the device work below it must stay
    on the stream that made its inputs."""

    def __init__(self, child: PhysicalOp):
        super().__init__([child], child.output_schema)

    def describe(self):
        return "HostToDevice"

    def partitions(self, ctx):
        device = torch.device(ctx.device)
        depth = STAGE_READAHEAD_BATCHES.get(ctx.conf)
        if _reads_device(self.children[0]):
            # a host operator over device batches (a DeviceToHostExec
            # below): its device work stays on the consumer's thread and
            # stream, which made its inputs
            depth = 0
        t_metric = ctx.metric(self.op_id, "stageTime")

        b_metric = ctx.metric(self.op_id, "h2dBytes")

        def stage(hb):
            t0 = time.monotonic()
            db = host_to_device(hb, device)
            t_metric.add(time.monotonic() - t0)
            b_metric.add(sum(t.numel() * t.element_size()
                             for t in _batch_tensors(db)))
            return db

        def gen(part):
            for hb in part:
                yield stage(hb)

        def gen_pipelined(part):
            chan = _ReadAheadChannel(depth)
            side = _staging_stream(device) if device.type == "cuda" \
                else None

            def worker():
                try:
                    with contextlib.ExitStack() as on_side:
                        if side is not None:
                            on_side.enter_context(torch.cuda.device(device))
                            on_side.enter_context(torch.cuda.stream(side))
                        for hb in part:
                            if chan.stopped:
                                return
                            db = stage(hb)
                            ready = None
                            if side is not None:
                                ready = torch.cuda.Event()
                                ready.record(side)
                            if not chan.put(("batch", (db, ready))):
                                return
                    chan.put(("done", None))
                except BaseException as e:  # raised on the consumer side
                    chan.put(("error", e))
                finally:
                    close = getattr(part, "close", None)
                    if close is not None:
                        close()

            t = threading.Thread(target=worker, daemon=True,
                                 name="stage-readahead")
            t.start()
            try:
                while True:
                    item = chan.get()
                    if item is None or item[0] == "done":
                        return
                    kind, value = item
                    if kind == "error":
                        raise value
                    db, ready = value
                    if ready is not None:
                        stream = torch.cuda.current_stream(device)
                        stream.wait_event(ready)
                        for tensor in _batch_tensors(db):
                            tensor.record_stream(stream)
                    yield db
            finally:
                chan.stop()
                t.join(timeout=5.0)

        mk = gen_pipelined if depth > 0 else gen
        return [mk(p) for p in self.children[0].partitions(ctx)]


class DeviceToHostExec(CpuExec):
    """Copy device batches back to the host for a host operator
    (GpuColumnarToRow analogue).  Each batch is shrunk to its live-row
    bucket first, so the copy moves live rows, not padded capacity; a
    string column crosses as its bytes and offsets.  Empty batches are
    dropped.  ``d2hBytes`` counts the host bytes that arrived,
    ``d2hTime`` (seconds) the host time of the copies."""

    def __init__(self, child: PhysicalOp):
        super().__init__([child], child.output_schema)

    def describe(self):
        return "DeviceToHost"

    def partitions(self, ctx):
        from spark_rapids_tpu_torch.ops.gpu_exec import shrink_to_fit
        t_metric = ctx.metric(self.op_id, "d2hTime")
        b_metric = ctx.metric(self.op_id, "d2hBytes")

        def gen(part):
            for db in part:
                t0 = time.monotonic()
                hb = device_to_host_many([shrink_to_fit(db)],
                                         keep_offsets=True)[0]
                t_metric.add(time.monotonic() - t0)
                b_metric.add(host_batch_bytes(hb))
                if hb.num_rows:
                    yield hb

        return [gen(p) for p in self.children[0].partitions(ctx)]


@contextlib.contextmanager
def host_timer(ctx: ExecContext, op: PhysicalOp):
    """Adds the host seconds of the block to ``op``'s ``hostTime``: a host
    operator's own work, its input's production left out."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        ctx.metric(op.op_id, "hostTime").add(time.monotonic() - t0)


def _empty_host_batch(schema: T.Schema) -> HostBatch:
    return HostBatch(schema, [
        HostColumn(f.dtype, np.zeros(0, dtype=f.dtype.np_dtype),
                   np.zeros(0, dtype=np.bool_)) for f in schema.fields])


def collect_host(op: PhysicalOp, ctx: ExecContext) -> HostBatch:
    """Drive a plan to completion and concatenate every partition's rows
    on the host: a device plan's batches with one sizes sync and one copy
    sync for all of them, a host plan's as they come (strings one ``str``
    a row either way)."""
    batches = [b for part in op.partitions(ctx) for b in part]
    if op.is_gpu:
        hbs = device_to_host_many(batches)
    else:
        hbs = [HostBatch(hb.schema, [
            HostColumn(c.dtype, c.string_values(), c.validity)
            if c.offsets is not None else c for c in hb.columns])
            for hb in batches]
    hbs = [hb for hb in hbs if hb.num_rows]
    if not hbs:
        return _empty_host_batch(op.output_schema)
    return HostBatch.concat(hbs)
