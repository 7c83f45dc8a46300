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

:func:`collect_host` drives one partition at a time under the partition
deadline and, when a partition fails, takes it through the fault ladder
(:mod:`spark_rapids_tpu_torch.fault.recovery`: spill and replay on an OOM,
reset and replay on a device loss, then that partition on the host
operators); an error outside any partition (the plan's eager work, the
final copy) replays the whole collect the same way.  Every batch a GPU
exec produces passes the ``dispatch`` fault site
(:meth:`GpuExec.__init_subclass__`).
"""

from __future__ import annotations

import collections
import contextlib
import functools
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
from spark_rapids_tpu_torch.fault import inject

#: Bounded wait slice (seconds) of the read-ahead channel's waits, so the
#: partition watchdog's exception can land in a waiting consumer.
_WAIT_SLICE = 0.25

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
    mesh when one is installed, the session's runtime (its spill catalog
    and generation; a context made outside a session, for an exec driven
    alone, gets a catalog of its own), the query's counts (name -> count,
    ``add_metric``) and its per-operator metrics
    (``metric(op_id, name)``)."""

    def __init__(self, conf: RapidsConf, device: torch.device,
                 mesh: Optional[List[torch.device]] = None, runtime=None):
        self.conf = conf
        self.device = device
        self.mesh = mesh
        self.runtime = runtime
        #: the query's logical plan: the fault ladder's host fallback
        #: lowers it again with spark.rapids.sql.enabled=false
        self.logical_plan = None
        self.metrics: Dict[str, int] = {}
        self.op_metrics: Dict[str, Dict[str, Metric]] = {}
        #: what an operator keeps for the rest of the query (a shuffle
        #: split's spillable pieces, a broadcast build's handle), by key
        self.held: Dict[object, object] = {}
        self._deferred: List = []
        self._catalog = None
        self._lock = threading.Lock()

    @property
    def catalog(self):
        """The spill catalog the query's spillable batches register in."""
        if self.runtime is not None:
            return self.runtime.catalog
        if self._catalog is None:
            from spark_rapids_tpu_torch.mem.catalog import BufferCatalog
            self._catalog = BufferCatalog(self.conf)
        return self._catalog

    @property
    def generation(self) -> int:
        """The runtime's device-lost recoveries so far (0 without one)."""
        return self.runtime.generation if self.runtime is not None else 0

    @property
    def poisoned(self) -> bool:
        """True once a CUDA error left the device context unusable."""
        return self.runtime is not None and self.runtime.poisoned

    def defer_close(self, handle) -> None:
        """Close ``handle`` (a spillable batch) when the query ends."""
        self._deferred.append(handle)

    def close_deferred(self) -> None:
        for h in self._deferred:
            h.close()
        self._deferred.clear()

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
    """A device exec.  Every subclass's ``partitions`` is wrapped once, here,
    so each batch it produces passes the ``dispatch`` fault site (the JAX
    package fires it once per jitted call; the port runs eagerly)."""

    is_gpu = True

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        own = cls.__dict__.get("partitions")
        if own is not None:
            cls.partitions = _dispatching(own)


def _dispatching(partitions):
    @functools.wraps(partitions)
    def wrapped(self, ctx):
        return [_fire_each(p) for p in partitions(self, ctx)]
    return wrapped


def _fire_each(part):
    for b in part:
        inject.maybe_fire("dispatch")
        yield b


def prefetch_spillables(handles, depth: int = 1):
    """Drive spillable handles with overlapped unspill: batch i+1's
    rehydration is in flight while the consumer computes on batch i
    (``catalog.prefetch``); the drive loop of the cached scan and the
    shuffle pieces."""
    handles = list(handles)
    if not handles:
        return iter(())
    return handles[0]._catalog.prefetch(handles, depth=depth)


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
                self._cond.wait(_WAIT_SLICE)
            if self._stopped:
                return False
            self._items.append(item)
            self._cond.notify_all()
            return True

    def get(self):
        with self._cond:
            while not self._stopped and not self._items:
                self._cond.wait(_WAIT_SLICE)
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
    device is passed to the worker explicitly.  Each batch is staged under
    the OOM retry (``mem.catalog.run_with_oom_retry``: an allocator OOM
    spills the catalog and stages again).  An exception in the worker
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

        catalog = ctx.catalog

        def stage(hb):
            from spark_rapids_tpu_torch.mem.catalog import run_with_oom_retry
            t0 = time.monotonic()
            db = run_with_oom_retry(catalog,
                                    lambda: host_to_device(hb, device))
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


def _host_form(hb: HostBatch) -> HostBatch:
    """A host batch with its string columns one ``str`` a row."""
    return HostBatch(hb.schema, [
        HostColumn(c.dtype, c.string_values(), c.validity)
        if c.offsets is not None else c for c in hb.columns])


def iter_partitions(root: PhysicalOp, ctx: ExecContext):
    """Every partition of ``root`` driven in turn under the partition
    deadline, a failed one through the fault ladder
    (``recovery.run_partition_with_retry``): yields one list of batches a
    partition, device batches or, where a partition completed on the host,
    host batches.  Once the device context is poisoned, no later
    partition touches the device."""
    from spark_rapids_tpu_torch.fault import recovery
    from spark_rapids_tpu_torch.fault.errors import DeviceLostError
    from spark_rapids_tpu_torch.fault.watchdog import partition_deadline
    with partition_deadline(ctx.conf, "plan-partitions"):
        # eager per-op work (a split, a build side) runs here
        parts = root.partitions(ctx)
    for i, part in enumerate(parts):
        got: List = []
        if ctx.poisoned:
            yield recovery.run_partition_with_retry(
                root, ctx, i, error=DeviceLostError("device context "
                                                    "poisoned"))
            continue
        try:
            with partition_deadline(ctx.conf, f"partition:{i}"):
                for b in part:
                    got.append(b)
        except Exception as e:
            if isinstance(e, MemoryError):
                raise
            del got
            got = recovery.run_partition_with_retry(root, ctx, i, error=e)
        yield got


def _drive_partitions(root: PhysicalOp, ctx: ExecContext) -> List[List]:
    """:func:`iter_partitions` in a list; once the device context is
    poisoned, the partitions that left batches on the device run again on
    the host."""
    from spark_rapids_tpu_torch.fault import recovery
    from spark_rapids_tpu_torch.fault.errors import DeviceLostError
    out = list(iter_partitions(root, ctx))
    if ctx.poisoned:
        out = [recovery.run_partition_with_retry(
            root, ctx, i, error=DeviceLostError("device context poisoned"))
            if any(isinstance(b, ColumnBatch) for b in got) else got
            for i, got in enumerate(out)]
    return out


def _collect_once(op: PhysicalOp, ctx: ExecContext) -> List[HostBatch]:
    """One drive of the plan and the copy of its rows to the host: the
    device batches with one sizes sync and one copy sync for all of
    them."""
    batches = [b for part in _drive_partitions(op, ctx) for b in part]
    dev = [b for b in batches if isinstance(b, ColumnBatch)]
    copied = iter(device_to_host_many(dev) if dev else [])
    return [next(copied) if isinstance(b, ColumnBatch) else _host_form(b)
            for b in batches]


def collect_host(op: PhysicalOp, ctx: ExecContext) -> HostBatch:
    """Drive a plan to completion and concatenate every partition's rows
    on the host (strings one ``str`` a row).  A failure outside any
    partition's ladder (the plan's eager work, the final copy) replays
    the whole collect through the same ladder, with the whole query on the
    host operators as its fallback.  Deferred handles close at the end."""
    from spark_rapids_tpu_torch.fault import recovery
    try:
        try:
            hbs = _collect_once(op, ctx)
        except Exception as e:
            if isinstance(e, MemoryError):
                raise
            hbs = recovery.run_plan_with_recovery(
                ctx, lambda: _collect_once(op, ctx), error=e)
    finally:
        ctx.close_deferred()
    hbs = [hb for hb in hbs if hb.num_rows]
    if not hbs:
        return _empty_host_batch(op.output_schema)
    return HostBatch.concat(hbs)
