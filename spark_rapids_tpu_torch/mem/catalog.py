"""Spillable-batch catalog with device -> host -> disk tiers (port of
``spark_rapids_tpu/mem/catalog.py``).

Reference analogues: RapidsBufferCatalog (the id -> buffer registry and
the spill chain), RapidsBufferStore (priority-ordered spillables and the
synchronous spill), the device, host and disk stores, and
SpillableColumnarBatch (the operator's handle).

The catalog enforces a *budget*: an operator that holds batches across a
pipeline break registers them as :class:`SpillableBatch` handles; when
the registered device bytes pass ``spark.rapids.memory.tpu.spillBudgetBytes``
the lowest-priority handles are copied to host memory, and past
``spark.rapids.memory.host.spillStorageSize`` serialized to disk
(:mod:`.serialize`, :mod:`.codec`).  The budget counts registered handles
only: a handle's device bytes are the summed sizes of its buffers.

Spills are asynchronous (``spill.async.enabled``): ``reserve()`` picks
victims and moves them DEVICE -> SPILLING under the lock, and a bounded
writer pool (``spill.writer.threads``) does the copies.  A ``get()`` that
races a spill not yet started cancels it; one that races a started spill
joins that handle's completion.  On CUDA a writer copies on the catalog's
own stream, after waiting on an event recorded on the producer's stream
when the batch was registered, into pinned host memory; it marks the
buffers as used on its stream (``record_stream``) and drops them only
after its copy has completed.  An unspill stages through the port's
pinned, non-blocking ``host_to_device`` on the calling thread's stream,
which is the consumer's.

A real allocator OOM (``torch.OutOfMemoryError``) reaches
:meth:`BufferCatalog.handle_alloc_failure` through
:func:`run_with_oom_retry` or the partition ladder: every spillable
handle is spilled, and the budget drops to half the bytes that were
resident when it struck, so a replay does not climb back to the same
peak (the JAX package, whose OOMs were injected, keeps its budget).  The
lowered budget lasts for the query: :meth:`BufferCatalog.query_budget`
puts the budget back when the query ends.

Fault interplay: ``spill:*`` injections fire on the writer thread and the
error surfaces at the consumer's next ``get()`` (the handle reverts to the
device tier, so a replay succeeds); ``unspill:*`` fires on the
rehydration path.  ``invalidate_device_tier`` drains or abandons the
spills in flight before it rescues.

Not ported: ``register_sharded`` (multi-device, ROADMAP item 8) and
``verify_encoded_host_batches`` (the dictionary corridor, item 6).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
import weakref
from collections import deque
from contextlib import contextmanager
from typing import Deque, Dict, Iterator, List, Optional, Sequence

import torch

from spark_rapids_tpu_torch.batch import (
    ColumnBatch, HostBatch, device_to_host_many, host_batch_bytes,
    host_to_device,
)
from spark_rapids_tpu_torch.config import (
    DEVICE_SPILL_BUDGET, HOST_SPILL_STORAGE_SIZE, SHUFFLE_COMPRESSION_CODEC,
    SPILL_ASYNC_ENABLED, SPILL_CHUNK_BYTES, SPILL_WRITER_THREADS,
    RapidsConf,
)

# Spill priority bands (SpillPriorities.scala).
PRIORITY_INPUT = 0
PRIORITY_SHUFFLE_OUTPUT = -1000
PRIORITY_ON_DECK = 1000
# The cross-query fragment cache and the result cache (ROADMAP item 10)
# will register at these: the most spillable bands.
PRIORITY_FRAGMENT = -2000
PRIORITY_RESULT = -3000

#: Bounded wait slice (seconds) of every blocking loop here: a notify
#: still wakes at once; the bound lets the watchdog's exception land.
_WAIT_SLICE = 0.25
#: A writer thread idle this long exits; the next spill starts another.
_WRITER_IDLE_S = 2.0


def batch_tensors(batch: ColumnBatch) -> List[torch.Tensor]:
    """Every buffer of a device batch, its row count included."""
    out = [batch.num_rows]
    for c in batch.columns:
        out.append(c.data)
        out.append(c.validity)
        if c.offsets is not None:
            out.append(c.offsets)
    return out


def device_batch_bytes(batch: ColumnBatch) -> int:
    """The bytes of a batch's buffers: data, validity (a byte a row) and
    offsets, as the JAX package counts them (the row count left out)."""
    total = 0
    for c in batch.columns:
        total += c.data.numel() * c.data.element_size()
        total += c.validity.numel() * c.validity.element_size()
        if c.offsets is not None:
            total += c.offsets.numel() * c.offsets.element_size()
    return total


def _sizes_unallocated(batch: ColumnBatch):
    """``host_sizes`` of one batch read scalar by scalar (``.item()``), so
    no device tensor is made."""
    return (int(batch.num_rows.item()),
            [int(c.offsets[-1].item()) for c in batch.columns
             if c.is_varlen])


class _SpillTask:
    """One tier move in flight; ``state`` is guarded by the catalog's lock
    (queued -> running -> done, or queued -> cancelled)."""

    __slots__ = ("handle", "bytes", "state", "error", "_done")

    QUEUED, RUNNING, DONE, CANCELLED = "queued", "running", "done", \
        "cancelled"

    def __init__(self, handle: "SpillableBatch"):
        self.handle = handle
        self.bytes = handle.device_bytes
        self.state = self.QUEUED
        self.error: Optional[BaseException] = None
        self._done = threading.Event()

    def mark_done(self) -> None:
        self._done.set()

    def wait_done(self) -> None:
        while not self._done.wait(_WAIT_SLICE):
            pass


class SpillableBatch:
    """Operator-facing handle for a batch that may move between tiers::

        DEVICE --begin spill--> SPILLING --writer D2H--> HOST --> DISK
          ^                        |                      |        |
          |<---cancel (get race)---+      get() unspill --+--------+
          |
        LOST (device loss with no surviving copy; get() raises classified)
    """

    TIER_DEVICE, TIER_HOST, TIER_DISK, TIER_LOST, TIER_SPILLING = \
        0, 1, 2, 3, 4

    def __init__(self, catalog: "BufferCatalog", batch_id: int,
                 device_batch: ColumnBatch, priority: int):
        self._catalog = catalog
        self.batch_id = batch_id
        self.priority = priority
        self.tier = self.TIER_DEVICE
        self._device: Optional[ColumnBatch] = device_batch
        self._host: Optional[HostBatch] = None
        self._disk_path: Optional[str] = None
        self._schema = device_batch.schema
        self._capacity = device_batch.capacity
        self.device = device_batch.device
        self.device_bytes = device_batch_bytes(device_batch)
        #: a batch with no columns has no host form for its row count and
        #: nothing to free: it stays on the device
        self.spillable = bool(device_batch.columns)
        #: the producer's stream position: a writer's copy waits on it
        self._ready = None
        if self.device.type == "cuda":
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(self.device))
        #: host bytes, computed ONCE when the host copy materializes
        self._host_nbytes = 0
        self._spill_task: Optional[_SpillTask] = None
        #: a writer-thread failure awaiting the consumer's next get()
        self._pending_error: Optional[BaseException] = None
        self.closed = False

    # -- disk frames (catalog-internal) -------------------------------------

    def _write_disk(self, host: HostBatch, directory: str) -> int:
        """Serialize + chunk-compress ``host`` into the disk tier; the
        encoded bytes written.  Pure IO: the caller owns the tiers."""
        from spark_rapids_tpu_torch.mem.codec import get_codec, write_chunked
        from spark_rapids_tpu_torch.mem.serialize import serialize_host_batch
        codec = get_codec(self._catalog.spill_codec)
        raw = serialize_host_batch(host)
        path = os.path.join(directory, f"spill-{self.batch_id}.tpub")
        with open(path, "wb") as f:
            enc = write_chunked(f, raw, codec,
                                self._catalog.spill_chunk_bytes)
        self._disk_path = path
        return enc

    def _read_disk(self) -> HostBatch:
        from spark_rapids_tpu_torch.mem.codec import get_codec, read_chunked
        from spark_rapids_tpu_torch.mem.serialize import (
            deserialize_host_batch,
        )
        codec = get_codec(self._catalog.spill_codec)
        with open(self._disk_path, "rb") as f:
            raw = read_chunked(f, codec)
        return deserialize_host_batch(raw, self._schema)

    def host_bytes(self) -> int:
        return self._host_nbytes if self._host is not None else 0

    # -- public -------------------------------------------------------------

    def get(self) -> ColumnBatch:
        """The batch on the device (joining a spill in flight and/or
        unspilling as needed)."""
        if self.closed:
            raise ValueError(f"spillable batch {self.batch_id} is closed")
        cat = self._catalog
        while True:
            with cat._lock:
                err = self._pending_error
                if err is not None:
                    # a writer's spill failed: surface it ONCE (the handle
                    # already reverted, so the ladder's replay succeeds)
                    self._pending_error = None
                    raise err
                tier = self.tier
                if tier == self.TIER_LOST:
                    from spark_rapids_tpu_torch.fault.errors import (
                        DeviceLostError,
                    )
                    raise DeviceLostError(
                        f"spillable batch {self.batch_id} was on the device "
                        "when the device was lost and no host or disk copy "
                        "survived; its lineage must be recomputed")
                if tier == self.TIER_DEVICE:
                    return self._device
                task = self._spill_task
                if tier == self.TIER_SPILLING and task is not None \
                        and task.state == _SpillTask.QUEUED:
                    # won the race against an unstarted spill
                    cat._cancel_spill_locked(self, task)
                    dev = self._device
                    cancelled = True
                else:
                    cancelled = False
                if tier in (self.TIER_HOST, self.TIER_DISK):
                    break
            if cancelled:
                # the pressure that picked this handle is still there:
                # land it on a victim the consumer is not about to read
                cat.reserve(0, exclude=self.batch_id)
                return dev
            if task is not None:
                task.wait_done()
        return self._unspill(tier)

    def _unspill(self, tier: int) -> ColumnBatch:
        """Rehydrate from host or disk: IO off the lock, tiers and counters
        under it."""
        from spark_rapids_tpu_torch.fault import inject
        cat = self._catalog
        inject.maybe_fire("unspill")
        host = self._read_disk() if tier == self.TIER_DISK else self._host
        with cat._lock:
            raced = self.tier != tier
            if not raced:
                # device-resident BEFORE reserving, so the budget loop
                # cannot pick this handle mid-rehydration; the host copy
                # stays until the upload lands so a failure can revert
                if tier == self.TIER_HOST:
                    cat._host_bytes -= self._host_nbytes
                self.tier = self.TIER_DEVICE
                cat._device_bytes += self.device_bytes
                cat.metrics["unspilled"] += 1
        if raced:
            return self.get()
        try:
            cat.reserve(self.device_bytes, exclude=self.batch_id)
            dev = host_to_device(host, self.device, capacity=self._capacity)
        except BaseException:
            with cat._lock:
                if self.tier == self.TIER_DEVICE and self._device is None:
                    self.tier = tier
                    cat._device_bytes -= self.device_bytes
                    cat.metrics["unspilled"] -= 1
                    if tier == self.TIER_HOST:
                        cat._host_bytes += self._host_nbytes
            raise
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        with cat._lock:
            self._device = dev
            self._ready = ready
            self._host = None
            self._host_nbytes = 0
        if tier == self.TIER_DISK and self._disk_path:
            if os.path.exists(self._disk_path):
                os.unlink(self._disk_path)
            self._disk_path = None
        return dev

    def close(self):
        cat = self._catalog
        with cat._lock:
            if self.closed:
                return
            self.closed = True
            task = self._spill_task
            if task is not None and task.state == _SpillTask.QUEUED:
                cat._cancel_spill_locked(self, task)
            # a RUNNING task finishes on the writer; its finalize sees
            # ``closed`` and drops the copy
            if self.tier == self.TIER_DEVICE:
                cat._device_bytes -= self.device_bytes
            elif self.tier == self.TIER_HOST:
                cat._host_bytes -= self._host_nbytes
            if self.tier == self.TIER_LOST and self._device is not None:
                cat._graveyard.append(self._device)
            self._device = None
            self._host = None
            self._host_nbytes = 0
            path = self._disk_path
            self._disk_path = None
            cat._handles.pop(self.batch_id, None)
        if path and os.path.exists(path):
            os.unlink(path)


def _remove_dir(path_box: list) -> None:
    if path_box[0]:
        shutil.rmtree(path_box[0], ignore_errors=True)


class BufferCatalog:
    """A registry of spillable batches with a device budget; one per
    :class:`~spark_rapids_tpu_torch.runtime.device.DeviceRuntime`."""

    def __init__(self, conf: RapidsConf):
        self.conf = conf
        self.device_budget = DEVICE_SPILL_BUDGET.get(conf)
        self.host_budget = HOST_SPILL_STORAGE_SIZE.get(conf)
        self.spill_codec = SHUFFLE_COMPRESSION_CODEC.get(conf) or "copy"
        self.async_spill = SPILL_ASYNC_ENABLED.get(conf)
        self.writer_threads = max(1, SPILL_WRITER_THREADS.get(conf))
        self.spill_chunk_bytes = SPILL_CHUNK_BYTES.get(conf)
        self._handles: Dict[int, SpillableBatch] = {}
        self._next_id = 0
        self._lock = threading.RLock()
        # the spill directory, made at the first disk spill and removed
        # with the catalog
        self._spill_dir: List[Optional[str]] = [None]
        weakref.finalize(self, _remove_dir, self._spill_dir)
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}
        #: device batches of handles lost with a poisoned CUDA context:
        #: kept, never freed, since freeing one may call into that context
        self._graveyard: List[ColumnBatch] = []
        # running per-tier byte counters (verify_accounting == scan)
        self._device_bytes = 0
        self._host_bytes = 0
        self._queue: Deque[_SpillTask] = deque()
        self._queue_cond = threading.Condition(self._lock)
        self._writers: List[threading.Thread] = []
        self.metrics = {"spilled_to_host": 0, "spilled_to_disk": 0,
                        "unspilled": 0, "spill_cancelled": 0,
                        "spill_wall_ns": 0, "spill_queue_depth_max": 0,
                        "unspill_prefetch_hits": 0,
                        "spill_to_host_bytes": 0, "spill_to_disk_bytes": 0,
                        "oom_spill_bytes": 0}

    def _dir(self) -> str:
        with self._lock:
            if self._spill_dir[0] is None:
                self._spill_dir[0] = tempfile.mkdtemp(
                    prefix="rapids_torch_spill_")
            return self._spill_dir[0]

    @property
    def spill_dir(self) -> Optional[str]:
        """The directory the disk tier writes to, once a spill made it."""
        return self._spill_dir[0]

    # -- registry -----------------------------------------------------------

    def register(self, batch: ColumnBatch,
                 priority: int = PRIORITY_INPUT) -> SpillableBatch:
        with self._lock:
            h = SpillableBatch(self, self._next_id, batch, priority)
            self._next_id += 1
            self._handles[h.batch_id] = h
            self._device_bytes += h.device_bytes
        # budget enforcement outside the registry mutation
        self.reserve(0, exclude=h.batch_id)
        return h

    # -- accounting ---------------------------------------------------------

    def device_bytes_in_use(self) -> int:
        with self._lock:
            return self._device_bytes

    def host_bytes_in_use(self) -> int:
        with self._lock:
            return self._host_bytes

    def tier_bytes(self) -> Dict[str, int]:
        """Bytes resident per tier now: the device and host counters and
        the spill files' sizes."""
        with self._lock:
            disk = 0
            for h in self._handles.values():
                path = h._disk_path
                if path:
                    try:
                        disk += os.path.getsize(path)
                    except OSError:
                        continue
            return {"device": self._device_bytes,
                    "host": self._host_bytes, "disk": disk}

    def tier_counts(self) -> Dict[str, int]:
        """Open handles per tier now."""
        names = {SpillableBatch.TIER_DEVICE: "device",
                 SpillableBatch.TIER_HOST: "host",
                 SpillableBatch.TIER_DISK: "disk",
                 SpillableBatch.TIER_LOST: "lost",
                 SpillableBatch.TIER_SPILLING: "spilling"}
        out = dict.fromkeys(names.values(), 0)
        with self._lock:
            for h in self._handles.values():
                out[names[h.tier]] += 1
        return out

    def verify_accounting(self) -> List[str]:
        """The incremental counters must equal a full scan at any
        lock-quiesced instant."""
        with self._lock:
            dev = sum(h.device_bytes for h in self._handles.values()
                      if h.tier == SpillableBatch.TIER_DEVICE)
            host = sum(h._host_nbytes for h in self._handles.values()
                       if h.tier == SpillableBatch.TIER_HOST)
            problems = []
            if dev != self._device_bytes:
                problems.append(
                    f"catalog device-bytes counter {self._device_bytes} != "
                    f"scan {dev}")
            if host != self._host_bytes:
                problems.append(
                    f"catalog host-bytes counter {self._host_bytes} != "
                    f"scan {host}")
            return problems

    # -- the copies ---------------------------------------------------------

    def _stream(self, device: torch.device) -> "torch.cuda.Stream":
        with self._lock:
            s = self._streams.get(device)
            if s is None:
                s = self._streams[device] = torch.cuda.Stream(device)
            return s

    def _to_host(self, h: SpillableBatch, dev: ColumnBatch) -> HostBatch:
        """The device batch's copy on the host: on CUDA on the catalog's
        stream, after the producer's event, into pinned memory, complete
        when this returns.  It allocates no device memory (the sizes are
        read one scalar at a time), so a spill answering an OOM cannot
        run out itself."""
        if h.device.type != "cuda":
            return device_to_host_many([dev], keep_offsets=True)[0]
        stream = self._stream(h.device)
        with torch.cuda.device(h.device), torch.cuda.stream(stream):
            if h._ready is not None:
                stream.wait_event(h._ready)
            for t in batch_tensors(dev):
                t.record_stream(stream)
            # device_to_host_many synchronizes the current stream, ours
            return device_to_host_many([dev], keep_offsets=True,
                                       sizes=[_sizes_unallocated(dev)])[0]

    # -- spill state machine ------------------------------------------------

    def _begin_spill_locked(self, victim: SpillableBatch) -> _SpillTask:
        """DEVICE -> SPILLING under the lock: the victim's bytes leave the
        device counter now, the task carries the work."""
        task = _SpillTask(victim)
        victim._spill_task = task
        victim.tier = SpillableBatch.TIER_SPILLING
        self._device_bytes -= victim.device_bytes
        self.metrics["spilled_to_host"] += 1
        return task

    def _cancel_spill_locked(self, h: SpillableBatch,
                             task: _SpillTask) -> None:
        """SPILLING -> DEVICE for a task still queued."""
        task.state = _SpillTask.CANCELLED
        task.mark_done()
        h._spill_task = None
        h.tier = SpillableBatch.TIER_DEVICE
        self._device_bytes += h.device_bytes
        self.metrics["spilled_to_host"] -= 1
        self.metrics["spill_cancelled"] += 1

    def _submit(self, task: _SpillTask) -> None:
        with self._lock:
            self._ensure_writers_locked()
            self._queue.append(task)
            depth = len(self._queue)
            if depth > self.metrics["spill_queue_depth_max"]:
                self.metrics["spill_queue_depth_max"] = depth
            self._queue_cond.notify()

    def _ensure_writers_locked(self) -> None:
        self._writers = [t for t in self._writers if t.is_alive()]
        while len(self._writers) < self.writer_threads:
            t = threading.Thread(target=self._writer_loop, daemon=True,
                                 name=f"spill-writer-{len(self._writers)}")
            self._writers.append(t)
            t.start()

    def _writer_loop(self) -> None:
        me = threading.current_thread()
        while True:
            with self._queue_cond:
                idle_since = time.monotonic()
                while not self._queue:
                    if time.monotonic() - idle_since > _WRITER_IDLE_S:
                        self._writers = [t for t in self._writers
                                         if t is not me]
                        return
                    self._queue_cond.wait(_WAIT_SLICE)
                task = self._queue.popleft()
            self._run_spill_task(task)

    def _run_spill_task(self, task: _SpillTask,
                        raise_errors: bool = False) -> None:
        """One device->host spill: the copy off the lock, the finalize
        under it, then host-budget enforcement (also off the lock).

        ``raise_errors`` (synchronous mode, or the OOM path): a failure
        reverts the handle and propagates to the caller.  Otherwise the
        error waits on the handle for the consumer's next ``get()``."""
        h = task.handle
        t0 = time.monotonic_ns()
        with self._lock:
            if task.state != _SpillTask.QUEUED:
                return  # cancelled while queued
            task.state = _SpillTask.RUNNING
            dev = h._device
        try:
            from spark_rapids_tpu_torch.fault import inject
            inject.maybe_fire("spill")
            host = self._to_host(h, dev)
            del dev
            nbytes = host_batch_bytes(host)
            with self._lock:
                live = h._spill_task is task and \
                    h.tier == SpillableBatch.TIER_SPILLING and not h.closed
                if live:
                    h._host = host
                    h._host_nbytes = nbytes
                    h._device = None
                    h._ready = None
                    h.tier = SpillableBatch.TIER_HOST
                    self._host_bytes += nbytes
                    self.metrics["spill_to_host_bytes"] += nbytes
                    h._pending_error = None
                # else: aborted (invalidate/close) mid-copy: drop the copy
        except BaseException as e:
            with self._lock:
                if h._spill_task is task and \
                        h.tier == SpillableBatch.TIER_SPILLING:
                    # the device copy is untouched: revert, so a replay
                    # after the surfaced error succeeds bit-identically
                    h.tier = SpillableBatch.TIER_DEVICE
                    self._device_bytes += h.device_bytes
                    self.metrics["spilled_to_host"] -= 1
                    if not raise_errors:
                        h._pending_error = e
                task.error = e
            if raise_errors or not isinstance(e, Exception):
                raise
            return
        finally:
            with self._lock:
                if h._spill_task is task:
                    h._spill_task = None
                task.state = _SpillTask.DONE
                self.metrics["spill_wall_ns"] += time.monotonic_ns() - t0
            task.mark_done()
        self._enforce_host_budget(raise_errors=raise_errors)

    # -- budget enforcement -------------------------------------------------

    def reserve(self, incoming_bytes: int, exclude: int = -1):
        """Spill until (in use + incoming) fits the budget.  Victims are
        picked and moved to SPILLING under the lock; the copy runs on the
        writer pool (async) or inline off the lock (sync)."""
        while True:
            with self._lock:
                if self._device_bytes + incoming_bytes <= self.device_budget:
                    return
                victim = self._pick_victim(
                    SpillableBatch.TIER_DEVICE, exclude)
                if victim is None:
                    return
                task = self._begin_spill_locked(victim)
            if self.async_spill:
                self._submit(task)
            else:
                self._run_spill_task(task, raise_errors=True)

    def _enforce_host_budget(self, raise_errors: bool = False):
        """Push host-tier handles to disk until the host store fits; the
        serialize + compress + write run outside the lock."""
        while True:
            with self._lock:
                if self._host_bytes <= self.host_budget:
                    return
                victim = self._pick_victim(SpillableBatch.TIER_HOST, -1)
                if victim is None:
                    return
                task = _SpillTask(victim)
                task.state = _SpillTask.RUNNING
                victim._spill_task = task
                victim.tier = SpillableBatch.TIER_SPILLING
                self._host_bytes -= victim._host_nbytes
                host = victim._host
            t0 = time.monotonic_ns()
            try:
                enc = victim._write_disk(host, self._dir())
                with self._lock:
                    if victim.closed:
                        path = victim._disk_path
                        victim._disk_path = None
                    else:
                        path = None
                        victim._host = None
                        victim._host_nbytes = 0
                        victim.tier = SpillableBatch.TIER_DISK
                        victim._pending_error = None
                        self.metrics["spilled_to_disk"] += 1
                        self.metrics["spill_to_disk_bytes"] += enc
                if path and os.path.exists(path):
                    os.unlink(path)
            except BaseException as e:
                with self._lock:
                    if victim._spill_task is task and \
                            victim.tier == SpillableBatch.TIER_SPILLING:
                        victim.tier = SpillableBatch.TIER_HOST
                        self._host_bytes += victim._host_nbytes
                        if not raise_errors:
                            victim._pending_error = e
                    task.error = e
                    task.state = _SpillTask.DONE
                    if victim._spill_task is task:
                        victim._spill_task = None
                task.mark_done()
                if raise_errors or not isinstance(e, Exception):
                    raise
                return
            with self._lock:
                task.state = _SpillTask.DONE
                if victim._spill_task is task:
                    victim._spill_task = None
                self.metrics["spill_wall_ns"] += time.monotonic_ns() - t0
            task.mark_done()

    def drain_spills(self) -> None:
        """Join every spill in flight, then run host-budget enforcement
        (a writer clears its task before it pushes to disk)."""
        while True:
            with self._lock:
                tasks = [h._spill_task for h in self._handles.values()
                         if h._spill_task is not None]
            if not tasks:
                self._enforce_host_budget()
                with self._lock:
                    tasks = [h._spill_task for h in self._handles.values()
                             if h._spill_task is not None]
                if not tasks:
                    return
            for t in tasks:
                t.wait_done()

    # -- OOM / device-loss entry points -------------------------------------

    @contextmanager
    def query_budget(self):
        """Scope one query: a budget an allocator OOM lowered inside it
        is put back when it ends, so the next query runs at the
        configured budget."""
        budget = self.device_budget
        try:
            yield
        finally:
            with self._lock:
                self.device_budget = budget

    def handle_alloc_failure(self, pinned=(), error=None) -> int:
        """Spill ALL device-tier spillables; the bytes freed.

        The DeviceMemoryEventHandler role: the port catches torch's
        allocator error where it retries (:func:`run_with_oom_retry`, the
        partition ladder) and calls this.  Always eager: every spill, and
        every spill already in flight, completes before this returns, off
        the catalog lock.  When ``error`` is a real ``torch.OutOfMemoryError``
        the budget drops to half the registered bytes resident when it
        struck, until the query's :meth:`query_budget` scope ends.

        ``pinned`` holds batches the retrying work still references:
        spilling them would free nothing (the caller's reference keeps
        the buffers) and a later ``get()`` would make a second device
        copy.  A handle that shares a buffer with one is skipped; buffers
        are matched by storage (``untyped_storage().data_ptr()``).
        """
        pinned_ptrs = {t.untyped_storage().data_ptr()
                       for b in pinned for t in batch_tensors(b)}
        freed = 0
        mine: List[_SpillTask] = []
        inflight: List[_SpillTask] = []
        with self._lock:
            if isinstance(error, torch.OutOfMemoryError) and \
                    self._device_bytes:
                self.device_budget = min(self.device_budget,
                                         self._device_bytes // 2)
                self.metrics["oom_budget_bytes"] = self.device_budget
            victims = sorted(
                (h for h in self._handles.values()
                 if h.tier == SpillableBatch.TIER_DEVICE and not h.closed
                 and h.spillable and h._device is not None
                 and not any(t.untyped_storage().data_ptr() in pinned_ptrs
                             for t in batch_tensors(h._device))),
                key=lambda h: (h.priority, h.batch_id))
            for victim in victims:
                freed += victim.device_bytes
                mine.append(self._begin_spill_locked(victim))
            for h in self._handles.values():
                t = h._spill_task
                if t is not None and t not in mine:
                    inflight.append(t)
        for task in mine:
            self._run_spill_task(task, raise_errors=True)
        for task in inflight:
            # a spill the writer already owns frees memory too once joined
            task.wait_done()
            if task.error is None and task.state == _SpillTask.DONE:
                freed += task.bytes
        if mine or inflight:
            self._enforce_host_budget(raise_errors=True)
        if freed:
            with self._lock:
                self.metrics["oom_spill_bytes"] += freed
        return freed

    def invalidate_device_tier(self, rescue: bool = True,
                               touch_device: bool = True) -> int:
        """Device-lost recovery: every device-tier handle is rescued to
        host when its buffers still answer, else marked LOST (a later
        ``get()`` raises a classified DeviceLostError, so the consumer's
        replay recomputes it).  ``rescue=False`` (a timeout: the device is
        wedged) marks them lost without a copy.  ``touch_device=False`` (a
        poisoned CUDA context) also keeps the lost buffers unfreed, since
        freeing may call into the context.  Host and disk handles are
        untouched.  Spills in flight are drained or abandoned first.
        Returns the handles that moved."""
        rescue = rescue and touch_device
        running: List[_SpillTask] = []
        with self._lock:
            for h in list(self._handles.values()):
                t = h._spill_task
                if t is None or h.closed:
                    continue
                if t.state == _SpillTask.QUEUED:
                    self._cancel_spill_locked(h, t)
                elif t.state == _SpillTask.RUNNING:
                    running.append(t)
        if rescue:
            for t in running:
                t.wait_done()
        moved = 0
        with self._lock:
            for h in list(self._handles.values()):
                if h.closed or h.tier not in (SpillableBatch.TIER_DEVICE,
                                              SpillableBatch.TIER_SPILLING):
                    continue
                was_spilling = h.tier == SpillableBatch.TIER_SPILLING
                moved += 1
                if rescue and not was_spilling and h.spillable:
                    try:
                        host = self._to_host(h, h._device)
                        h._host = host
                        h._host_nbytes = host_batch_bytes(host)
                        h._device = None
                        h._ready = None
                        h.tier = SpillableBatch.TIER_HOST
                        self._device_bytes -= h.device_bytes
                        self._host_bytes += h._host_nbytes
                        self.metrics["spilled_to_host"] += 1
                        continue
                    except Exception:  # noqa: BLE001 - buffers truly gone
                        pass
                if not was_spilling:
                    self._device_bytes -= h.device_bytes
                if not touch_device and h._device is not None:
                    self._graveyard.append(h._device)
                h._device = None
                h._host = None
                h._host_nbytes = 0
                h._spill_task = None
                h.tier = SpillableBatch.TIER_LOST
                self.metrics["lost_batches"] = \
                    self.metrics.get("lost_batches", 0) + 1
            if moved:
                self.metrics["device_invalidated"] = \
                    self.metrics.get("device_invalidated", 0) + moved
        if moved:
            self._enforce_host_budget()
        return moved

    # -- overlapped unspill --------------------------------------------------

    def prefetch(self, handles: Sequence[SpillableBatch],
                 depth: int = 1) -> Iterator[ColumnBatch]:
        """Yield each handle's device batch with up to ``depth`` unspills
        ahead of the consumer: handle i+1's disk read, decompress and
        non-blocking upload are enqueued before batch i is handed on.
        ``get()``'s reserve() bounds the device bytes."""
        handles = list(handles)
        if not handles:
            return
        depth = max(1, depth)

        def _fetch(h: SpillableBatch) -> ColumnBatch:
            if h.tier != SpillableBatch.TIER_DEVICE:
                with self._lock:
                    self.metrics["unspill_prefetch_hits"] += 1
            return h.get()

        window: Deque[ColumnBatch] = deque()
        nxt = 0
        while nxt < len(handles) and len(window) < depth:
            window.append(_fetch(handles[nxt]))
            nxt += 1
        while window:
            cur = window.popleft()
            if nxt < len(handles):
                window.append(_fetch(handles[nxt]))
                nxt += 1
            yield cur

    # -- victim selection ----------------------------------------------------

    def _pick_victim(self, tier: int, exclude: int
                     ) -> Optional[SpillableBatch]:
        best = None
        for h in self._handles.values():
            if h.tier != tier or h.batch_id == exclude or h.closed or \
                    not h.spillable:
                continue
            if tier == SpillableBatch.TIER_DEVICE and h._device is None:
                continue  # mid-rehydration (get() marked it early)
            if h._pending_error is not None:
                # reverted after a failed writer spill: re-picking it
                # before a get() consumed the error would livelock
                continue
            if best is None or h.priority < best.priority or \
                    (h.priority == best.priority and
                     h.batch_id < best.batch_id):
                best = h
        return best


def is_device_oom(err: BaseException) -> bool:
    """True when ``err`` is a device allocation failure: it classifies
    RETRYABLE_OOM (torch's allocator error, an allocation failure at a
    kernel launch, an injected OOM)."""
    from spark_rapids_tpu_torch.fault.errors import (
        ErrorClass, classify_error,
    )
    return classify_error(err) is ErrorClass.RETRYABLE_OOM


def run_with_oom_retry(catalog: BufferCatalog, thunk,
                       retries: Optional[int] = None,
                       pinned=(), on_retry=None):
    """Run ``thunk`` and, on a device OOM, spill everything spillable and
    run it again (the alloc-failure -> synchronous spill -> retry loop of
    the reference's DeviceMemoryEventHandler and withRetry).

    The error must classify RETRYABLE_OOM; the attempts come from the
    retry policy (``retry.maxAttempts``) unless ``retries`` overrides it
    (0 = fail fast).  No backoff: the spill already completed.  Gives up
    when a spill frees nothing.  ``pinned``: batches the thunk reads again
    on a retry (:meth:`BufferCatalog.handle_alloc_failure`).
    """
    from spark_rapids_tpu_torch.fault import metrics as fault_metrics
    from spark_rapids_tpu_torch.fault.retry import RetryPolicy
    max_attempts = RetryPolicy.from_conf(catalog.conf).max_attempts \
        if retries is None else retries + 1
    attempt = 0
    while True:
        attempt += 1
        try:
            return thunk()
        except Exception as e:  # noqa: BLE001 - filtered by classification
            if not is_device_oom(e) or attempt >= max_attempts:
                raise
            freed = catalog.handle_alloc_failure(pinned=pinned, error=e)
            if freed == 0:
                raise
            if on_retry is not None:
                on_retry(freed)
            fault_metrics.record("retries")
