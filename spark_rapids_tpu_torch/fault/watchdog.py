"""Per-partition deadline watchdog (port of
``spark_rapids_tpu/fault/watchdog.py``).

A deadline armed around each driven partition
(``spark.rapids.sql.tpu.partition.timeoutSec``; 0 = off): a monitor thread
waits with the timeout and, on expiry, raises a classified
:class:`~spark_rapids_tpu_torch.fault.errors.PartitionTimeout` INTO the
driving thread through ``PyThreadState_SetAsyncExc``.  The exception then
takes the partition loop's except/finally paths (read-ahead workers
stopped) into the recovery ladder as a DEVICE_LOST-class error.

An asynchronous exception lands between Python bytecodes.  A thread
blocked inside one C call sees it only when the call returns: a CUDA
synchronization (``.tolist()``, ``synchronize()``) on a wedged kernel
delivers it after the sync ends, if it ends.  Every blocking wait of the
port's own (the catalog's, the read-ahead channel's, the injected slow
stall) waits in slices of at most 0.25 s so the exception can land.
"""

from __future__ import annotations

import ctypes
import threading

from spark_rapids_tpu_torch.fault.errors import PartitionTimeout


def _async_raise(tid: int, exc_class) -> None:
    ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(tid), ctypes.py_object(exc_class))


def _async_revoke(tid: int) -> None:
    ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_ulong(tid), None)


class partition_deadline:
    """Context manager arming a deadline for the current thread:
    ``partition_deadline(conf, label)`` reads ``partition.timeoutSec``,
    ``partition_deadline(seconds, label)`` takes it explicitly; <= 0
    disarms.  ``exc_type`` overrides the raised class."""

    def __init__(self, conf_or_secs, label: str = "partition",
                 exc_type=PartitionTimeout):
        if isinstance(conf_or_secs, (int, float)):
            self.timeout = float(conf_or_secs)
        else:
            from spark_rapids_tpu_torch.config import PARTITION_TIMEOUT_SEC
            self.timeout = float(PARTITION_TIMEOUT_SEC.get(conf_or_secs))
        self.label = label
        self.exc_type = exc_type
        self.fired = False
        self._thread = None

    def __enter__(self):
        if self.timeout <= 0:
            return self
        self._tid = threading.get_ident()
        self._cancel = threading.Event()
        self._lock = threading.Lock()
        self._done = False
        self._thread = threading.Thread(
            target=self._watch, daemon=True,
            name=f"partition-deadline:{self.label}")
        self._thread.start()
        return self

    def _watch(self):
        if self._cancel.wait(self.timeout):
            return
        with self._lock:
            if self._done:
                return
            self.fired = True
            _async_raise(self._tid, self.exc_type)

    def __exit__(self, exc_type, exc, tb):
        if self._thread is None:
            return False
        with self._lock:
            self._done = True
        self._cancel.set()
        self._thread.join(timeout=1.0)
        if self.fired:
            if exc_type is None:
                # fired between the body's last bytecode and here: the
                # exception is pending but undelivered; revoke it and
                # raise now, so it can neither be lost nor land later
                _async_revoke(self._tid)
                raise self.exc_type(
                    f"{self.label} exceeded partition.timeoutSec="
                    f"{self.timeout:g}s")
            if exc_type is not self.exc_type:
                # the body raised its own error as the deadline expired:
                # revoke the pending one; the body's error wins
                _async_revoke(self._tid)
        return False
