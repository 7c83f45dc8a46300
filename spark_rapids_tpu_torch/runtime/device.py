"""Device selection, admission control and the spill catalog.

Port of ``spark_rapids_tpu/runtime/device.py``: :class:`DeviceRuntime` holds
the ``torch.device`` a session runs on (CUDA unless the caller asks for the
CPU), :class:`GpuSemaphore`, a plain counting semaphore that bounds how
many queries hold device memory at once (the GpuSemaphore role), and the
spill catalog (:mod:`spark_rapids_tpu_torch.mem.catalog`).

The runtime is one per session, where the JAX package keeps one per
process: a session's spill budget is its own conf's, whatever sessions
came before.  ``spark.rapids.memory.tpu.allocFraction`` caps the CUDA
caching allocator on the session's device
(``torch.cuda.set_per_process_memory_fraction``), the nearest analogue of
XLA's pool fraction; the cap is the process's for that device, so the
last session made sets it.
"""

from __future__ import annotations

import threading

import torch

from spark_rapids_tpu_torch.config import (
    CONCURRENT_TPU_TASKS, DEVICE_POOL_FRACTION, RapidsConf,
)


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; without CUDA that raises
    instead of falling back to the CPU, which must be asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    return dev


class GpuSemaphore:
    """Admission semaphore: ``with sem:`` around a query's device phase."""

    def __init__(self, permits: int):
        self._sem = threading.BoundedSemaphore(max(1, permits))

    def __enter__(self):
        self._sem.acquire()
        return self

    def __exit__(self, *exc):
        self._sem.release()
        return False


class DeviceRuntime:
    """The device a session runs on, its admission semaphore and its spill
    catalog.  ``generation`` counts device-lost recoveries: state built
    from device buffers (a shuffle split's pieces, a broadcast build)
    records the generation it was made under and is rebuilt after a
    recovery.  ``poisoned`` is set when a CUDA error left the context
    unusable: from then on nothing of the session touches the device."""

    def __init__(self, conf: RapidsConf, device=None):
        from spark_rapids_tpu_torch.mem.catalog import BufferCatalog
        self.conf = conf
        self.device = resolve_device(device)
        self.semaphore = GpuSemaphore(CONCURRENT_TPU_TASKS.get(conf))
        self.catalog = BufferCatalog(conf)
        self.generation = 0
        self.poisoned = False
        self._lock = threading.Lock()
        if self.device.type == "cuda":
            torch.cuda.set_per_process_memory_fraction(
                float(DEVICE_POOL_FRACTION.get(conf)), self.device)

    def recover(self, rescue: bool = True) -> "DeviceRuntime":
        """Device-lost recovery: a new generation and a fresh semaphore (a
        permit wedged by the dead attempt cannot block the replay), the
        SAME catalog with its device tier invalidated outside the lock
        (rescued to host when ``rescue`` and the context is sound, else
        marked lost), so host and disk copies survive."""
        with self._lock:
            self.generation += 1
            self.semaphore = GpuSemaphore(
                CONCURRENT_TPU_TASKS.get(self.conf))
        self.catalog.invalidate_device_tier(
            rescue=rescue, touch_device=not self.poisoned)
        return self
