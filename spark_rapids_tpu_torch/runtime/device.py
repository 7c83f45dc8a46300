"""Device selection and admission control.

Port of ``spark_rapids_tpu/runtime/device.py``: :class:`DeviceRuntime` holds
the ``torch.device`` a session runs on (CUDA unless the caller asks for the
CPU) and :class:`GpuSemaphore`, a plain counting semaphore that bounds how
many queries hold device memory at once (the GpuSemaphore role).
"""

from __future__ import annotations

import threading

import torch

from spark_rapids_tpu_torch.config import CONCURRENT_TPU_TASKS, RapidsConf


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
    """The device a session runs on and its admission semaphore."""

    def __init__(self, conf: RapidsConf, device=None):
        self.device = resolve_device(device)
        self.semaphore = GpuSemaphore(CONCURRENT_TPU_TASKS.get(conf))
