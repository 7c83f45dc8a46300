"""Error taxonomy: every raised error maps to one retry class (port of
``spark_rapids_tpu/fault/errors.py``).

Where the JAX package reads XLA status codes, the port reads torch's
errors:

* ``torch.OutOfMemoryError`` (``torch.cuda.OutOfMemoryError``), the
  caching allocator's failure, is ``RETRYABLE_OOM``; so is a hand-written
  kernel's launch that returned ``cudaErrorMemoryAllocation``;
* any other error a hand-written kernel's launch returns is
  ``NON_RETRYABLE``, whatever its code: the ladder never moves a failing
  kernel's work to the host;
* a CUDA error that poisons the process's context (an illegal address, a
  device-side assert, an unspecified launch failure, a misaligned address,
  an uncorrectable ECC error, a launch timeout), as torch raises it, is
  ``DEVICE_LOST``;
* everything else is ``NON_RETRYABLE``, as is ``KeyboardInterrupt`` and
  ``SystemExit``.

An error object carrying a ``rapids_error_class`` attribute (the fault
injector's, :class:`PartitionTimeout`, :class:`DeviceLostError`, or one
pinned by :func:`mark_non_retryable`) classifies as exactly that.
"""

from __future__ import annotations

import enum


class ErrorClass(enum.Enum):
    #: an allocation failed: spill and retry is sound
    RETRYABLE_OOM = "retryable_oom"
    #: the device is gone, poisoned or wedged: reset, replay, then the
    #: per-partition host fallback
    DEVICE_LOST = "device_lost"
    #: user errors, kernels that refuse their input or fail to build,
    #: KeyboardInterrupt/SystemExit: never retried
    NON_RETRYABLE = "non_retryable"


class PartitionTimeout(RuntimeError):
    """A partition exceeded ``spark.rapids.sql.tpu.partition.timeoutSec``;
    raised into the driving thread by the watchdog.  A wedged device is
    treated as a lost one."""

    rapids_error_class = ErrorClass.DEVICE_LOST


class DeviceLostError(RuntimeError):
    """Raised by a spillable handle whose device copy did not survive a
    device loss (no host or disk copy existed)."""

    rapids_error_class = ErrorClass.DEVICE_LOST


#: ``cudaErrorMemoryAllocation``
CUDA_ERROR_MEMORY_ALLOCATION = 2
#: the CUDA errors that leave the context unusable, as torch's messages
#: name them
_DEVICE_LOST_FRAGMENTS = ("illegal memory access", "device-side assert",
                          "unspecified launch failure", "misaligned address",
                          "uncorrectable ecc error", "launch timed out")


class KernelLaunchError(RuntimeError):
    """A hand-written kernel's launch returned a CUDA error (``code``)."""

    def __init__(self, kernel: str, code: int):
        super().__init__(f"{kernel} launch failed: CUDA error {code}")
        self.code = int(code)


def classify_error(err: BaseException) -> ErrorClass:
    """Map a raised error to its :class:`ErrorClass`."""
    if not isinstance(err, Exception):
        return ErrorClass.NON_RETRYABLE
    explicit = getattr(err, "rapids_error_class", None)
    if isinstance(explicit, ErrorClass):
        return explicit
    if isinstance(err, KernelLaunchError):
        if err.code == CUDA_ERROR_MEMORY_ALLOCATION:
            return ErrorClass.RETRYABLE_OOM
        return ErrorClass.NON_RETRYABLE
    import torch
    # torch.OutOfMemoryError is a RuntimeError: test it first
    if isinstance(err, torch.OutOfMemoryError):
        return ErrorClass.RETRYABLE_OOM
    accel = getattr(torch, "AcceleratorError", None)
    if isinstance(err, RuntimeError) or \
            (accel is not None and isinstance(err, accel)):
        low = str(err).lower()
        if any(frag in low for frag in _DEVICE_LOST_FRAGMENTS):
            return ErrorClass.DEVICE_LOST
    return ErrorClass.NON_RETRYABLE


def mark_non_retryable(err: Exception) -> Exception:
    """Pin ``err`` to NON_RETRYABLE."""
    try:
        err.rapids_error_class = ErrorClass.NON_RETRYABLE
    except Exception:  # noqa: BLE001 - exceptions with __slots__
        pass
    return err
