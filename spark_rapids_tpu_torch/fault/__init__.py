"""Fault tolerance (port of ``spark_rapids_tpu/fault/``).

* :mod:`.errors`: every raised error classifies as ``RETRYABLE_OOM``
  (torch's allocator error, a launch that failed to allocate),
  ``DEVICE_LOST`` (a CUDA error that poisons the context, a partition
  deadline) or ``NON_RETRYABLE`` (everything else, never retried);
* :mod:`.retry`: ONE :class:`RetryPolicy` (``retry.maxAttempts``,
  ``retry.backoffMs``; deterministic exponential backoff) behind every
  retry loop;
* :mod:`.watchdog`: the per-partition deadline
  (``partition.timeoutSec``), raised into the driving thread;
* :mod:`.recovery`: the ladder: spill on OOM, reset the runtime on a
  device loss, replay the partition, and after ``retry.maxAttempts``
  complete just that partition on the host operators
  (``fallback.onDeviceError``);
* :mod:`.inject`: deterministic fault injection (``faults.spec``) at the
  dispatch, h2d, d2h, spill, unspill, exchange and scan sites.

Per-query counters (``retryCount``, ``backoffWallNs``,
``deviceLostCount``, ``partitionFallbackCount``, ``faultsInjected``) go
into ``session.last_metrics`` (:mod:`.metrics`).
"""

from spark_rapids_tpu_torch.fault.errors import (  # noqa: F401
    DeviceLostError, ErrorClass, PartitionTimeout, classify_error,
)
from spark_rapids_tpu_torch.fault.inject import InjectedFault  # noqa: F401
from spark_rapids_tpu_torch.fault.retry import RetryPolicy  # noqa: F401
from spark_rapids_tpu_torch.fault.watchdog import (  # noqa: F401
    partition_deadline,
)
