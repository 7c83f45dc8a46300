"""The engine's single retry policy (port of
``spark_rapids_tpu/fault/retry.py``).

One :class:`RetryPolicy` (max attempts + exponential backoff) stands
behind every retry loop: the OOM spill-retry
(``mem.catalog.run_with_oom_retry``) and the partition replay
(``fault.recovery``).  Delays are a pure function of the attempt index
(``backoffMs * 2^(attempt-1)``), no jitter, so a faulted run replays
identically.
"""

from __future__ import annotations

import time

from spark_rapids_tpu_torch.fault import metrics as fault_metrics


class RetryPolicy:
    """``max_attempts`` counts TOTAL attempts, the first included;
    ``delay_s(attempt)`` is the sleep after the 1-based attempt failed."""

    def __init__(self, max_attempts: int, backoff_ms: float):
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_ms = max(0.0, float(backoff_ms))

    @classmethod
    def from_conf(cls, conf) -> "RetryPolicy":
        from spark_rapids_tpu_torch.config import (
            RETRY_BACKOFF_MS, RETRY_MAX_ATTEMPTS,
        )
        return cls(RETRY_MAX_ATTEMPTS.get(conf), RETRY_BACKOFF_MS.get(conf))

    def delay_s(self, attempt: int) -> float:
        return self.backoff_ms * (2 ** max(0, attempt - 1)) / 1000.0

    def backoff(self, attempt: int) -> None:
        """Sleep the attempt's delay, adding the wall to
        ``backoffWallNs``."""
        d = self.delay_s(attempt)
        if d <= 0:
            return
        t0 = time.monotonic_ns()
        time.sleep(d)
        fault_metrics.record("backoff_wall_ns", time.monotonic_ns() - t0)

    def __repr__(self):
        return (f"RetryPolicy(max_attempts={self.max_attempts}, "
                f"backoff_ms={self.backoff_ms})")
