"""Process-wide fault-tolerance counters (port of
``spark_rapids_tpu/fault/metrics.py``): cumulative counters under a lock;
``session.execute`` snapshots them around each query and puts the deltas
into ``last_metrics`` (``retryCount``, ``backoffWallNs``,
``deviceLostCount``, ``partitionFallbackCount``, ``faultsInjected``)."""

from __future__ import annotations

import threading
from typing import Dict

_LOCK = threading.Lock()
_STATS: Dict[str, int] = {
    "retries": 0,              # replays, OOM spill-retries included
    "backoff_wall_ns": 0,      # wall ns slept in retry backoff
    "device_lost": 0,          # DEVICE_LOST-classified errors handled
    "partition_fallbacks": 0,  # partitions completed on the host
    "faults_injected": 0,      # deterministic faults fired (inject.py)
}

#: counter -> its name in ``session.last_metrics``
METRIC_NAMES = {"retries": "retryCount", "backoff_wall_ns": "backoffWallNs",
                "device_lost": "deviceLostCount",
                "partition_fallbacks": "partitionFallbackCount",
                "faults_injected": "faultsInjected"}


def record(key: str, n: int = 1) -> None:
    with _LOCK:
        _STATS[key] += n


def snapshot() -> Dict[str, int]:
    with _LOCK:
        return dict(_STATS)


def delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after}
