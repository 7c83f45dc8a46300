"""Host operators (port of the in-memory scan of
``spark_rapids_tpu/ops/cpu_exec.py``; the port has no CPU twins of device
operators)."""

from __future__ import annotations

from typing import List

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import HostBatch
from spark_rapids_tpu_torch.plan.physical import CpuExec


class CpuInMemoryScanExec(CpuExec):
    """Hands out host batches, dealt round-robin over the partitions."""

    def __init__(self, batches: List[HostBatch], schema: T.Schema,
                 num_partitions: int):
        super().__init__([], schema)
        self.batches = batches
        self._n = max(1, num_partitions)

    def partitions(self, ctx):
        parts: List[List[HostBatch]] = [[] for _ in range(self._n)]
        for i, b in enumerate(self.batches):
            parts[i % self._n].append(b)
        return [iter(p) for p in parts]
