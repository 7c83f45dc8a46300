"""GpuSparkSession: the user entry point (port of the part of
``spark_rapids_tpu/session.py`` the slice needs).

A session runs on CUDA unless built with ``device="cpu"``; without a CUDA
device and without that request it raises at construction.  With
``spark.rapids.shuffle.ici.enabled`` it installs a device mesh of every
visible device, one included (the JAX package only from two devices up;
see :mod:`spark_rapids_tpu_torch.parallel.mesh_shuffle`).
"""

from __future__ import annotations

from typing import Optional

from spark_rapids_tpu_torch.batch import HostBatch
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.runtime.device import DeviceRuntime


class GpuSparkSession:
    def __init__(self, conf: Optional[RapidsConf] = None, device=None):
        self.conf = conf or RapidsConf()
        self.runtime = DeviceRuntime(self.conf, device)
        self.last_physical_plan = None
        self.last_metrics = {}

    @property
    def device(self):
        return self.runtime.device

    def create_dataframe(self, data, num_partitions: int = 1):
        """DataFrame over a pydict ``{name: (dtype, values)}`` (values a
        list with None for NULL, or a dense numpy array) or a HostBatch."""
        from spark_rapids_tpu_torch.dataframe import DataFrame
        from spark_rapids_tpu_torch.plan.logical import InMemoryScan
        batch = data if isinstance(data, HostBatch) else \
            HostBatch.from_pydict(data)
        return DataFrame(InMemoryScan([batch], batch.schema, num_partitions),
                         self)

    def plan_physical(self, plan):
        from spark_rapids_tpu_torch.plan.overrides import GpuOverrides
        return GpuOverrides(self.conf).apply(plan)

    def _shuffle_mesh(self):
        """The device mesh exchanges run over, or None: opt-in through
        spark.rapids.shuffle.ici.enabled, built once per session.  A mesh
        of more than one device raises: its all-to-all is not ported."""
        from spark_rapids_tpu_torch.config import ENABLE_ICI_SHUFFLE
        if not ENABLE_ICI_SHUFFLE.get(self.conf):
            return None
        if not hasattr(self, "_mesh"):
            from spark_rapids_tpu_torch.parallel.mesh_shuffle import (
                make_mesh,
            )
            self._mesh = make_mesh(self.device)
        if len(self._mesh) > 1:
            raise NotImplementedError(
                f"a mesh of {len(self._mesh)} devices needs the exchange's "
                "all-to-all, which is not ported yet")
        return self._mesh

    def execute(self, plan) -> HostBatch:
        from spark_rapids_tpu_torch.plan.physical import (
            ExecContext, collect_host,
        )
        phys = self.plan_physical(plan)
        self.last_physical_plan = phys
        ctx = ExecContext(self.conf, self.device, self._shuffle_mesh())
        with self.runtime.semaphore:
            out = collect_host(phys, ctx)
        self.last_metrics = ctx.metrics
        return out
