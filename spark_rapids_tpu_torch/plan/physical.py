"""Physical operator model (port of ``spark_rapids_tpu/plan/physical.py``).

Every physical op exposes ``partitions(ctx) -> List[Iterator[batch]]``, a
list of lazily evaluated per-partition batch iterators.  GPU execs yield
device :class:`ColumnBatch` es on ``ctx.device``; CPU execs yield host
:class:`HostBatch` es.  :class:`HostToDeviceExec` stages host batches onto
the device; :func:`collect_host` drives a device plan and brings the rows
back.  Execution is eager, one partition iterator at a time; the JAX
package's whole-stage fusion (``plan/pipeline.py``) is not ported.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import (
    HostBatch, HostColumn, device_to_host_many, host_to_device,
)
from spark_rapids_tpu_torch.config import RapidsConf


class ExecContext:
    """Per-query execution context: conf, the device to run on, the device
    mesh when one is installed, and the query's metrics (name -> count)."""

    def __init__(self, conf: RapidsConf, device: torch.device,
                 mesh: Optional[List[torch.device]] = None):
        self.conf = conf
        self.device = device
        self.mesh = mesh
        self.metrics: Dict[str, int] = {}

    def add_metric(self, name: str) -> None:
        self.metrics[name] = self.metrics.get(name, 0) + 1

    def mesh_spmd_active(self) -> bool:
        """True when joins between mesh exchanges run fused: a mesh is
        installed (``spark.rapids.shuffle.ici.enabled``).  One gate for
        every fusable exec, so a plan never half-fuses."""
        return self.mesh is not None


class PhysicalOp:
    is_gpu = False

    def __init__(self, children: List["PhysicalOp"], output_schema: T.Schema):
        self.children = list(children)
        self.output_schema = output_schema

    def partitions(self, ctx: ExecContext) -> List[Iterator]:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__

    def tree_string(self, depth: int = 0) -> str:
        out = "  " * depth + self.describe() + "\n"
        for c in self.children:
            out += c.tree_string(depth + 1)
        return out


class GpuExec(PhysicalOp):
    is_gpu = True


class CpuExec(PhysicalOp):
    is_gpu = False


class HostToDeviceExec(GpuExec):
    """Stage host batches onto ``ctx.device``."""

    def __init__(self, child: PhysicalOp):
        super().__init__([child], child.output_schema)

    def describe(self):
        return "HostToDevice"

    def partitions(self, ctx):
        return [(host_to_device(hb, ctx.device) for hb in part)
                for part in self.children[0].partitions(ctx)]


def _empty_host_batch(schema: T.Schema) -> HostBatch:
    return HostBatch(schema, [
        HostColumn(f.dtype, np.zeros(0, dtype=f.dtype.np_dtype),
                   np.zeros(0, dtype=np.bool_)) for f in schema.fields])


def collect_host(op: PhysicalOp, ctx: ExecContext) -> HostBatch:
    """Drive a device plan to completion and concatenate every partition's
    rows on the host (one sizes sync + one copy sync for all batches)."""
    if not op.is_gpu:
        raise TypeError(f"collect_host needs a device plan, got "
                        f"{op.describe()}")
    batches = [b for part in op.partitions(ctx) for b in part]
    hbs = [hb for hb in device_to_host_many(batches) if hb.num_rows]
    if not hbs:
        return _empty_host_batch(op.output_schema)
    return HostBatch.concat(hbs)
