"""Shuffle exchange, one-device branches only (port of the collapse-local
path of ``spark_rapids_tpu/parallel/exchange.py`` and of the mesh
all-to-all over one shard).

On one device a partitioning only constrains placement, which one partition
trivially satisfies, so the exchange hands every input batch on in a single
logical partition: no partition ids, no split, no host sync.  That holds
for the hash exchange under an aggregate or a join, the range exchange
under a global sort and the single-partition exchange under a limit.  Under
a one-device mesh (``spark.rapids.shuffle.ici.enabled``) the exchange is the
all-to-all over one shard, which also hands its input on unchanged; a join
whose two children are mesh exchanges then runs fused
(``ops/gpu_exec.py``).  The planner refuses a plan with
``spark.rapids.sql.tpu.exchange.collapseLocal`` off, and the session a
mesh of more than one device: the real split is not ported yet.
"""

from __future__ import annotations

import itertools

from spark_rapids_tpu_torch.plan.physical import GpuExec, PhysicalOp

#: exchange kinds: the JAX package's partitioning class of each
PARTITIONINGS = {"hash": "HashPartitioning", "range": "RangePartitioning",
                 "single": "SinglePartitioning"}


class GpuShuffleExchangeExec(GpuExec):
    """``kind`` is "hash", "range" or "single"; ``num_partitions`` what
    the plan asked for (shown by :meth:`describe`, collapsed to one at run
    time)."""

    def __init__(self, kind: str, num_partitions: int, child: PhysicalOp):
        if kind not in PARTITIONINGS:
            raise ValueError(f"unknown exchange kind {kind!r}")
        super().__init__([child], child.output_schema)
        self.kind = kind
        self.requested_partitions = num_partitions

    def describe(self):
        return (f"GpuShuffleExchange({self.kind}, "
                f"{self.requested_partitions} -> 1)")

    def partitions(self, ctx):
        return [itertools.chain.from_iterable(
            self.children[0].partitions(ctx))]
