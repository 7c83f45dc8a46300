"""Shuffle exchange, one-device branch only (port of the collapse-local
path of ``spark_rapids_tpu/parallel/exchange.py``).

On one device a partitioning only constrains placement, which one partition
trivially satisfies, so the exchange hands every input batch on in a single
logical partition: no partition ids, no split, no host sync.  The planner
refuses a plan with ``spark.rapids.sql.tpu.exchange.collapseLocal`` off,
since the real split is not ported yet.
"""

from __future__ import annotations

import itertools

from spark_rapids_tpu_torch.plan.physical import GpuExec, PhysicalOp


class GpuShuffleExchangeExec(GpuExec):
    """``kind`` is "hash" or "range"; ``num_partitions`` what the plan
    asked for (shown by :meth:`describe`, collapsed to one at run time)."""

    def __init__(self, kind: str, num_partitions: int, child: PhysicalOp):
        super().__init__([child], child.output_schema)
        self.kind = kind
        self.requested_partitions = num_partitions

    def describe(self):
        return (f"GpuShuffleExchange({self.kind}, "
                f"{self.requested_partitions} -> 1)")

    def partitions(self, ctx):
        return [itertools.chain.from_iterable(
            self.children[0].partitions(ctx))]
