"""Planner: lowers a logical plan to device execs (port of
``spark_rapids_tpu/plan/overrides.py``, reduced to the slice's nodes).

The port has no CPU twins of device operators yet, so there is nothing to
fall back to: a node, expression or setting the port cannot run raises
:class:`UnsupportedPlanError` naming the node and the reason.  String
columns pass through every operator; each expression says for itself
whether it takes or returns strings (``Expression.gpu_supported``).  The JAX
package would place such a node on the CPU instead.
"""

from __future__ import annotations

from spark_rapids_tpu_torch.config import (
    EXCHANGE_COLLAPSE_LOCAL, SHUFFLE_PARTITIONS, RapidsConf,
)
from spark_rapids_tpu_torch.exprs.aggregates import AggregateFunction
from spark_rapids_tpu_torch.exprs.base import ColumnRef, Expression
from spark_rapids_tpu_torch.ops import gpu_exec as X
from spark_rapids_tpu_torch.ops.cpu_exec import CpuInMemoryScanExec
from spark_rapids_tpu_torch.parallel.exchange import GpuShuffleExchangeExec
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.physical import HostToDeviceExec, PhysicalOp


class UnsupportedPlanError(NotImplementedError):
    """A plan the port cannot run on the device."""


def _to_device(op: PhysicalOp) -> PhysicalOp:
    return op if op.is_gpu else HostToDeviceExec(op)


class GpuOverrides:
    """Logical plan -> physical plan, every operator on the device."""

    def __init__(self, conf: RapidsConf):
        self.conf = conf

    def apply(self, plan: L.LogicalPlan) -> PhysicalOp:
        return _to_device(self._convert(plan))

    def _refuse(self, node: L.LogicalPlan, reason: str):
        raise UnsupportedPlanError(f"{node.describe()}: {reason}")

    def _check_exprs(self, node: L.LogicalPlan, *exprs: Expression):
        for e in exprs:
            for sub in e.collect(lambda x: True):
                if isinstance(sub, AggregateFunction):
                    self._refuse(node, f"aggregate {sub.name} outside an "
                                       "aggregation")
                reason = sub.gpu_supported(self.conf)
                if reason:
                    self._refuse(node, reason)

    def _exchange(self, node, kind: str, child: PhysicalOp) -> PhysicalOp:
        if not EXCHANGE_COLLAPSE_LOCAL.get(self.conf):
            self._refuse(node, "a partitioned shuffle is not ported yet; "
                               "leave spark.rapids.sql.tpu.exchange."
                               "collapseLocal on")
        return GpuShuffleExchangeExec(kind, SHUFFLE_PARTITIONS.get(self.conf),
                                      child)

    def _convert(self, node: L.LogicalPlan) -> PhysicalOp:
        if isinstance(node, L.InMemoryScan):
            return CpuInMemoryScanExec(node.batches, node.schema,
                                       node.num_partitions)
        if isinstance(node, L.CachedRelation):
            child = None if node.holder.is_materialized else \
                _to_device(self._convert(node.children[0]))
            return X.GpuCachedScanExec(node.holder, child, node.schema)
        if isinstance(node, L.Project):
            self._check_exprs(node, *node.exprs)
            return X.GpuProjectExec(
                node.exprs, _to_device(self._convert(node.children[0])),
                node.schema)
        if isinstance(node, L.Filter):
            self._check_exprs(node, node.condition)
            return X.GpuFilterExec(
                node.condition, _to_device(self._convert(node.children[0])))
        if isinstance(node, L.Aggregate):
            return self._convert_aggregate(node)
        if isinstance(node, L.Sort):
            return self._convert_sort(node)
        self._refuse(node, "no port of this operator yet")

    def _convert_aggregate(self, node: L.Aggregate) -> PhysicalOp:
        if not node.keys:
            self._refuse(node, "aggregation without grouping keys is not "
                               "ported yet")
        self._check_exprs(node, *node.keys)
        for a in node.aggs:
            self._check_exprs(node, a.fn.child)
            reason = a.fn.gpu_supported(self.conf)
            if reason:
                self._refuse(node, f"aggregate {a.fn.name}: {reason}")
        child = _to_device(self._convert(node.children[0]))
        partial = X.GpuHashAggregateExec(
            "update", node.keys, node.key_names, node.aggs, child,
            X._buffer_schema(node.key_names, node.keys, node.aggs))
        keys = [ColumnRef(n, k.dtype, k.nullable)
                for n, k in zip(node.key_names, node.keys)]
        return X.GpuHashAggregateExec(
            "merge", keys, node.key_names, node.aggs,
            self._exchange(node, "hash", partial), node.schema)

    def _convert_sort(self, node: L.Sort) -> PhysicalOp:
        for o in node.orders:
            if not isinstance(o.child, ColumnRef):
                self._refuse(node, "sorting by a computed expression is "
                                   "not ported yet")
        child = _to_device(self._convert(node.children[0]))
        if node.is_global:
            child = self._exchange(node, "range", child)
        return X.GpuSortExec(node.orders, child)
