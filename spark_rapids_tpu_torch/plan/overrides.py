"""Planner: lowers a logical plan to device execs (port of
``spark_rapids_tpu/plan/overrides.py``, reduced to the ported nodes).

The port has no CPU twins of device operators yet, so there is nothing to
fall back to: a node, expression or setting the port cannot run raises
:class:`UnsupportedPlanError` naming the node and the reason.  String
columns pass through every operator; each expression says for itself
whether it takes or returns strings (``Expression.gpu_supported``).  The JAX
package would place such a node on the CPU instead.

Equi-joins choose their strategy as the JAX package does: a side whose
estimated size is under ``spark.sql.autoBroadcastJoinThreshold`` is
broadcast (the right one first; the left one for inner and right joins,
when it is the smaller), otherwise both sides go through hash exchanges
into a shuffled hash join.  Estimates measure an in-memory scan's values
exactly and multiply every other node's row estimate by its output
schema's per-column widths; joins and aggregates make no guess.  A file
scan is estimated by its files' bytes on disk.

File scans decode on the host (``io/scan.py`` v1, ``io/scan_v2.py`` v2, the
default) and the planner stages their batches onto the device above them.
Filter conjuncts over a file scan are pushed into it (advisory: the
Filter stays) so row groups and partition directories that cannot match
are skipped.
"""

from __future__ import annotations

import copy
import os
from typing import List

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import (
    AUTO_BROADCAST_THRESHOLD, EXCHANGE_COLLAPSE_LOCAL, HAS_NANS,
    SCAN_PUSHDOWN_ENABLED, SCAN_V2_ENABLED, SHUFFLE_PARTITIONS, RapidsConf,
)
from spark_rapids_tpu_torch.exprs.aggregates import AggregateFunction
from spark_rapids_tpu_torch.exprs.base import ColumnRef, Expression, SortOrder
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
        if SCAN_PUSHDOWN_ENABLED.get(self.conf):
            plan = _pushdown_scan_filters(plan)
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
        n = 1 if kind == "single" else SHUFFLE_PARTITIONS.get(self.conf)
        return GpuShuffleExchangeExec(kind, n, child)

    def _convert(self, node: L.LogicalPlan) -> PhysicalOp:
        if isinstance(node, L.InMemoryScan):
            return CpuInMemoryScanExec(node.batches, node.schema,
                                       node.num_partitions)
        if isinstance(node, L.FileScan):
            if SCAN_V2_ENABLED.get(self.conf):
                from spark_rapids_tpu_torch.io.scan_v2 import FileScanV2Exec
                return FileScanV2Exec(node, self.conf)
            from spark_rapids_tpu_torch.io.scan import CpuFileScanExec
            return CpuFileScanExec(node, self.conf)
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
        if isinstance(node, L.Join):
            return self._convert_join(node)
        if isinstance(node, L.Limit):
            return self._convert_limit(node)
        self._refuse(node, "no port of this operator yet")

    def _convert_aggregate(self, node: L.Aggregate) -> PhysicalOp:
        """Update per batch, an exchange (hash by the keys; one partition
        for an aggregation without keys), then the merge."""
        self._check_exprs(node, *node.keys)
        if any(k.dtype.is_fractional for k in node.keys) and \
                HAS_NANS.get(self.conf):
            self._refuse(node, "grouping by a float when NaNs are possible "
                               "runs on the CPU, whose fallback is not "
                               "ported yet; set spark.rapids.sql.hasNans="
                               "false")
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
            self._exchange(node, "hash" if node.keys else "single", partial),
            node.schema)

    def _convert_sort(self, node: L.Sort) -> PhysicalOp:
        for o in node.orders:
            self._check_exprs(node, o.child)
        child = _to_device(self._convert(node.children[0]))
        if any(not isinstance(o.child, ColumnRef) for o in node.orders):
            return self._sort_computed(node, child)
        return self._sort(node, node.orders, child)

    def _sort_computed(self, node: L.Sort, child: PhysicalOp) -> PhysicalOp:
        """Sort keys that are not plain columns are projected into hidden
        ``__sortkey_i`` columns, sorted on, and projected away, as the JAX
        package plans them."""
        schema = node.schema
        base = [ColumnRef(f.name, f.dtype, f.nullable) for f in schema]
        extra, fields, orders = [], list(schema.fields), []
        for i, o in enumerate(node.orders):
            if isinstance(o.child, ColumnRef):
                orders.append(o)
                continue
            nm = f"__sortkey_{i}"
            extra.append(o.child)
            fields.append(T.Field(nm, o.child.dtype, o.child.nullable))
            orders.append(SortOrder(
                ColumnRef(nm, o.child.dtype, o.child.nullable),
                o.ascending, o.nulls_first))
        proj = X.GpuProjectExec(base + extra, child, T.Schema(fields))
        return X.GpuProjectExec(base, self._sort(node, orders, proj), schema)

    def _sort(self, node: L.Sort, orders, child: PhysicalOp) -> PhysicalOp:
        if node.is_global:
            child = self._exchange(node, "range", child)
        return X.GpuSortExec(orders, child)

    # Heuristic average payload of a string cell when the values are not
    # visible (the JAX package's _VARLEN_CELL_BYTES).
    _VARLEN_CELL_BYTES = 24

    def _field_width(self, f) -> int:
        """Estimated bytes per row of one column as the device holds it:
        data item size plus a validity byte; a string a 4-byte offset, a
        validity byte and the heuristic payload."""
        if f.dtype.is_string:
            return 5 + self._VARLEN_CELL_BYTES
        return int(np.dtype(f.dtype.np_dtype).itemsize) + 1

    def _estimate_rows(self, node: L.LogicalPlan):
        """Plan-output row estimate; None where the node changes the
        cardinality in a way that is not guessed (aggregates, joins)."""
        if isinstance(node, L.InMemoryScan):
            return sum(hb.num_rows for hb in node.batches)
        if isinstance(node, L.Limit):
            rows = self._estimate_rows(node.children[0])
            return node.n if rows is None else min(node.n, rows)
        if isinstance(node, (L.Project, L.Filter, L.Sort,
                             L.CachedRelation)):
            return self._estimate_rows(node.children[0])
        return None

    def _estimate_size(self, node: L.LogicalPlan):
        """Plan-output byte estimate for the broadcast decision: an
        in-memory scan is measured (a string cell counts its characters
        plus 5 bytes), any other estimable node is its row estimate times
        its own output schema's column widths."""
        if isinstance(node, L.InMemoryScan):
            total = 0
            for hb in node.batches:
                for f, c in zip(hb.schema.fields, hb.columns):
                    if f.dtype.is_string:
                        total += _string_chars(c.string_values()) + \
                            5 * len(c)
                    else:
                        total += c.values.nbytes + len(c.values)
            return total
        if isinstance(node, L.FileScan):
            try:
                return sum(os.path.getsize(p) for p in node.paths)
            except OSError:
                return None
        rows = self._estimate_rows(node)
        if rows is None or not node.schema.fields:
            return None
        return rows * sum(self._field_width(f) for f in node.schema.fields)

    def _convert_join(self, node: L.Join) -> PhysicalOp:
        if node.how == "cross" or not node.left_keys:
            self._refuse(node, "nested-loop and cross joins are not ported "
                               "yet")
        if node.condition is not None:
            self._refuse(node, "a residual join condition is not ported yet")
        self._check_exprs(node, *node.left_keys, *node.right_keys)
        left = _to_device(self._convert(node.children[0]))
        right = _to_device(self._convert(node.children[1]))
        threshold = AUTO_BROADCAST_THRESHOLD.get(self.conf)
        l_est = self._estimate_size(node.children[0])
        r_est = self._estimate_size(node.children[1])
        bc_side = None
        if node.how in ("inner", "left", "left_semi", "left_anti") and \
                r_est is not None and r_est <= threshold:
            bc_side = "right"
        if node.how in ("inner", "right") and l_est is not None and \
                l_est <= threshold and (
                    bc_side is None or (r_est is None or l_est < r_est)):
            bc_side = "left"
        if bc_side == "right":
            return X.GpuBroadcastHashJoinExec(
                left, right, node.left_keys, node.right_keys, node.how,
                "right", node.schema)
        if bc_side == "left":
            return X.GpuBroadcastHashJoinExec(
                right, left, node.left_keys, node.right_keys, node.how,
                "left", node.schema)
        return X.GpuShuffledHashJoinExec(
            self._exchange(node, "hash", left),
            self._exchange(node, "hash", right), node.left_keys,
            node.right_keys, node.how, node.schema)

    def _convert_limit(self, node: L.Limit) -> PhysicalOp:
        local = X.GpuLocalLimitExec(
            node.n, _to_device(self._convert(node.children[0])))
        return X.GpuLocalLimitExec(node.n,
                                   self._exchange(node, "single", local))


def _split_conjuncts(e: Expression) -> List[Expression]:
    from spark_rapids_tpu_torch.exprs.predicates import And
    if isinstance(e, And):
        return _split_conjuncts(e.children[0]) + \
            _split_conjuncts(e.children[1])
    return [e]


def _pushdown_scan_filters(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Push Filter conjuncts into a child FileScan so the reader can skip
    row groups on statistics and prune partition directories (the
    GpuParquetScan.scala:217-281 filterBlocks role).  Advisory: the Filter
    stays in place for exact row filtering.  Non-mutating: untouched
    subtrees return the original nodes, and the user's plan never
    changes."""
    from spark_rapids_tpu_torch.io.scan import extract_pushdown_descriptors
    new_children = [_pushdown_scan_filters(c) for c in plan.children]
    changed = any(n is not o for n, o in zip(new_children, plan.children))
    if isinstance(plan, L.Filter) and \
            isinstance(new_children[0], L.FileScan):
        scan = new_children[0]
        pushable = [c for c in _split_conjuncts(plan.condition)
                    if extract_pushdown_descriptors([c])]
        if pushable:
            return L.Filter(plan.condition, L.FileScan(
                scan.fmt, scan.paths, scan.schema, scan.options,
                pushed_filters=pushable, partitions=scan.partitions))
    if not changed:
        return plan
    clone = copy.copy(plan)
    clone.children = tuple(new_children)
    return clone


def _string_chars(values) -> int:
    """Characters in a host string column's values (numpy str arrays
    counted by numpy; object arrays row by row)."""
    if values.dtype.kind == "U":
        return int(np.char.str_len(values).sum()) if len(values) else 0
    return sum(len(str(x)) for x in values if x is not None)
