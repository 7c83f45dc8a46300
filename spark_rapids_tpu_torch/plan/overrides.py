"""Planner: tags every logical operator for the GPU, lowers the ones that
can run there to device execs and the rest to their host twins, and inserts
the exchanges and the host<->device transitions (port of
``spark_rapids_tpu/plan/overrides.py``, reduced to the ported nodes).

Placement comes from tags and confs only, as in the JAX package
(``ExprMeta``, ``PlanMeta``): an expression the device cannot evaluate
(``Expression.gpu_supported`` names why), an aggregate the device must not
run (a float ``Sum``/``Average`` without
``spark.rapids.sql.variableFloatAgg.enabled``, a string ``Min``/``Max``),
float group keys under ``spark.rapids.sql.hasNans``, string keys with
``spark.rapids.sql.stringHashGroupJoin.enabled`` off, a node or expression
switched off by ``spark.rapids.sql.exec.<Name>`` /
``spark.rapids.sql.expression.<Name>``, or ``spark.rapids.sql.enabled``
false each put the node on the host.  Scans decode on the host by design.
Nothing moves an operator because a GPU is missing or a kernel failed.
:class:`UnsupportedPlanError` is left for what neither side can run: an
aggregate outside an aggregation.

Exchanges carry the JAX package's partitionings
(``parallel/partitioning.py``): an aggregate's and a join's by hash of
their keys (``spark.sql.shuffle.partitions``), a global sort's by range, a
limit's and a keyless aggregate's single; ``DataFrame.repartition`` and
``coalesce`` plan a Repartition node into one.  A device exchange under a
window or a global sort is read through the adaptive coalescing reader
(``GpuCoalescedShuffleReaderExec``); the merge aggregate and the shuffled
join coalesce inline.  Whether an exchange splits is decided when it runs
(``spark.rapids.sql.tpu.exchange.collapseLocal``).  ``Sample`` is a
device or host exec of its own.

Equi-joins on the device choose their strategy as the JAX package does: a
side whose estimated size is under ``spark.sql.autoBroadcastJoinThreshold``
is broadcast (the right one first; the left one for inner and right joins,
when it is the smaller), otherwise both sides go through hash exchanges
into a shuffled hash join.  Estimates measure an in-memory scan's values
exactly and multiply every other node's row estimate by its output
schema's per-column widths; joins and aggregates make no guess.  A file
scan is estimated by its files' bytes on disk.  A residual join condition
rides the hash join, which then runs host-driven; a cross join or a join
without equi-keys is a nested-loop join.  On the host an aggregate, a join,
a window and a limit take a host exchange and the host twin
(``ops/cpu_exec.py``, ``ops/window.py``).  A window goes through a hash
exchange by its partition keys (a single-partition one without them) into
the window exec; an expand is a device or host exec of its own.
``functions.broadcast`` (a BroadcastHint) estimates its side at 0 bytes,
so it is broadcast.  Array columns ride the device only through projects,
filters, generates (explode), scans, unions, limits and cached relations;
any other node over an array column, and an outer explode, runs on the
host.

File scans decode on the host (``io/scan.py`` v1, ``io/scan_v2.py`` v2, the
default).  Filter conjuncts over a file scan are pushed into it (advisory:
the Filter stays) so row groups and partition directories that cannot
match are skipped.  The explain lines say "will run on GPU" or "cannot run
on GPU because ..." a node.
"""

from __future__ import annotations

import copy
import os
from typing import List

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import (
    AUTO_BROADCAST_THRESHOLD, HAS_NANS, SCAN_PUSHDOWN_ENABLED,
    SCAN_V2_ENABLED, SHUFFLE_PARTITIONS, SQL_ENABLED, STRING_HASH_JOIN,
    RapidsConf,
)
from spark_rapids_tpu_torch.exprs.aggregates import AggregateFunction
from spark_rapids_tpu_torch.exprs.base import (
    ColumnRef, Expression, SortOrder, resolve,
)
from spark_rapids_tpu_torch.ops import cpu_exec as C
from spark_rapids_tpu_torch.ops import gpu_exec as X
from spark_rapids_tpu_torch.ops.window import CpuWindowExec, GpuWindowExec
from spark_rapids_tpu_torch.parallel.exchange import (
    CpuShuffleExchangeExec, GpuShuffleExchangeExec,
)
from spark_rapids_tpu_torch.parallel.partitioning import (
    HashPartitioning, Partitioning, RangePartitioning,
    RoundRobinPartitioning, SinglePartitioning,
)
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.physical import (
    DeviceToHostExec, HostToDeviceExec, PhysicalOp,
)


class UnsupportedPlanError(NotImplementedError):
    """A plan neither the device nor the host can run."""


def _gate_off(conf: RapidsConf, key: str) -> bool:
    return conf.get(key, True) in (False, "false")


class ExprMeta:
    """Tags one expression tree: the reasons it cannot run on the GPU."""

    def __init__(self, expr: Expression, conf: RapidsConf):
        self.conf = conf
        self.reasons: List[str] = []
        self._tag(expr)

    def _tag(self, e: Expression):
        if type(e).gpu_eval is Expression.gpu_eval and \
                not isinstance(e, AggregateFunction):
            self.reasons.append(
                f"expression {e.name} has no GPU implementation")
        else:
            reason = e.gpu_supported(self.conf)
            if reason:
                self.reasons.append(
                    f"expression {reason}" if reason.startswith(e.name)
                    else f"expression {e.name}: {reason}")
        key = f"spark.rapids.sql.expression.{e.name}"
        if _gate_off(self.conf, key):
            self.reasons.append(f"expression {e.name} disabled by {key}")
        for c in e.children:
            self._tag(c)


class PlanMeta:
    """Tags one logical operator; ``children`` are its inputs' metas."""

    def __init__(self, node: L.LogicalPlan, conf: RapidsConf):
        self.node = node
        self.conf = conf
        self.reasons: List[str] = []
        self.children = [PlanMeta(c, conf) for c in node.children]

    def will_not_work(self, reason: str):
        if reason not in self.reasons:
            self.reasons.append(reason)

    def check_exprs(self, *exprs: Expression):
        for e in exprs:
            for sub in e.collect(lambda x: isinstance(x, AggregateFunction)):
                raise UnsupportedPlanError(
                    f"{self.node.describe()}: aggregate {sub.name} outside "
                    "an aggregation")
            for r in ExprMeta(e, self.conf).reasons:
                self.will_not_work(r)

    @property
    def can_run_on_gpu(self) -> bool:
        return not self.reasons

    def explain_lines(self, depth: int = 0) -> List[str]:
        ind = "  " * depth
        if self.can_run_on_gpu:
            lines = [f"{ind}*{self.node.name} will run on GPU"]
        else:
            why = "; ".join(self.reasons)
            lines = [f"{ind}!{self.node.name} cannot run on GPU because "
                     f"{why}"]
        for c in self.children:
            lines.extend(c.explain_lines(depth + 1))
        return lines


def _to_device(op: PhysicalOp) -> PhysicalOp:
    return op if op.is_gpu else HostToDeviceExec(op)


def _to_host(op: PhysicalOp) -> PhysicalOp:
    return DeviceToHostExec(op) if op.is_gpu else op


def _insert_transitions(op: PhysicalOp) -> PhysicalOp:
    """Makes every edge type-correct: a device exec reads device batches,
    a host exec host batches (the planner's branches already place the
    transitions; this pass is the invariant)."""
    new_children = []
    for c in op.children:
        c = _insert_transitions(c)
        if op.is_gpu and not c.is_gpu and \
                not isinstance(op, HostToDeviceExec):
            c = HostToDeviceExec(c)
        elif not op.is_gpu and c.is_gpu and \
                not isinstance(op, DeviceToHostExec):
            c = DeviceToHostExec(c)
        new_children.append(c)
    op.children = new_children
    return op


class GpuOverrides:
    """Logical plan -> physical plan with per-operator GPU/host
    placement, exchanges and transitions."""

    def __init__(self, conf: RapidsConf):
        self.conf = conf
        self.last_explain = ""

    def apply(self, plan: L.LogicalPlan) -> PhysicalOp:
        if SCAN_PUSHDOWN_ENABLED.get(self.conf):
            plan = _pushdown_scan_filters(plan)
        meta = PlanMeta(plan, self.conf)
        self.tag(meta)
        self.last_explain = "\n".join(meta.explain_lines())
        return _insert_transitions(self._convert(meta))

    # ------------------------------------------------------------------ tag

    def tag(self, meta: PlanMeta):
        for c in meta.children:
            self.tag(c)
        node, conf = meta.node, self.conf
        if not SQL_ENABLED.get(conf):
            meta.will_not_work("spark.rapids.sql.enabled is false")
            return
        key = f"spark.rapids.sql.exec.{node.name}"
        if _gate_off(conf, key):
            meta.will_not_work(f"disabled by {key}")
        # array columns ride the varlen device layout, but only these
        # nodes take them there (the JAX package's gate, after
        # GpuOverrides.scala's per-operator nested-type checks)
        if not isinstance(node, (L.Project, L.Filter, L.Generate,
                                 L.InMemoryScan, L.FileScan, L.Union,
                                 L.Limit, L.CachedRelation)):
            if any(f.dtype.is_array for c in node.children
                   for f in c.schema.fields):
                meta.will_not_work(
                    "array columns: only project/filter/explode run on GPU")
        if isinstance(node, (L.InMemoryScan, L.FileScan)):
            meta.will_not_work("scans decode host-side (by design)")
        elif isinstance(node, L.Project):
            meta.check_exprs(*node.exprs)
        elif isinstance(node, L.Filter):
            meta.check_exprs(node.condition)
        elif isinstance(node, L.Aggregate):
            meta.check_exprs(*node.keys)
            self._tag_string_keys(meta, node.keys, "group by")
            for a in node.aggs:
                meta.check_exprs(a.fn.child)
                reason = a.fn.gpu_supported(conf)
                if reason:
                    meta.will_not_work(f"aggregate {a.fn.name}: {reason}")
                if any(k.dtype.is_fractional for k in node.keys) and \
                        HAS_NANS.get(conf):
                    meta.will_not_work(
                        "grouping by floating point when NaNs are "
                        "possible; set spark.rapids.sql.hasNans=false to "
                        "enable")
        elif isinstance(node, L.Sort):
            for o in node.orders:
                meta.check_exprs(o.child)
        elif isinstance(node, L.Join):
            meta.check_exprs(*node.left_keys, *node.right_keys)
            self._tag_string_keys(
                meta, list(node.left_keys) + list(node.right_keys), "join")
            if node.condition is not None:
                meta.check_exprs(_paired_resolve(node))
        elif isinstance(node, L.Expand):
            for proj in node.projections:
                meta.check_exprs(*proj)
        elif isinstance(node, L.Window):
            for w in node.window_exprs:
                reason = w.gpu_supported(conf)
                if reason:
                    meta.will_not_work(reason)
        elif isinstance(node, L.Generate):
            if node.outer:
                meta.will_not_work(
                    "explode_outer emits NULL-element rows (host path)")
        elif isinstance(node, L.Repartition):
            meta.check_exprs(*node.keys)

    def _tag_string_keys(self, meta: PlanMeta, keys, what: str):
        """String keys group and join through device row hashes;
        ``stringHashGroupJoin.enabled=false`` puts the node on the host's
        exact path."""
        if any(k.dtype.is_string for k in keys) and \
                not STRING_HASH_JOIN.get(self.conf):
            meta.will_not_work(
                f"string {what} keys use device row hashes; disabled by "
                "spark.rapids.sql.stringHashGroupJoin.enabled")

    # -------------------------------------------------------------- convert

    def _refuse(self, node: L.LogicalPlan, reason: str):
        raise UnsupportedPlanError(f"{node.describe()}: {reason}")

    def _shuffle_parts(self) -> int:
        return SHUFFLE_PARTITIONS.get(self.conf)

    def _exchange(self, part: Partitioning, child: PhysicalOp,
                  reader: bool = False) -> PhysicalOp:
        """A device exchange; ``reader`` reads it through the adaptive
        coalescing reader (under a window and a global sort)."""
        ex = GpuShuffleExchangeExec(part, _to_device(child))
        return X.GpuCoalescedShuffleReaderExec(ex) if reader else ex

    def _host_exchange(self, part: Partitioning,
                       child: PhysicalOp) -> PhysicalOp:
        return CpuShuffleExchangeExec(part, _to_host(child))

    def _make_partitioning(self, node: L.Repartition) -> Partitioning:
        if node.mode == "hash":
            return HashPartitioning(node.keys, node.num_partitions)
        if node.mode == "roundrobin":
            return RoundRobinPartitioning(node.num_partitions)
        if node.mode == "single":
            return SinglePartitioning()
        if node.mode == "range":
            schema = node.children[0].schema
            return RangePartitioning(
                node.orders, [schema.index_of(o.child.column)
                              for o in node.orders], node.num_partitions)
        raise ValueError(node.mode)

    def _convert(self, meta: PlanMeta) -> PhysicalOp:
        node = meta.node
        on_gpu = meta.can_run_on_gpu
        if isinstance(node, L.CachedRelation):
            if not SQL_ENABLED.get(self.conf):
                return self._convert(meta.children[0])  # no device cache
            child = None if node.holder.is_materialized else \
                _to_device(self._convert(meta.children[0]))
            return X.GpuCachedScanExec(node.holder, child, node.schema)
        conv = [self._convert(c) for c in meta.children]
        if isinstance(node, L.BroadcastHint):
            return conv[0]
        if isinstance(node, L.InMemoryScan):
            return C.CpuInMemoryScanExec(node.batches, node.schema,
                                         node.num_partitions)
        if isinstance(node, L.FileScan):
            if SCAN_V2_ENABLED.get(self.conf):
                from spark_rapids_tpu_torch.io.scan_v2 import FileScanV2Exec
                return FileScanV2Exec(node, self.conf)
            from spark_rapids_tpu_torch.io.scan import CpuFileScanExec
            return CpuFileScanExec(node, self.conf)
        if isinstance(node, L.Range):
            cls = X.GpuRangeExec if on_gpu else C.CpuRangeExec
            return cls(node.start, node.end, node.step, node.num_partitions,
                       node.schema)
        if isinstance(node, L.Project):
            if on_gpu:
                return X.GpuProjectExec(node.exprs, _to_device(conv[0]),
                                        node.schema)
            return C.CpuProjectExec(node.exprs, _to_host(conv[0]),
                                    node.schema)
        if isinstance(node, L.Filter):
            if on_gpu:
                return X.GpuFilterExec(node.condition, _to_device(conv[0]))
            return C.CpuFilterExec(node.condition, _to_host(conv[0]))
        if isinstance(node, L.Aggregate):
            return self._convert_aggregate(node, conv[0], on_gpu)
        if isinstance(node, L.Sort):
            return self._convert_sort(node, conv[0], on_gpu)
        if isinstance(node, L.Join):
            return self._convert_join(node, conv, on_gpu)
        if isinstance(node, L.Union):
            if on_gpu and all(c.is_gpu for c in conv):
                return X.GpuUnionExec(conv, node.schema)
            return C.CpuUnionExec([_to_host(c) for c in conv], node.schema)
        if isinstance(node, L.Limit):
            return self._convert_limit(node, conv[0], on_gpu)
        if isinstance(node, L.Expand):
            if on_gpu:
                return X.GpuExpandExec(node.projections, _to_device(conv[0]),
                                       node.schema)
            return C.CpuExpandExec(node.projections, _to_host(conv[0]),
                                   node.schema)
        if isinstance(node, L.Window):
            return self._convert_window(node, conv[0], on_gpu)
        if isinstance(node, L.Generate):
            if on_gpu:
                return X.GpuGenerateExec(node.column, node.alias, node.pos,
                                         _to_device(conv[0]), node.schema)
            return C.CpuGenerateExec(node.column, node.alias, node.pos,
                                     node.outer, _to_host(conv[0]),
                                     node.schema)
        if isinstance(node, L.Sample):
            if on_gpu:
                return X.GpuSampleExec(node.fraction, node.seed,
                                       _to_device(conv[0]))
            return C.CpuSampleExec(node.fraction, node.seed,
                                   _to_host(conv[0]))
        if isinstance(node, L.Repartition):
            part = self._make_partitioning(node)
            if on_gpu:
                return self._exchange(part, conv[0])
            return self._host_exchange(part, conv[0])
        self._refuse(node, "no port of this operator yet")

    def _convert_window(self, node: L.Window, child: PhysicalOp,
                        on_gpu: bool) -> PhysicalOp:
        """An exchange by the partition keys (one partition without
        them), then the window exec over each whole partition."""
        keys = node.window_exprs[0].partition_by
        part = HashPartitioning(keys, self._shuffle_parts()) if keys \
            else SinglePartitioning()
        if on_gpu:
            return GpuWindowExec(
                node.window_exprs, node.output_names,
                self._exchange(part, child, reader=True), node.schema)
        return CpuWindowExec(node.window_exprs, node.output_names,
                             self._host_exchange(part, child), node.schema)

    def _convert_aggregate(self, node: L.Aggregate, child: PhysicalOp,
                           on_gpu: bool) -> PhysicalOp:
        """On the device: update per batch, an exchange (hash by the keys;
        one partition without keys), then the merge.  On the host: the
        rows through a host exchange, then the whole aggregation."""
        if not on_gpu:
            part = HashPartitioning(node.keys, self._shuffle_parts()) \
                if node.keys else SinglePartitioning()
            return C.CpuAggregateExec(
                node.keys, node.aggs, self._host_exchange(part, child),
                node.schema)
        partial = X.GpuHashAggregateExec(
            "update", node.keys, node.key_names, node.aggs,
            _to_device(child),
            X._buffer_schema(node.key_names, node.keys, node.aggs))
        keys = [ColumnRef(n, k.dtype, k.nullable)
                for n, k in zip(node.key_names, node.keys)]
        part = HashPartitioning(keys, self._shuffle_parts()) if keys \
            else SinglePartitioning()
        return X.GpuHashAggregateExec(
            "merge", keys, node.key_names, node.aggs,
            self._exchange(part, partial), node.schema)

    def _convert_sort(self, node: L.Sort, child: PhysicalOp,
                      on_gpu: bool) -> PhysicalOp:
        """Sort keys that are not plain columns are projected into hidden
        ``__sortkey_i`` columns, sorted on, and projected away, as the JAX
        package plans them."""
        if all(isinstance(o.child, ColumnRef) for o in node.orders):
            return self._sort(node, node.orders, child, on_gpu)
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
        if on_gpu:
            proj = X.GpuProjectExec(base + extra, _to_device(child),
                                    T.Schema(fields))
            return X.GpuProjectExec(
                base, self._sort(node, orders, proj, True), schema)
        proj = C.CpuProjectExec(base + extra, _to_host(child),
                                T.Schema(fields))
        return C.CpuProjectExec(
            base, self._sort(node, orders, proj, False), schema)

    def _sort(self, node: L.Sort, orders, child: PhysicalOp,
              on_gpu: bool) -> PhysicalOp:
        schema = child.output_schema
        ordinals = [schema.index_of(o.child.column) for o in orders]
        if on_gpu:
            child = _to_device(child)
            if node.is_global:
                child = self._exchange(
                    RangePartitioning(orders, ordinals,
                                      self._shuffle_parts()),
                    child, reader=True)
            return X.GpuSortExec(orders, child)
        if node.is_global:
            child = self._host_exchange(
                RangePartitioning(orders, ordinals, self._shuffle_parts()),
                child)
        return C.CpuSortExec(orders, ordinals, _to_host(child))

    # Heuristic average payload of a string cell when the values are not
    # visible (the JAX package's _VARLEN_CELL_BYTES).
    _VARLEN_CELL_BYTES = 24

    def _field_width(self, f) -> int:
        """Estimated bytes per row of one column as the device holds it:
        data item size plus a validity byte; a string or an array a 4-byte
        offset, a validity byte and the heuristic payload."""
        if f.dtype.is_string or f.dtype.is_array:
            return 5 + self._VARLEN_CELL_BYTES
        return int(np.dtype(f.dtype.np_dtype).itemsize) + 1

    def _estimate_rows(self, node: L.LogicalPlan):
        """Plan-output row estimate; None where the node changes the
        cardinality in a way that is not guessed (aggregates, joins)."""
        if isinstance(node, L.InMemoryScan):
            return sum(hb.num_rows for hb in node.batches)
        if isinstance(node, L.Range):
            return max(0, -(-(node.end - node.start) // node.step))
        if isinstance(node, L.Limit):
            rows = self._estimate_rows(node.children[0])
            return node.n if rows is None else min(node.n, rows)
        if isinstance(node, L.Sample):
            rows = self._estimate_rows(node.children[0])
            return None if rows is None else int(rows * node.fraction)
        if isinstance(node, (L.Project, L.Filter, L.Sort,
                             L.CachedRelation, L.BroadcastHint)):
            return self._estimate_rows(node.children[0])
        return None

    def _estimate_size(self, node: L.LogicalPlan):
        """Plan-output byte estimate for the broadcast decision: an
        in-memory scan is measured (a string cell counts its characters
        plus 5 bytes, an array cell its elements' bytes plus 5), any other
        estimable node is its row estimate times its own output schema's
        column widths; a broadcast hint is 0."""
        if isinstance(node, L.BroadcastHint):
            return 0
        if isinstance(node, L.InMemoryScan):
            total = 0
            for hb in node.batches:
                for f, c in zip(hb.schema.fields, hb.columns):
                    if f.dtype.is_string:
                        total += _string_chars(c.string_values()) + \
                            5 * len(c)
                    elif f.dtype.is_array:
                        ew = int(np.dtype(
                            f.dtype.element.np_dtype).itemsize)
                        total += ew * sum(len(x) for x in c.values) + \
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

    def _convert_join(self, node: L.Join, conv: List[PhysicalOp],
                      on_gpu: bool) -> PhysicalOp:
        cond = None if node.condition is None else _paired_resolve(node)
        left, right = conv
        nested = node.how == "cross" or not node.left_keys
        n_parts = self._shuffle_parts()
        lpart = HashPartitioning(node.left_keys, n_parts)
        rpart = HashPartitioning(node.right_keys, n_parts)
        if not on_gpu:
            if nested:
                return C.CpuNestedLoopJoinExec(
                    _to_host(left), _to_host(right), node.how, cond,
                    node.schema)
            return C.CpuHashJoinExec(
                self._host_exchange(lpart, left),
                self._host_exchange(rpart, right), node.left_keys,
                node.right_keys, node.how, cond, node.schema)
        left, right = _to_device(left), _to_device(right)
        if nested:
            return X.GpuNestedLoopJoinExec(left, right, node.how, cond,
                                           node.schema)
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
                "right", cond, node.schema)
        if bc_side == "left":
            return X.GpuBroadcastHashJoinExec(
                right, left, node.left_keys, node.right_keys, node.how,
                "left", cond, node.schema)
        lex, rex = self._exchange(lpart, left), self._exchange(rpart, right)
        # the split compares these with the bytes it moved
        # (aqeEstimateErrorPct)
        if l_est is not None:
            lex._aqe_est_bytes = l_est
        if r_est is not None:
            rex._aqe_est_bytes = r_est
        return X.GpuShuffledHashJoinExec(
            lex, rex, node.left_keys, node.right_keys, node.how, cond,
            node.schema)

    def _convert_limit(self, node: L.Limit, child: PhysicalOp,
                       on_gpu: bool) -> PhysicalOp:
        if on_gpu:
            local = X.GpuLocalLimitExec(node.n, _to_device(child))
            return X.GpuLocalLimitExec(
                node.n, self._exchange(SinglePartitioning(), local))
        local = C.CpuLocalLimitExec(node.n, _to_host(child))
        return C.CpuLocalLimitExec(
            node.n, self._host_exchange(SinglePartitioning(), local))


def _paired_resolve(node: L.Join) -> Expression:
    """A join's residual condition resolved against both sides' columns
    (the left ones first), so each expression can say whether the port
    runs it; its column references stay by name."""
    left, right = node.children
    return resolve(node.condition, T.Schema(list(left.schema.fields) +
                                            list(right.schema.fields)))


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
