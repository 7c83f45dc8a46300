"""The v1 file scan: multi-threaded host decode of parquet, orc and csv
into HostBatches (port of ``spark_rapids_tpu/io/scan.py``; the
GpuParquetScan.scala:68 structure: host-side footer and filter work, then
decode on a shared read-ahead thread pool).

Predicate pushdown: planner-pushed conjuncts become (column, op, literal)
descriptors; parquet row groups whose min/max statistics prove that no row
can match are skipped before any decode, ORC stripes by a probe of their
predicate columns, and partition-column predicates prune whole files.
Pushdown is advisory: the Filter above the scan still runs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import HostBatch, HostColumn, string_column
from spark_rapids_tpu_torch.config import (
    CSV_ENABLED, MULTITHREADED_READ_THREADS, PARQUET_ENABLED,
    READER_BATCH_SIZE_ROWS, SHUFFLE_PARTITIONS, RapidsConf,
)
from spark_rapids_tpu_torch.io.arrow_convert import arrow_to_host_batch
from spark_rapids_tpu_torch.io.discovery import csv_options
from spark_rapids_tpu_torch.plan.physical import CpuExec, ExecContext


# -- pushed-filter descriptors ----------------------------------------------


def extract_pushdown_descriptors(exprs) -> List[Tuple[str, str, Any]]:
    """(column, op, literal) descriptors from pushed filter conjuncts; ops:
    eq/lt/le/gt/ge/notnull.  Anything else is dropped."""
    from spark_rapids_tpu_torch.exprs.base import ColumnRef, Literal
    from spark_rapids_tpu_torch.exprs.nullexprs import IsNotNull
    from spark_rapids_tpu_torch.exprs.predicates import (
        Equals, GreaterThan, GreaterThanOrEqual, LessThan, LessThanOrEqual,
    )
    flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}
    ops = {Equals: "eq", LessThan: "lt", LessThanOrEqual: "le",
           GreaterThan: "gt", GreaterThanOrEqual: "ge"}
    out = []
    for e in exprs:
        if isinstance(e, IsNotNull) and isinstance(e.child, ColumnRef):
            out.append((e.child.column, "notnull", None))
            continue
        op = ops.get(type(e))
        if op is None or len(e.children) != 2:
            continue
        lhs, rhs = e.children
        if isinstance(lhs, ColumnRef) and isinstance(rhs, Literal) and \
                rhs.value is not None:
            out.append((lhs.column, op, rhs.value))
        elif isinstance(rhs, ColumnRef) and isinstance(lhs, Literal) and \
                lhs.value is not None:
            out.append((rhs.column, flip[op], lhs.value))
    return out


def _range_can_match(op: str, value, vmin, vmax) -> bool:
    """Can any v in [vmin, vmax] satisfy ``v <op> value``?  Incomparable
    types (a DATE statistic against an int literal) keep the range."""
    try:
        if op == "eq":
            return not (value < vmin or value > vmax)
        if op == "lt":
            return vmin < value
        if op == "le":
            return vmin <= value
        if op == "gt":
            return vmax > value
        if op == "ge":
            return vmax >= value
    except TypeError:
        return True  # incomparable types: keep
    return True


def _row_group_can_match(meta_rg, col_index: Dict[str, int],
                         descriptors) -> bool:
    for name, op, value in descriptors:
        ci = col_index.get(name)
        if ci is None:
            continue
        stats = meta_rg.column(ci).statistics
        if stats is None:
            continue
        if op == "notnull":
            if stats.null_count is not None and \
                    stats.null_count == meta_rg.num_rows:
                return False
            continue
        if not stats.has_min_max:
            continue
        if not _range_can_match(op, value, stats.min, stats.max):
            return False
    return True


def _stripe_can_match(probe, descriptors) -> bool:
    """Min/max test of an ORC stripe over a decode of its predicate
    columns.  A float column holding NaN never skips (Spark orders NaN
    above everything, and NaN would poison the bounds)."""
    for name, op, value in descriptors:
        if name not in probe.schema.names:
            continue
        arr = probe.column(name)
        nulls = arr.null_count
        if op == "notnull":
            if nulls == len(arr):
                return False
            continue
        if nulls == len(arr):
            return False  # all NULL: no comparison can hold
        vals = arr.drop_null().to_numpy(zero_copy_only=False)
        if vals.dtype.kind == "f" and np.isnan(vals).any():
            continue
        if not _range_can_match(op, value, vals.min(), vals.max()):
            return False
    return True


def _split(hb: HostBatch, batch_rows: int) -> List[HostBatch]:
    return [hb.slice(j, min(batch_rows, hb.num_rows - j))
            for j in range(0, hb.num_rows, batch_rows)]


def _count(counters: Optional[Dict[str, int]], total: int,
           read: int) -> None:
    if counters is not None:
        counters["row_groups_total"] = \
            counters.get("row_groups_total", 0) + total
        counters["row_groups_read"] = \
            counters.get("row_groups_read", 0) + read


def _read_parquet_file(path: str, columns: List[str], batch_rows: int,
                       descriptors=None,
                       counters: Optional[Dict[str, int]] = None
                       ) -> List[HostBatch]:
    import pyarrow.parquet as pq
    f = pq.ParquetFile(path)
    meta = f.metadata
    col_index = {meta.schema.column(i).name: i
                 for i in range(meta.num_columns)}
    keep = [i for i in range(meta.num_row_groups)
            if not descriptors or _row_group_can_match(
                meta.row_group(i), col_index, descriptors)]
    _count(counters, meta.num_row_groups, len(keep))
    if not keep:
        return []
    return [arrow_to_host_batch(rb) for rb in f.iter_batches(
        batch_size=batch_rows, row_groups=keep, columns=columns or None)]


def _read_orc_file(path: str, columns: List[str], batch_rows: int,
                   descriptors=None,
                   counters: Optional[Dict[str, int]] = None
                   ) -> List[HostBatch]:
    """ORC scan with stripe-level predicate skipping in two passes (the
    OrcFilters role): pass 1 decodes only the predicate columns the file
    has, pass 2 decodes the stripes that can match."""
    import pyarrow.orc as orc
    f = orc.ORCFile(path)
    avail = set(f.schema.names)
    pred_cols = sorted({name for name, _op, _v in (descriptors or [])
                        if name in avail})
    keep = [i for i in range(f.nstripes)
            if not pred_cols or _stripe_can_match(
                f.read_stripe(i, columns=pred_cols), descriptors)]
    _count(counters, f.nstripes, len(keep))
    out: List[HostBatch] = []
    for i in keep:
        out.extend(_split(arrow_to_host_batch(
            f.read_stripe(i, columns=columns or None)), batch_rows))
    return out


def _read_csv_file(path: str, columns: List[str], batch_rows: int,
                   options: Dict[str, Any]) -> List[HostBatch]:
    import pyarrow.csv as pacsv
    read_opts, parse_opts, conv_opts = csv_options(options)
    if columns:
        conv_opts.include_columns = columns
    tb = pacsv.read_csv(path, read_options=read_opts,
                        parse_options=parse_opts, convert_options=conv_opts)
    return _split(arrow_to_host_batch(tb), batch_rows)


def partition_value_column(f: T.Field, v: Any, n: int) -> HostColumn:
    """Constant partition-value column for one file's batches
    (ColumnarPartitionReaderWithPartitionValues role); a string value as
    bytes and offsets."""
    valid = v is not None
    validity = np.full(n, valid, dtype=np.bool_)
    if f.dtype.is_string:
        raw = np.frombuffer(str(v).encode("utf-8"), dtype=np.uint8) \
            if valid else np.zeros(0, np.uint8)
        return string_column(f.dtype, np.tile(raw, n),
                             np.arange(n + 1, dtype=np.int64) * len(raw),
                             validity)
    values = np.full(n, v if valid else 0, dtype=f.dtype.np_dtype)
    return HostColumn(f.dtype, values, validity)


class CpuFileScanExec(CpuExec):
    """Reads files on the shared decode pool, one partition per file group:
    files are dealt round-robin to ``spark.sql.shuffle.partitions``
    partitions (fewer when there are fewer files)."""

    def __init__(self, node, conf: RapidsConf):
        super().__init__([], node.schema)
        self.node = node
        self.conf = conf
        self.fmt = node.fmt
        self.paths = node.paths
        self.options = node.options
        # per-format acceleration gate: a disabled format decodes on one
        # thread with no row-group pushdown
        accel_entry = {"parquet": PARQUET_ENABLED,
                       "csv": CSV_ENABLED}.get(node.fmt)
        accel = accel_entry is None or accel_entry.get(conf)
        self._nthreads = MULTITHREADED_READ_THREADS.get(conf) if accel else 1
        self.partitions_info = node.partitions
        self.descriptors = extract_pushdown_descriptors(
            node.pushed_filters) if accel else []
        if self.partitions_info is not None:
            # partition pruning: drop whole files whose partition values
            # cannot satisfy the pushed predicates
            names = self.partitions_info[0].names
            file_values = self.partitions_info[1]
            self.paths = [p for p in self.paths if self._file_can_match(
                dict(zip(names, file_values[p])))]

    def _file_can_match(self, part_vals: Dict[str, Any]) -> bool:
        for name, op, value in self.descriptors:
            if name not in part_vals:
                continue
            v = part_vals[name]
            if v is None:
                return False  # NULL partition value fails any comparison
            if op == "notnull":
                continue
            if not _range_can_match(op, value, v, v):
                return False
        return True

    def describe(self):
        extra = f", pushed={len(self.descriptors)}" if self.descriptors \
            else ""
        return f"CpuFileScan({self.fmt}, {len(self.paths)} files{extra})"

    def num_partitions(self) -> int:
        return max(1, min(max(len(self.paths), 1),
                          SHUFFLE_PARTITIONS.get(self.conf)))

    def _file_groups(self) -> List[List[str]]:
        n = self.num_partitions()
        groups: List[List[str]] = [[] for _ in range(n)]
        for i, p in enumerate(self.paths):
            groups[i % n].append(p)
        return groups

    def _file_columns(self) -> List[str]:
        """The output columns the files hold (not the partition ones)."""
        part_names = set() if self.partitions_info is None else \
            set(self.partitions_info[0].names)
        return [n for n in self.output_schema.names if n not in part_names]

    def _read_file(self, path: str,
                   counters: Optional[Dict[str, int]] = None
                   ) -> List[HostBatch]:
        batch_rows = READER_BATCH_SIZE_ROWS.get(self.conf)
        columns = self._file_columns()
        if self.fmt == "parquet":
            batches = _read_parquet_file(path, columns, batch_rows,
                                         self.descriptors, counters)
        elif self.fmt == "orc":
            batches = _read_orc_file(path, columns, batch_rows,
                                     self.descriptors, counters)
        elif self.fmt == "csv":
            batches = _read_csv_file(path, columns, batch_rows, self.options)
        else:
            raise ValueError(self.fmt)
        return self._with_partition_columns(path, batches)

    def _with_partition_columns(self, path: str, batches: List[HostBatch]
                                ) -> List[HostBatch]:
        """Append this file's constant partition-value columns and order
        the columns as the output schema."""
        if self.partitions_info is None or not batches:
            return batches
        part_schema, file_values = self.partitions_info
        vals = dict(zip(part_schema.names, file_values[path]))
        out = []
        for hb in batches:
            cols = {f.name: c for f, c in zip(hb.schema.fields, hb.columns)}
            out.append(HostBatch(self.output_schema, [
                cols[f.name] if f.name in cols else
                partition_value_column(f, vals[f.name], hb.num_rows)
                for f in self.output_schema.fields]))
        return out

    def partitions(self, ctx: ExecContext):
        from spark_rapids_tpu_torch.io.decode_pool import get_decode_pool
        pool = get_decode_pool(self._nthreads)
        rg_read = ctx.metric(self.op_id, "rowGroupsRead")
        rg_total = ctx.metric(self.op_id, "rowGroupsTotal")

        def gen(files: List[str]):
            # read-ahead: every file of the partition goes to the pool at
            # once (one counter dict per file: no cross-thread update)
            counter_list = [dict() for _ in files]
            futures = [pool.submit(self._read_file, f, c)
                       for f, c in zip(files, counter_list)]
            try:
                for fu in futures:
                    for hb in fu.result():
                        if hb.num_rows:
                            yield hb
            finally:
                for fu in futures:
                    fu.cancel()
                rg_read.add(sum(c.get("row_groups_read", 0)
                                for c in counter_list))
                rg_total.add(sum(c.get("row_groups_total", 0)
                                 for c in counter_list))

        return [gen(g) for g in self._file_groups()]
