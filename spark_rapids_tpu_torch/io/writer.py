"""Columnar writers (port of ``spark_rapids_tpu/io/writer.py``): one file
per partition, written on the host through Arrow (pyarrow), with Spark's
save modes and ``partition_by`` (``key=value`` directories, which
``session.read`` reads back as partition columns)."""

from __future__ import annotations

import os
import shutil

import numpy as np

from spark_rapids_tpu_torch.batch import HostBatch
from spark_rapids_tpu_torch.io.arrow_convert import host_batch_to_arrow

_EXT = {"parquet": "parquet", "orc": "orc", "csv": "csv"}


def _prepare_dir(path: str, mode: str) -> bool:
    """False when ``mode`` is "ignore" and the path exists."""
    if os.path.exists(path):
        if mode == "overwrite":
            shutil.rmtree(path)
        elif mode in ("error", "errorifexists"):
            raise FileExistsError(path)
        elif mode == "ignore":
            return False
    os.makedirs(path, exist_ok=True)
    return True


def _write_table(table, fmt: str, fname: str) -> None:
    if fmt == "parquet":
        import pyarrow.parquet as pq
        pq.write_table(table, fname)
    elif fmt == "orc":
        import pyarrow.orc as paorc
        paorc.write_table(table, fname)
    elif fmt == "csv":
        import pyarrow.csv as pacsv
        pacsv.write_csv(table, fname)
    else:
        raise ValueError(fmt)


def write_dataframe(df, fmt: str, path: str, mode: str = "error",
                    partition_by=None) -> dict:
    """Run the plan and write one file per partition (``part-NNNNN``).
    ``partition_by`` names the columns of a dynamic-partition write: a
    file per (partition, value combination) under ``name=value``
    directories.  Returns {num_files, num_rows, num_bytes, partitions}."""
    from spark_rapids_tpu_torch.ops.cpu_exec import _concat
    from spark_rapids_tpu_torch.plan.physical import (
        DeviceToHostExec, ExecContext,
    )
    if fmt not in _EXT:
        raise ValueError(fmt)
    stats = {"num_files": 0, "num_rows": 0, "num_bytes": 0, "partitions": 0}
    if not _prepare_dir(path, mode):
        return stats
    session = df.session
    phys = session.plan_physical(df.plan)
    if phys.is_gpu:
        phys = DeviceToHostExec(phys)
    ctx = ExecContext(session.conf, session.device, session._shuffle_mesh())
    part_dirs = set()
    with session.runtime.semaphore:
        for pi, part in enumerate(phys.partitions(ctx)):
            batches = [hb for hb in part if hb.num_rows]
            if not batches:
                continue
            hb = _concat(batches, phys.output_schema)
            if partition_by:
                _write_partitioned(hb, fmt, path, pi, partition_by, stats,
                                   part_dirs)
                continue
            fname = os.path.join(path, f"part-{pi:05d}.{_EXT[fmt]}")
            _write_table(host_batch_to_arrow(hb), fmt, fname)
            stats["num_files"] += 1
            stats["num_rows"] += hb.num_rows
            stats["num_bytes"] += os.path.getsize(fname)
    stats["partitions"] = len(part_dirs)
    if stats["num_files"] == 0 and fmt == "parquet" and not partition_by:
        # an empty file still carries the schema
        fname = os.path.join(path, "part-00000.parquet")
        _write_table(host_batch_to_arrow(_concat([], df.plan.schema)),
                     fmt, fname)
        stats["num_files"] = 1
    open(os.path.join(path, "_SUCCESS"), "w").close()
    return stats


def _write_partitioned(hb: HostBatch, fmt: str, path: str, pi: int,
                       partition_by, stats, part_dirs) -> None:
    """Group the rows by the partition columns' values (first-seen
    order), one file per (task partition, value combination)."""
    from spark_rapids_tpu_torch import types as T
    key_cols = [hb.column(c).to_list() for c in partition_by]
    data_fields = [f for f in hb.schema.fields
                   if f.name not in set(partition_by)]
    rows_by_key = {}
    for r, k in enumerate(zip(*key_cols)):
        rows_by_key.setdefault(k, []).append(r)
    for k, rows in rows_by_key.items():
        sub_dir = os.path.join(path, *[
            f"{name}={'__HIVE_DEFAULT_PARTITION__' if v is None else v}"
            for name, v in zip(partition_by, k)])
        os.makedirs(sub_dir, exist_ok=True)
        part_dirs.add(sub_dir)
        idx = np.asarray(rows)
        sub = HostBatch(T.Schema(data_fields), [
            hb.column(f.name).take(idx) for f in data_fields])
        fname = os.path.join(sub_dir, f"part-{pi:05d}.{_EXT[fmt]}")
        _write_table(host_batch_to_arrow(sub), fmt, fname)
        stats["num_files"] += 1
        stats["num_rows"] += sub.num_rows
        stats["num_bytes"] += os.path.getsize(fname)
