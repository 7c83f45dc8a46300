"""GpuSparkSession: the user entry point (port of the part of
``spark_rapids_tpu/session.py`` the slice needs).

A session runs on CUDA unless built with ``device="cpu"``; without a CUDA
device and without that request it raises at construction.  With
``spark.rapids.shuffle.ici.enabled`` it installs a device mesh of every
visible device, one included (the JAX package only from two devices up;
see :mod:`spark_rapids_tpu_torch.parallel.mesh_shuffle`).  ``sql`` parses a
query over the session's temp views (``register_view``, or a DataFrame's
``create_or_replace_temp_view``) into a DataFrame.  ``read`` returns a
:class:`DataFrameReader` over parquet, csv and orc files.

After each query ``last_metrics`` holds the query's counts and the scan
lane's per-operator metrics summed by name (``scanDecodeWallNs``,
``rowGroupsRead``, ...); ``last_op_metrics`` holds every per-operator
metric by operator.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import HostBatch
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.runtime.device import DeviceRuntime


class GpuSparkSession:
    def __init__(self, conf: Optional[RapidsConf] = None, device=None):
        self.conf = conf or RapidsConf()
        self.runtime = DeviceRuntime(self.conf, device)
        self.last_physical_plan = None
        self.last_metrics = {}
        self.last_op_metrics = {}
        self._views = {}

    @property
    def device(self):
        return self.runtime.device

    @property
    def read(self) -> "DataFrameReader":
        return DataFrameReader(self)

    def register_view(self, name: str, df) -> None:
        self._views[name.lower()] = df

    def table(self, name: str):
        df = self._views.get(name.lower())
        if df is None:
            raise KeyError(f"table or view not found: {name}")
        return df

    def sql(self, query: str):
        """The DataFrame of a SQL query over the registered views."""
        from spark_rapids_tpu_torch.sql.parser import parse_sql
        return parse_sql(query, self)

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
        self.last_metrics = dict(ctx.metrics, **ctx.summed_metrics())
        self.last_op_metrics = ctx.op_metric_values()
        return out


class DataFrameReader:
    """``session.read.parquet(...)`` / ``.csv(...)`` / ``.orc(...)``: a
    DataFrame over a FileScan of the files (a directory, a glob or a
    file).  Hive ``key=value`` directories become partition columns,
    appended after the files' own columns."""

    def __init__(self, session: GpuSparkSession):
        self.session = session
        self._options: Dict[str, Any] = {}
        self._schema: Optional[T.Schema] = None

    def option(self, key: str, value: Any) -> "DataFrameReader":
        self._options[key] = value
        return self

    def schema(self, schema: T.Schema) -> "DataFrameReader":
        self._schema = schema
        return self

    def _scan(self, fmt: str, paths: Union[str, Sequence[str]]):
        from spark_rapids_tpu_torch.dataframe import DataFrame
        from spark_rapids_tpu_torch.io.discovery import (
            discover_partitions, expand_paths, infer_schema,
        )
        from spark_rapids_tpu_torch.plan.logical import FileScan
        if isinstance(paths, str):
            paths = [paths]
        files = expand_paths(list(paths), fmt)
        schema = self._schema or infer_schema(fmt, files, self._options)
        partitions = discover_partitions(list(paths), files)
        if partitions is not None:
            new_fields = [f for f in partitions[0].fields
                          if f.name not in set(schema.names)]
            if new_fields:
                schema = T.Schema(list(schema.fields) + new_fields)
            else:
                partitions = None
        return DataFrame(FileScan(fmt, files, schema, dict(self._options),
                                  partitions=partitions), self.session)

    def parquet(self, *paths: str):
        return self._scan("parquet", list(paths))

    def csv(self, *paths: str):
        return self._scan("csv", list(paths))

    def orc(self, *paths: str):
        return self._scan("orc", list(paths))
