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
metric by operator (the transitions' ``h2dBytes``, ``d2hBytes``,
``d2hTime``, the host operators' ``hostTime``).

The planner places each operator on the GPU or the host from its tags and
the confs (``plan/overrides.py``).  ``last_explain`` holds the last plan's
placement lines, ``explain_plan(plan)`` (and ``DataFrame.explain``) gives
them with the physical plan, and ``spark.rapids.sql.explain`` (ALL or
NOT_ON_GPU) logs them for every query to this module's ``.explain``
logger.  With
``spark.rapids.sql.test.enabled`` a query fails before it runs if any
operator other than a scan, a transition or a host exchange was placed on
the host.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Sequence, Union

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import HostBatch
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.runtime.device import DeviceRuntime

_EXPLAIN_LOGGER = logging.getLogger(__name__ + ".explain")

#: the host execs the test mode allows (spark.rapids.sql.test.enabled)
_TEST_MODE_ALLOWED = ("HostToDeviceExec", "CpuInMemoryScanExec",
                      "CpuFileScanExec", "FileScanV2Exec",
                      "DeviceToHostExec", "CpuShuffleExchangeExec")


class GpuSparkSession:
    def __init__(self, conf: Optional[RapidsConf] = None, device=None):
        self.conf = conf or RapidsConf()
        self.runtime = DeviceRuntime(self.conf, device)
        self.last_physical_plan = None
        self.last_explain = ""
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

    def range(self, start: int, end: Optional[int] = None, step: int = 1,
              num_partitions: int = 1):
        """DataFrame of one LONG column ``id``: ``range(n)`` is 0..n-1."""
        from spark_rapids_tpu_torch.dataframe import DataFrame
        from spark_rapids_tpu_torch.plan.logical import Range
        if end is None:
            start, end = 0, start
        return DataFrame(Range(start, end, step, num_partitions), self)

    def plan_physical(self, plan):
        """The physical plan of a logical plan; its placement lines go to
        ``last_explain`` (and to the explain logger when
        ``spark.rapids.sql.explain`` asks for them)."""
        from spark_rapids_tpu_torch.config import EXPLAIN
        from spark_rapids_tpu_torch.plan.overrides import GpuOverrides
        overrides = GpuOverrides(self.conf)
        phys = overrides.apply(plan)
        self.last_explain = overrides.last_explain
        mode = str(EXPLAIN.get(self.conf)).upper()
        if mode == "ALL":
            _EXPLAIN_LOGGER.info("%s", overrides.last_explain)
        elif mode == "NOT_ON_GPU":
            lines = [ln for ln in overrides.last_explain.splitlines()
                     if ln.lstrip().startswith("!")]
            if lines:
                _EXPLAIN_LOGGER.info("%s", "\n".join(lines))
        return phys

    def explain_plan(self, plan) -> str:
        """The placement lines of a plan, a blank line, the physical
        plan."""
        phys = self.plan_physical(plan)
        return self.last_explain + "\n\n" + phys.tree_string()

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
        from spark_rapids_tpu_torch.config import TEST_ENABLED
        phys = self.plan_physical(plan)
        self.last_physical_plan = phys
        if TEST_ENABLED.get(self.conf):
            _assert_on_gpu(phys)
        ctx = ExecContext(self.conf, self.device, self._shuffle_mesh())
        with self.runtime.semaphore:
            out = collect_host(phys, ctx)
        self.last_metrics = dict(ctx.metrics, **ctx.summed_metrics())
        self.last_op_metrics = ctx.op_metric_values()
        return out


def _assert_on_gpu(op, allow=_TEST_MODE_ALLOWED) -> None:
    """The test mode's check (``spark.rapids.sql.test.enabled``): raises
    naming the first host exec the plan holds outside ``allow``."""
    name = type(op).__name__
    if not op.is_gpu and name not in allow:
        raise AssertionError(f"operator {name} ({op.describe()}) fell back "
                             "to the CPU with spark.rapids.sql.test."
                             "enabled=true")
    for c in op.children:
        _assert_on_gpu(c, allow)


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
