"""Typed configuration registry (port of ``spark_rapids_tpu/config.py``).

Only the entries the ported slice reads are registered here; their keys and
defaults are the JAX package's, so one settings dict configures both.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Generic, Optional, TypeVar

T = TypeVar("T")

_REGISTRY: "Dict[str, ConfEntry]" = {}
_REGISTRY_LOCK = threading.Lock()


class ConfEntry(Generic[T]):
    def __init__(self, key: str, default: T, doc: str,
                 converter: Callable[[str], T]):
        self.key = key
        self.default = default
        self.doc = doc
        self.converter = converter

    def get(self, conf: "RapidsConf") -> T:
        return conf.get(self.key)

    def __repr__(self):
        return f"ConfEntry({self.key}={self.default!r})"


def _to_bool(s: str) -> bool:
    return str(s).strip().lower() in ("true", "1", "yes", "on")


def _register(entry: ConfEntry) -> ConfEntry:
    with _REGISTRY_LOCK:
        if entry.key in _REGISTRY:
            return _REGISTRY[entry.key]
        _REGISTRY[entry.key] = entry
    return entry


def conf_bool(key: str, default: bool, doc: str) -> ConfEntry:
    return _register(ConfEntry(key, default, doc, _to_bool))


def conf_int(key: str, default: int, doc: str) -> ConfEntry:
    return _register(ConfEntry(key, default, doc, int))


def conf_float(key: str, default: float, doc: str) -> ConfEntry:
    return _register(ConfEntry(key, default, doc, float))


class RapidsConf:
    """A snapshot of configuration values.

    Values resolve in order: explicit settings > environment variables
    (``SPARK_RAPIDS_TPU_<KEY_WITH_UNDERSCORES>``) > registered default.
    """

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings: Dict[str, Any] = dict(settings or {})

    def set(self, key: str, value: Any) -> "RapidsConf":
        self._settings[key] = value
        return self

    def get(self, key: str, default: Any = None) -> Any:
        entry = _REGISTRY.get(key)
        if key in self._settings:
            raw = self._settings[key]
            if entry is not None and isinstance(raw, str):
                return entry.converter(raw)
            return raw
        env_key = "SPARK_RAPIDS_TPU_" + key.replace(".", "_").upper()
        if env_key in os.environ:
            raw = os.environ[env_key]
            return entry.converter(raw) if entry is not None else raw
        if entry is not None:
            return entry.default
        return default

    def copy(self, **overrides: Any) -> "RapidsConf":
        c = RapidsConf(dict(self._settings))
        for k, v in overrides.items():
            c.set(k, v)
        return c


READER_BATCH_SIZE_ROWS = conf_int(
    "spark.rapids.sql.reader.batchSizeRows", 1 << 20,
    "Soft cap on the number of rows the file readers put in one batch.")
CONCURRENT_TPU_TASKS = conf_int(
    "spark.rapids.sql.concurrentTpuTasks", 1,
    "Number of tasks that can execute concurrently on a single device. "
    "Tasks above the limit block in the admission semaphore.")
VARIABLE_FLOAT_AGG = conf_bool(
    "spark.rapids.sql.variableFloatAgg.enabled", False,
    "Allow float/double aggregations whose result can vary run-to-run "
    "because of non-deterministic reduction order.")
SHUFFLE_PARTITIONS = conf_int(
    "spark.sql.shuffle.partitions", 8,
    "Number of partitions used for shuffle exchanges.")
HASH_AGG_MXU_ENABLED = conf_bool(
    "spark.rapids.sql.agg.mxuHash.enabled", True,
    "Aggregate update batches into a slot table indexed by the mixed-radix "
    "packed group key (sum/count/avg as exact limb-row scatter-adds, "
    "min/max as scatter reductions) instead of the sort-based groupby.  "
    "Batches whose packed key space exceeds the table (or float sums over "
    "NaN/Inf) re-run the exact sort path.")
HASH_AGG_MXU_SLOTS = conf_int(
    "spark.rapids.sql.agg.mxuHash.tableSlots", 8192,
    "Slot-table capacity of the slot hash aggregate: the product of the "
    "per-key value ranges (plus one per nullable key) must fit here or "
    "the batch falls back to the sort path.")
EXCHANGE_COLLAPSE_LOCAL = conf_bool(
    "spark.rapids.sql.tpu.exchange.collapseLocal", True,
    "Collapse shuffle exchanges to a single logical partition in "
    "single-process execution: partitioning only constrains placement, "
    "which one partition trivially satisfies.")
AUTO_BROADCAST_THRESHOLD = conf_int(
    "spark.sql.autoBroadcastJoinThreshold", 10 << 20,
    "Max estimated build-side bytes for choosing a broadcast hash join "
    "over a shuffled hash join; -1 disables broadcast.")
ENABLE_ICI_SHUFFLE = conf_bool(
    "spark.rapids.shuffle.ici.enabled", False,
    "Install a device mesh and route shuffle exchanges over it.  The port "
    "installs a mesh of every visible device, one included (the JAX "
    "package only from two devices up); on one device the exchange hands "
    "its input on unchanged.  Opt-in; off means the single-host exchange "
    "path.")
MESH_SPMD_JOIN_GROWTH = conf_float(
    "spark.rapids.sql.tpu.mesh.spmd.join.growthFactor", 2.0,
    "Pair-capacity growth factor for mesh-fused joins: the static pair "
    "capacity is the probe capacity times this factor, rounded up to a "
    "power of two.  Joins whose true pair count exceeds it set an overflow "
    "flag and rerun host-driven.")
