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


def conf_str(key: str, default: str, doc: str) -> ConfEntry:
    return _register(ConfEntry(key, default, doc, str))


def conf_bytes(key: str, default: int, doc: str) -> ConfEntry:
    """A byte size: an int, or a string with a k/m/g/t suffix (``64m``,
    ``1gb``)."""
    def parse(s: str) -> int:
        s = str(s).strip().lower()
        mult = 1
        for suffix, m in (("k", 1 << 10), ("m", 1 << 20), ("g", 1 << 30),
                          ("t", 1 << 40)):
            if s.endswith(suffix + "b"):
                s, mult = s[:-2], m
                break
            if s.endswith(suffix):
                s, mult = s[:-1], m
                break
        return int(float(s) * mult)
    return _register(ConfEntry(key, default, doc, parse))


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

    def explicitly_set(self, key: str) -> bool:
        """True when the user pinned ``key``: an explicit setting or an
        environment override.  The adaptive read-ahead honors a pinned
        ``scan.readAhead.depth`` instead of tuning over it."""
        if key in self._settings:
            return True
        env_key = "SPARK_RAPIDS_TPU_" + key.replace(".", "_").upper()
        return env_key in os.environ


SQL_ENABLED = conf_bool(
    "spark.rapids.sql.enabled", True,
    "Enable (true) or disable (false) GPU acceleration of SQL operators; "
    "disabled, every operator runs on the host.")
EXPLAIN = conf_str(
    "spark.rapids.sql.explain", "NONE",
    "Explain why parts of a query were or were not placed on the GPU. "
    "Options: NONE, ALL, NOT_ON_GPU.")
TEST_ENABLED = conf_bool(
    "spark.rapids.sql.test.enabled", False,
    "Testing only: fail a query if any operator other than a scan, a "
    "host<->device transition or a host exchange would run on the host.")
STRING_HASH_JOIN = conf_bool(
    "spark.rapids.sql.stringHashGroupJoin.enabled", True,
    "Group by / join on string keys via row hashes computed on the "
    "device; off, such an operator runs on the host's exact path.")
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
HAS_NANS = conf_bool(
    "spark.rapids.sql.hasNans", True,
    "Whether float/double data is assumed to possibly contain NaNs; when "
    "true the planner refuses grouping by a float (the JAX package keeps "
    "it on the CPU).")
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
NLJ_PAIR_CAPACITY = conf_int(
    "spark.rapids.sql.nestedLoopJoin.pairCapacity", 1 << 22,
    "Max cross-pair slots a single nested-loop-join step may allocate; "
    "a stream side whose pair space exceeds this is joined in row chunks "
    "(the reference streams broadcast NLJ per stream batch).")
EXCHANGE_COLLAPSE_LOCAL = conf_bool(
    "spark.rapids.sql.tpu.exchange.collapseLocal", True,
    "Collapse shuffle exchanges to a single logical partition in "
    "single-process execution: partitioning only constrains placement, "
    "which one partition trivially satisfies.")
SHUFFLE_COALESCE_MAX_BYTES = conf_bytes(
    "spark.rapids.sql.tpu.exchange.splitCoalesceMaxBytes", 256 << 20,
    "A target partition whose combined size exceeds this stays as "
    "per-batch pieces instead of one coalesced piece (<= 0: always "
    "coalesce).")
CPU_RANGE_PARTITIONING_SAMPLE = conf_int(
    "spark.rapids.sql.rangePartitioning.sampleSize", 1 << 16,
    "Rows sampled (the first ones, in partition and batch order) when "
    "computing range-partitioning bounds.")
AQE_COALESCE_ENABLED = conf_bool(
    "spark.rapids.sql.adaptive.coalescePartitions.enabled", True,
    "Group small post-shuffle partitions so each downstream task covers "
    "a worthwhile size; join pairs coalesce by combined size to stay "
    "co-partitioned.")
AQE_TARGET_ROWS = conf_int(
    "spark.rapids.sql.adaptive.targetPartitionRows", 1 << 16,
    "Row-count target per coalesced post-shuffle partition (used only "
    "when the exchange did not record byte sizes).")
AQE_TARGET_BYTES = conf_bytes(
    "spark.rapids.sql.adaptive.advisoryPartitionSizeInBytes", 64 << 20,
    "Byte-size target per coalesced post-shuffle partition, preferred "
    "over the row target whenever the exchange recorded piece bytes.")
AQE_REPLAN_JOINS = conf_bool(
    "spark.rapids.sql.adaptive.replanJoins.enabled", True,
    "At execution time, run a shuffled hash join whose build side's "
    "exchange came in under spark.sql.autoBroadcastJoinThreshold actual "
    "bytes as a broadcast join, skipping the probe side's split.")
AQE_SKEW_FACTOR = conf_float(
    "spark.rapids.sql.adaptive.skewJoin.skewedPartitionFactor", 5.0,
    "A join partition is skewed when its size exceeds this multiple of "
    "the median partition size (and the skew floor); its stream side is "
    "then joined piece by piece, in bounded row slices.")
TPU_ADAPTIVE_ENABLED = conf_bool(
    "spark.rapids.sql.tpu.adaptive.enabled", True,
    "Master gate of the adaptive layer (plan/adaptive.py): post-shuffle "
    "coalescing, the shuffled-to-broadcast join switch and the skew "
    "split, all from sizes the shuffle split already fetched.")
ADAPTIVE_COALESCE_TARGET_BYTES = conf_bytes(
    "spark.rapids.sql.tpu.adaptive.coalesce.targetBytes", 0,
    "Byte target per coalesced post-shuffle partition; 0 inherits "
    "spark.rapids.sql.adaptive.advisoryPartitionSizeInBytes.")
ADAPTIVE_SKEW_THRESHOLD_BYTES = conf_bytes(
    "spark.rapids.sql.tpu.adaptive.skew.thresholdBytes", 0,
    "Absolute floor a partition must also exceed (besides "
    "skewedPartitionFactor x median) to count as skewed; 0 inherits the "
    "coalesce byte target.")
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

# ---- the scan lane (io/scan.py, io/scan_v2.py, HostToDeviceExec) ----
MULTITHREADED_READ_THREADS = conf_int(
    "spark.rapids.sql.format.parquet.multiThreadedRead.numThreads", 8,
    "Threads used to read+decode file footers and column chunks in "
    "parallel ahead of device staging.")
STAGE_READAHEAD_BATCHES = conf_int(
    "spark.rapids.sql.tpu.stage.readAheadBatches", 2,
    "Host batches decoded AND staged onto the device ahead of the consumer "
    "by a background thread, so scan decode + host->device transfer "
    "overlap downstream device compute.  0 = synchronous staging.")
PARQUET_ENABLED = conf_bool(
    "spark.rapids.sql.format.parquet.enabled", True,
    "Enable the accelerated parquet scan path: multi-threaded read-ahead "
    "decode plus row-group predicate pushdown.  Disabled falls back to "
    "single-threaded plain decode.")
CSV_ENABLED = conf_bool(
    "spark.rapids.sql.format.csv.enabled", True,
    "Enable the accelerated CSV scan path (multi-threaded read-ahead "
    "decode).  Disabled falls back to single-threaded decode.")
SCAN_PUSHDOWN_ENABLED = conf_bool(
    "spark.rapids.sql.scan.pushdown.enabled", True,
    "Push filter conjuncts into file scans: parquet row groups are "
    "skipped on min/max statistics and Hive key=value partition "
    "directories are pruned before any decode.")
COLUMN_PRUNING_ENABLED = conf_bool(
    "spark.rapids.sql.tpu.columnPruning.enabled", False,
    "Project a join's inputs down to the columns the plan above reads, "
    "so a join does not carry every column of both sides: an out-of-core "
    "query then holds its working set, not its tables' widths, on the "
    "device.")
SCAN_V2_ENABLED = conf_bool(
    "spark.rapids.sql.tpu.scan.v2.enabled", True,
    "Parallel scan pipeline (io/scan_v2): sub-file decode parallelism "
    "(parquet row groups / ORC stripes as independent tasks on a "
    "process-shared decode pool), streaming chunk emission so decode "
    "overlaps host->device staging, plus lateMaterialization below.  Off "
    "restores the v1 file-at-a-time scan (same results either way).")
SCAN_READAHEAD_DEPTH = conf_int(
    "spark.rapids.sql.tpu.scan.readAhead.depth", 4,
    "Decode tasks kept in flight ahead of the scan consumer by the v2 "
    "pipeline (bounded sliding window over the shared decode pool). "
    "Chunks are still yielded in deterministic file/chunk order.  "
    "<=1 decodes one chunk at a time (no read-ahead).")
SCAN_READAHEAD_ADAPTIVE = conf_bool(
    "spark.rapids.sql.tpu.scan.readAhead.adaptive.enabled", True,
    "Close the read-ahead control loop: the v2 scan adjusts its in-flight "
    "decode-task depth between chunk drains from its own blocked-drain "
    "ratio and the decode pool's utilization gauge, deepening while the "
    "consumer starves and the pool has headroom, shallowing when chunks "
    "are always ready.  Clamped to [1, scan.readAhead.maxDepth].  Ignored "
    "(static depth honored) when scan.readAhead.depth is set explicitly.")
SCAN_READAHEAD_MAX_DEPTH = conf_int(
    "spark.rapids.sql.tpu.scan.readAhead.maxDepth", 16,
    "Upper clamp for the adaptive read-ahead controller "
    "(scan.readAhead.adaptive.enabled): at most this many decode tasks "
    "in flight ahead of the scan consumer.")
SCAN_PAGE_CHUNK_MIN_BYTES = conf_bytes(
    "spark.rapids.sql.tpu.scan.pageChunk.minBytes", 64 << 20,
    "Sub-row-group decode granularity (v2 parquet): a row group whose "
    "compressed footprint exceeds this is decoded as several column-slab "
    "subtasks on the pool and reassembled column-wise on the consumer "
    "thread, so one fat row group cannot serialize the decode pool.  <=0 "
    "disables (always one task per row group).")
SCAN_FILE_HANDLE_CACHE_SIZE = conf_int(
    "spark.rapids.sql.tpu.scan.fileHandleCache.size", 8,
    "Per-thread pyarrow file-handle cache capacity (io.decode_pool): "
    "scan chunk tasks reuse the thread's open ParquetFile/ORC reader for "
    "the same path instead of paying open()+footer-parse per row group; "
    "least-recently-used handles past the bound are closed.  <=0 "
    "disables caching.")
SCAN_LATE_MAT_ENABLED = conf_bool(
    "spark.rapids.sql.tpu.scan.lateMaterialization.enabled", True,
    "Late materialization for pushed-predicate scans (v2): decode the "
    "predicate columns of a row-group chunk first, evaluate the pushed "
    "conjuncts, and decode the remaining projected columns only when "
    "the chunk has surviving rows; chunks with zero survivors are "
    "skipped entirely (the Filter above re-applies the predicate).")

# ---- memory and faults (mem/catalog.py, fault/) ----
DEVICE_SPILL_BUDGET = conf_bytes(
    "spark.rapids.memory.tpu.spillBudgetBytes", 8 << 30,
    "Device bytes the catalog lets spillable batches occupy before "
    "spilling lowest-priority ones to host.")
HOST_SPILL_STORAGE_SIZE = conf_bytes(
    "spark.rapids.memory.host.spillStorageSize", 1 << 30,
    "Bytes of host memory used to cache spilled device data before "
    "overflowing to disk.")
DEVICE_POOL_FRACTION = conf_float(
    "spark.rapids.memory.tpu.allocFraction", 0.9,
    "Fraction of the device's memory the caching allocator may hold "
    "(torch.cuda.set_per_process_memory_fraction on the session's "
    "device); past it an allocation raises torch.OutOfMemoryError, which "
    "the OOM retry answers by spilling.")
SHUFFLE_COMPRESSION_CODEC = conf_str(
    "spark.rapids.shuffle.compression.codec", "copy",
    "Codec for spilled bytes on disk: copy (none) or zlib.")
SPILL_ASYNC_ENABLED = conf_bool(
    "spark.rapids.sql.tpu.spill.async.enabled", True,
    "Run budget-triggered spills on a bounded background writer pool: "
    "reserve() moves victims to the SPILLING tier under the catalog lock "
    "and returns at once; the device-to-host copy (on the catalog's own "
    "stream) and any compress+disk write overlap compute.  A get() racing "
    "an unstarted spill cancels it; one racing a started spill joins that "
    "handle's completion.  false: every tier move completes before the "
    "triggering call returns.  OOM-triggered spills are always "
    "synchronous.")
SPILL_WRITER_THREADS = conf_int(
    "spark.rapids.sql.tpu.spill.writer.threads", 2,
    "Background writer threads draining the async spill queue.")
SPILL_CHUNK_BYTES = conf_bytes(
    "spark.rapids.sql.tpu.spill.chunkBytes", 8 << 20,
    "Frame size for disk spill files: the serialized batch streams "
    "through the codec in chunks of this many bytes.  <=0 writes one "
    "whole-batch frame.")
RETRY_MAX_ATTEMPTS = conf_int(
    "spark.rapids.sql.tpu.retry.maxAttempts", 3,
    "Total attempts (first try included) the retry policy allows a "
    "retryable operation: OOM spill-retries and device-lost partition "
    "replays share this bound.  Exhausted device-class errors degrade to "
    "the per-partition host fallback (fallback.onDeviceError).")
RETRY_BACKOFF_MS = conf_float(
    "spark.rapids.sql.tpu.retry.backoffMs", 50.0,
    "Base backoff milliseconds between retry attempts: backoffMs * "
    "2^(attempt-1), no jitter, so faulted runs replay identically.")
PARTITION_TIMEOUT_SEC = conf_float(
    "spark.rapids.sql.tpu.partition.timeoutSec", 0.0,
    "Deadline in seconds for driving one partition.  On expiry a watchdog "
    "thread raises a classified PartitionTimeout into the driving thread, "
    "which then enters device-lost recovery.  0 disables.")
FALLBACK_ON_DEVICE_ERROR = conf_bool(
    "spark.rapids.sql.tpu.fallback.onDeviceError", True,
    "After retry.maxAttempts device replays of a failed partition (device "
    "lost, wedged, or an OOM that spilling cannot fix), run just that "
    "partition through the host operators so the query completes with "
    "the host engine's rows.  false surfaces the raw device error.")
FAULTS_SPEC = conf_str(
    "spark.rapids.sql.tpu.faults.spec", "",
    "Deterministic fault injection spec, e.g. \"dispatch:oom@3;"
    "d2h:device_lost@1;spill:slow=200ms@2\": at each named site (dispatch, "
    "h2d, d2h, spill, unspill, exchange, scan, mesh) the Nth call raises "
    "the named error class (or stalls, for slow=<dur>); @N+ fires from "
    "the Nth call onward.  Call counters reset per query.  Empty disables "
    "injection.")
