"""Scan v2, the default scan: chunk-granular parallel decode with a bounded
read-ahead and chunk-level late materialization (port of
``spark_rapids_tpu/io/scan_v2.py``; the MultiFileParquetPartitionReader
shape, GpuParquetScan.scala:647-700).

v1 decodes whole files, one pool thread a file, and materializes every
HostBatch of a file before handing the first on.  v2 splits the decode at
parquet row-group / ORC stripe granularity, runs the chunks on the
process-shared decode pool (:mod:`.decode_pool`) and yields them through
an ordered sliding window of ``scan.readAhead.depth`` in-flight tasks, so
the decode of chunks k+1..k+depth overlaps the consumer's staging and
device work on chunk k while the output order stays that of the files and
chunks (the rows equal v1's).

Late materialization (``scan.lateMaterialization.enabled``): when
conjuncts were pushed, each chunk first decodes ONLY the predicate columns
present in the file and evaluates the conjuncts exactly; a chunk with no
surviving row skips the decode of every other column.  The Filter above
the scan re-applies the predicate, so the skip is chunk-granular and
exact.

The ``scan`` fault site fires as each chunk's decode is submitted, on the
thread that drives the scan (the consumer's, or the staging read-ahead
worker's, whose error the consumer raises).

Not ported: the JAX package's dictionary-encoded string corridor (the
port's scan always hands over plain strings, as bytes and offsets) and
the scan's spans and time series.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import List, Optional

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import HostBatch, host_batch_bytes
from spark_rapids_tpu_torch.config import (
    READER_BATCH_SIZE_ROWS, SCAN_FILE_HANDLE_CACHE_SIZE,
    SCAN_LATE_MAT_ENABLED, SCAN_PAGE_CHUNK_MIN_BYTES,
    SCAN_READAHEAD_ADAPTIVE, SCAN_READAHEAD_DEPTH, SCAN_READAHEAD_MAX_DEPTH,
    RapidsConf,
)
from spark_rapids_tpu_torch.fault import inject
from spark_rapids_tpu_torch.io.arrow_convert import arrow_to_host_batch
from spark_rapids_tpu_torch.io.decode_pool import (
    cached_reader, decode_pool_utilization, get_decode_pool,
)
from spark_rapids_tpu_torch.io.discovery import csv_options
from spark_rapids_tpu_torch.io.scan import (
    CpuFileScanExec, _row_group_can_match, _split, _stripe_can_match,
)
from spark_rapids_tpu_torch.plan.physical import ExecContext

#: Decoded-and-ready chunks held beyond the one being consumed: chunk k
#: staged, k+1 decoded on the host, k+2..k+1+depth decoding.
_READY_BUF = 2

#: Drains between adaptive read-ahead adjustments (smooths the
#: blocked-fraction signal over a few chunks).
_ADAPT_EVERY = 4


@dataclasses.dataclass
class _ChunkResult:
    """One decoded (or skipped) chunk, in submission order."""

    batches: List[HostBatch]
    decode_ns: int = 0
    bytes_decoded: int = 0
    skipped: bool = False       # late-mat: no row can survive the conjuncts
    rg_total: int = 0
    rg_read: int = 0
    t0: int = 0                 # worker-side decode window (monotonic ns)
    t1: int = 0

    def done(self) -> "_ChunkResult":
        self.t1 = time.monotonic_ns()
        self.decode_ns = self.t1 - self.t0
        return self


def _chunk_survivors(descriptors, table) -> bool:
    """Exact chunk-level survival: does ANY row satisfy every pushed
    conjunct?  Plain numpy comparisons, the IEEE semantics the device
    Filter applies, so a skipped chunk never holds a row the Filter would
    keep; an incomparable conjunct keeps the chunk."""
    import pyarrow as pa
    mask: Optional[np.ndarray] = None
    for name, op, value in descriptors:
        if name not in table.schema.names:
            continue
        arr = table.column(name)
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks() if arr.num_chunks != 1 else \
                arr.chunk(0)
        if pa.types.is_dictionary(arr.type):
            arr = arr.dictionary_decode()
        valid = np.ones(len(arr), dtype=np.bool_) if arr.null_count == 0 \
            else np.asarray(arr.is_valid())
        if op == "notnull":
            m = valid
        else:
            try:
                if pa.types.is_string(arr.type) or \
                        pa.types.is_large_string(arr.type):
                    vals = np.array(
                        ["" if v is None else v for v in arr.to_pylist()],
                        dtype=object)
                else:
                    vals = arr.to_numpy(zero_copy_only=False)
                cmp = {"eq": np.equal, "lt": np.less, "le": np.less_equal,
                       "gt": np.greater, "ge": np.greater_equal}[op]
                with np.errstate(invalid="ignore"):
                    m = valid & np.asarray(cmp(vals, value), dtype=np.bool_)
            except (TypeError, ValueError):
                continue  # incomparable: conservatively keep the chunk
        mask = m if mask is None else (mask & m)
    return bool(mask.any()) if mask is not None else True


class FileScanV2Exec(CpuFileScanExec):
    """Chunk-parallel scan with read-ahead and late materialization; the
    same rows, in the same order, as :class:`CpuFileScanExec`."""

    def __init__(self, node, conf: RapidsConf):
        super().__init__(node, conf)
        self._depth = max(1, SCAN_READAHEAD_DEPTH.get(conf))
        # the adaptive controller owns the depth UNLESS the user pinned
        # scan.readAhead.depth explicitly: a static setting wins
        self._adaptive = (SCAN_READAHEAD_ADAPTIVE.get(conf) and
                          not conf.explicitly_set(SCAN_READAHEAD_DEPTH.key))
        self._max_depth = max(self._depth, SCAN_READAHEAD_MAX_DEPTH.get(conf))
        self._page_min_bytes = SCAN_PAGE_CHUNK_MIN_BYTES.get(conf)
        self._handle_cache = max(0, SCAN_FILE_HANDLE_CACHE_SIZE.get(conf))
        self._late_mat = SCAN_LATE_MAT_ENABLED.get(conf)

    def describe(self):
        flags = []
        if self.descriptors:
            flags.append(f"pushed={len(self.descriptors)}")
        if self._late_mat:
            flags.append("latemat")
        extra = (", " + ",".join(flags)) if flags else ""
        return (f"FileScanV2({self.fmt}, {len(self.paths)} files, "
                f"depth={self._depth}{extra})")

    # -- chunk planning ------------------------------------------------------

    def _parquet_file(self, path: str):
        import pyarrow.parquet as pq
        return cached_reader("pq", path, lambda: pq.ParquetFile(path),
                             self._handle_cache)

    def _orc_file(self, path: str):
        import pyarrow.orc as orc
        return cached_reader("orc", path, lambda: orc.ORCFile(path),
                             self._handle_cache)

    def _plan_column_slabs(self, meta, rg: int, columns: List[str]
                           ) -> Optional[List[List[str]]]:
        """Split an OVERSIZED parquet row group into contiguous column
        slabs of >= scan.pageChunk.minBytes compressed bytes each, decoded
        as parallel pool tasks and zipped back column-wise by the
        consumer, so one writer's giant row group does not serialize the
        pipeline behind a single decode thread.  None (no split) for small
        row groups, projections of fewer than two columns, and
        pushed-predicate scans (slabs would re-run the survival probe per
        slab)."""
        if self._page_min_bytes <= 0 or self.descriptors or \
                len(columns) < 2:
            return None
        rgm = meta.row_group(rg)
        sizes = {}
        for i in range(rgm.num_columns):
            c = rgm.column(i)
            name = c.path_in_schema.split(".")[0]
            sizes[name] = sizes.get(name, 0) + c.total_compressed_size
        total = sum(sizes.get(n, 0) for n in columns)
        if total < 2 * self._page_min_bytes:
            return None
        n_slabs = min(len(columns), total // self._page_min_bytes)
        target = total / n_slabs
        slabs: List[List[str]] = []
        cur: List[str] = []
        acc = 0
        for name in columns:
            cur.append(name)
            acc += sizes.get(name, 0)
            if acc >= target and len(slabs) < n_slabs - 1:
                slabs.append(cur)
                cur, acc = [], 0
        if cur:
            slabs.append(cur)
        return slabs if len(slabs) > 1 else None

    def _chunk_tasks(self, files: List[str]):
        """Lazily yield one decode task GROUP per chunk as ``(path,
        [callables])``, in file order, then chunk order.  A group has one
        task per column slab (one for everything but oversized parquet
        row groups); the consumer zips several slabs column-wise."""
        columns = self._file_columns()
        batch_rows = READER_BATCH_SIZE_ROWS.get(self.conf)
        for path in files:
            if self.fmt == "parquet":
                meta = self._parquet_file(path).metadata
                for rg in range(meta.num_row_groups):
                    slabs = self._plan_column_slabs(meta, rg, columns) \
                        if columns else None
                    if slabs is None:
                        yield path, [
                            lambda p=path, i=rg:
                            self._decode_parquet_chunk(p, i, columns,
                                                       batch_rows)]
                    else:
                        yield path, [
                            lambda p=path, i=rg, s=slab:
                            self._decode_parquet_slab(p, i, s, batch_rows)
                            for slab in slabs]
            elif self.fmt == "orc":
                for st in range(self._orc_file(path).nstripes):
                    yield path, [
                        lambda p=path, i=st:
                        self._decode_orc_chunk(p, i, columns, batch_rows)]
            elif self.fmt == "csv":
                yield path, [
                    lambda p=path:
                    self._decode_csv_chunk(p, columns, batch_rows)]
            else:
                raise ValueError(self.fmt)

    # -- per-chunk decode (runs on pool worker threads) ----------------------

    def _finish_chunk(self, path: str, batches: List[HostBatch],
                      res: _ChunkResult) -> _ChunkResult:
        res.batches = self._with_partition_columns(path, batches)
        res.bytes_decoded = sum(host_batch_bytes(hb) for hb in res.batches)
        return res

    def _decode_parquet_chunk(self, path: str, rg: int, columns: List[str],
                              batch_rows: int) -> _ChunkResult:
        import pyarrow as pa
        res = _ChunkResult([], rg_total=1, t0=time.monotonic_ns())
        # readers are per-THREAD (decode_pool.cached_reader)
        f = self._parquet_file(path)
        file_schema = f.schema_arrow
        meta = f.metadata
        col_index = {meta.schema.column(i).name: i
                     for i in range(meta.num_columns)}
        if self.descriptors and not _row_group_can_match(
                meta.row_group(rg), col_index, self.descriptors):
            return res.done()  # statistics skip (as v1): nothing decoded
        res.rg_read = 1
        probe = None
        if self._late_mat and self.descriptors:
            pred_cols = sorted({name for name, _op, _v in self.descriptors
                                if name in file_schema.names})
            if pred_cols:
                probe = f.read_row_group(rg, columns=pred_cols)
                if not _chunk_survivors(self.descriptors, probe):
                    res.skipped = True
                    res.bytes_decoded = probe.nbytes
                    return res.done()
        if not columns:
            tb = f.read_row_group(rg)  # as v1: an empty projection reads all
        elif probe is None:
            tb = f.read_row_group(rg, columns=columns)
        else:
            # survivors exist: decode only the columns the probe did not
            rest = [c for c in columns if c not in probe.schema.names]
            tb_rest = f.read_row_group(rg, columns=rest) if rest else None
            arrays = {}
            for src in (probe, tb_rest):
                if src is not None:
                    for name in src.schema.names:
                        arrays[name] = src.column(name)
            tb = pa.table({n: arrays[n] for n in columns})
        self._finish_chunk(path, _split(arrow_to_host_batch(tb), batch_rows),
                           res)
        return res.done()

    def _decode_parquet_slab(self, path: str, rg: int, slab: List[str],
                             batch_rows: int) -> _ChunkResult:
        """Decode ONE column slab of a row group (no pushdown here, see
        _plan_column_slabs).  Raw result: no partition columns, no byte
        count; the consumer merges the slabs and finishes the chunk."""
        res = _ChunkResult([], t0=time.monotonic_ns())
        tb = self._parquet_file(path).read_row_group(rg, columns=slab)
        res.batches = _split(arrow_to_host_batch(tb), batch_rows)
        return res.done()

    def _merge_slab_results(self, path: str,
                            results: List[_ChunkResult]) -> _ChunkResult:
        """Zip column-slab results back into one whole-row chunk.  Slabs
        cover disjoint contiguous column ranges of the SAME rows with the
        same batch_rows splits, so batch j of every slab aligns."""
        res = _ChunkResult([], rg_total=1, rg_read=1,
                           t0=min(r.t0 for r in results),
                           t1=max(r.t1 for r in results))
        res.decode_ns = sum(r.decode_ns for r in results)
        merged = []
        for parts in zip(*(r.batches for r in results)):
            fields = [f for hb in parts for f in hb.schema.fields]
            cols = [c for hb in parts for c in hb.columns]
            merged.append(HostBatch(T.Schema(fields), cols))
        return self._finish_chunk(path, merged, res)

    def _decode_orc_chunk(self, path: str, stripe: int, columns: List[str],
                          batch_rows: int) -> _ChunkResult:
        res = _ChunkResult([], rg_total=1, t0=time.monotonic_ns())
        f = self._orc_file(path)
        avail = set(f.schema.names)
        pred_cols = sorted({name for name, _op, _v in self.descriptors
                            if name in avail})
        if pred_cols:
            probe = f.read_stripe(stripe, columns=pred_cols)
            if self._late_mat:
                if not _chunk_survivors(self.descriptors, probe):
                    res.skipped = True
                    res.bytes_decoded = probe.nbytes
                    return res.done()
            elif not _stripe_can_match(probe, self.descriptors):
                return res.done()  # v1-style min/max stripe skip
        res.rg_read = 1
        hb = arrow_to_host_batch(f.read_stripe(stripe,
                                               columns=columns or None))
        self._finish_chunk(path, _split(hb, batch_rows), res)
        return res.done()

    def _decode_csv_chunk(self, path: str, columns: List[str],
                          batch_rows: int) -> _ChunkResult:
        import pyarrow.csv as pacsv
        res = _ChunkResult([], rg_total=1, rg_read=1, t0=time.monotonic_ns())
        read_opts, parse_opts, conv_opts = csv_options(self.options)
        if columns:
            conv_opts.include_columns = columns
        tb = pacsv.read_csv(path, read_options=read_opts,
                            parse_options=parse_opts,
                            convert_options=conv_opts)
        self._finish_chunk(path, _split(arrow_to_host_batch(tb), batch_rows),
                           res)
        return res.done()

    # -- partition iterators -------------------------------------------------

    def partitions(self, ctx: ExecContext):
        pool = get_decode_pool(self._nthreads)
        m_decode = ctx.metric(self.op_id, "scanDecodeWallNs")
        m_overlap = ctx.metric(self.op_id, "scanH2dOverlapNs")
        m_bytes = ctx.metric(self.op_id, "scanBytesDecoded")
        m_skipped = ctx.metric(self.op_id, "scanChunksSkipped")
        m_depth = ctx.metric(self.op_id, "readaheadDepthEffective")
        rg_read = ctx.metric(self.op_id, "rowGroupsRead")
        rg_total = ctx.metric(self.op_id, "rowGroupsTotal")
        adaptive = self._adaptive
        max_depth = self._max_depth

        def gen(files: List[str]):
            # pending: (path, [futures]) decode window, submission order.
            # ready: decoded chunks harvested off the window head but not
            # yet yielded
            pending: collections.deque = collections.deque()
            ready: collections.deque = collections.deque()
            stats = {"decode": 0, "bytes": 0, "skipped": 0,
                     "rg_read": 0, "rg_total": 0, "blocked": 0,
                     "drains": 0, "win_blocked": 0,
                     "win_t0": time.monotonic_ns(),
                     "depth": self._depth, "depth_max": self._depth}

            def finish_entry(entry, blocked_ns: int) -> _ChunkResult:
                path, futs = entry  # every future completed by now
                rs = [fu.result() for fu in futs]
                res = rs[0] if len(rs) == 1 else \
                    self._merge_slab_results(path, rs)
                stats["blocked"] += blocked_ns
                stats["win_blocked"] += blocked_ns
                stats["decode"] += res.decode_ns
                stats["bytes"] += res.bytes_decoded
                stats["skipped"] += 1 if res.skipped else 0
                stats["rg_read"] += res.rg_read
                stats["rg_total"] += res.rg_total
                return res

            def adapt() -> None:
                # raise the depth while the consumer blocks on decode AND
                # the pool has headroom; shed it when chunks pile up
                # decoded but unconsumed
                stats["drains"] += 1
                if not adaptive or stats["drains"] % _ADAPT_EVERY:
                    return
                now = time.monotonic_ns()
                blocked_frac = stats["win_blocked"] / max(
                    now - stats["win_t0"], 1)
                d = stats["depth"]
                if blocked_frac > 0.05 and decode_pool_utilization() < 1.0:
                    d = min(d + 1, max_depth)
                elif blocked_frac < 0.005 and len(ready) >= _READY_BUF:
                    d = max(d - 1, 1)
                stats["depth"] = d
                stats["depth_max"] = max(stats["depth_max"], d)
                stats["win_blocked"] = 0
                stats["win_t0"] = now

            def drain_blocking() -> _ChunkResult:
                entry = pending.popleft()
                w0 = time.monotonic_ns()
                for fu in entry[1]:
                    fu.result()
                res = finish_entry(entry, time.monotonic_ns() - w0)
                adapt()
                return res

            def harvest() -> None:
                # move COMPLETED head entries out of the decode window so
                # the submit loop starts the next decode at once
                while pending and len(ready) < _READY_BUF and \
                        all(fu.done() for fu in pending[0][1]):
                    ready.append(finish_entry(pending.popleft(), 0))

            def results():
                for path, tasks in self._chunk_tasks(files):
                    inject.maybe_fire("scan")
                    pending.append((path, [pool.submit(t) for t in tasks]))
                    harvest()
                    while len(pending) >= stats["depth"]:
                        yield ready.popleft() if ready else drain_blocking()
                        harvest()
                while pending or ready:
                    yield ready.popleft() if ready else drain_blocking()
                    harvest()

            try:
                for res in results():
                    for hb in res.batches:
                        if hb.num_rows:
                            yield hb
            finally:
                for _path, futs in pending:
                    for fu in futs:
                        fu.cancel()
                pending.clear()
                ready.clear()
                m_decode.add(stats["decode"])
                m_overlap.add(max(0, stats["decode"] - stats["blocked"]))
                m_bytes.add(stats["bytes"])
                m_skipped.add(stats["skipped"])
                # max, not sum: each partition reports the deepest
                # read-ahead it actually ran
                m_depth.value = max(m_depth.value, stats["depth_max"])
                rg_read.add(stats["rg_read"])
                rg_total.add(stats["rg_total"])

        return [gen(g) for g in self._file_groups()]
