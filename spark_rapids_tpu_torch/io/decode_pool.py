"""Process-shared file-decode thread pool (port of
``spark_rapids_tpu/io/decode_pool.py``).

All scans share ONE pool, grown to the largest thread count any scan has
requested, with a deterministic bounded shutdown registered at exit (the
MultiFileReaderThreadPool role, GpuMultiFileReader.scala).  Reader
handles are cached per thread (:func:`cached_reader`).
"""

from __future__ import annotations

import atexit
import collections
import concurrent.futures
import os
import threading
from typing import Callable, Optional

_lock = threading.Lock()
_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
_pool_size = 0

# -- per-thread reader handle cache ------------------------------------------
#
# A pyarrow reader is not safe for concurrent reads from several threads,
# but one thread may reuse its own handle across the row groups of a file
# instead of parsing the footer again for each.  Readers are therefore
# cached per (thread, kind, path), never shared, with a bounded LRU that
# closes the evicted reader (scan.fileHandleCache.size handles per
# thread; 0 disables).

_tls = threading.local()


def cached_reader(kind: str, path: str, factory: Callable[[], object],
                  cache_size: int):
    """Open-or-reuse a file reader for this thread.  ``kind`` keys the
    reader kinds of one path apart (``"pq"``, ``"orc"``)."""
    if cache_size <= 0:
        return factory()
    cache = getattr(_tls, "readers", None)
    if cache is None:
        cache = _tls.readers = collections.OrderedDict()
    # mtime+size in the key: a rewritten file misses instead of serving a
    # stale footer; the dead handle ages out of the LRU
    try:
        st = os.stat(path)
        key = (kind, path, st.st_mtime_ns, st.st_size)
    except OSError:
        return factory()
    r = cache.get(key)
    if r is not None:
        cache.move_to_end(key)
        return r
    r = factory()
    cache[key] = r
    while len(cache) > cache_size:
        _k, old = cache.popitem(last=False)
        close = getattr(old, "close", None)
        if close is not None:
            try:
                close()
            except OSError:
                pass  # eviction is best-effort; the reader is unreferenced
    return r


def get_decode_pool(nthreads: int) -> concurrent.futures.ThreadPoolExecutor:
    """The shared decode pool, grown (never shrunk) to ``nthreads``."""
    global _pool, _pool_size
    nthreads = max(1, int(nthreads))
    with _lock:
        if _pool is not None and _pool_size >= nthreads:
            return _pool
        old = _pool
        _pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(nthreads, _pool_size),
            thread_name_prefix="rapids-decode")
        _pool_size = max(nthreads, _pool_size)
    if old is not None:
        _shutdown(old)
    return _pool


def decode_pool_utilization() -> float:
    """Queued-work backlog as a fraction of the pool size, which the v2
    scan's adaptive read-ahead reads (0.0 when no pool exists; executors
    without an inspectable work queue read as idle)."""
    with _lock:
        pool, size = _pool, _pool_size
    if pool is None or size <= 0:
        return 0.0
    try:
        return pool._work_queue.qsize() / float(size)
    except AttributeError:
        return 0.0


def _shutdown(pool: concurrent.futures.ThreadPoolExecutor,
              timeout: float = 5.0) -> None:
    # shutdown(wait=True) joins without a bound; reap each worker with a
    # per-thread timeout instead so a wedged decode can't hang exit.
    pool.shutdown(wait=False)
    for t in list(getattr(pool, "_threads", ())):
        t.join(timeout=timeout)


def shutdown_decode_pool(timeout: float = 5.0) -> None:
    """Deterministically stop the shared pool (idempotent; at exit)."""
    global _pool, _pool_size
    with _lock:
        pool = _pool
        _pool = None
        _pool_size = 0
    if pool is not None:
        _shutdown(pool, timeout)


atexit.register(shutdown_decode_pool)
