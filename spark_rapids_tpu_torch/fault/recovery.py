"""Device-lost recovery and per-partition host completion (port of
``spark_rapids_tpu/fault/recovery.py``).

The ladder for a failed partition:

1. classify the error (:mod:`.errors`);
2. ``NON_RETRYABLE`` -> raise it at once;
3. ``RETRYABLE_OOM`` -> spill everything spillable
   (``catalog.handle_alloc_failure``) and replay;
4. ``DEVICE_LOST`` -> reset the runtime (a new generation and semaphore,
   the SAME catalog with its device tier invalidated: host and disk copies
   survive) and replay: a partition is a pure recomputation of its
   lineage, and the exchange's split is generation-checked, so a replay
   after a reset splits again instead of reading lost pieces;
5. after ``retry.maxAttempts`` attempts on a device-class error, run JUST
   THAT PARTITION through the host operators (the query's logical plan
   lowered again with ``spark.rapids.sql.enabled=false``) when
   ``spark.rapids.sql.tpu.fallback.onDeviceError`` is on.

CUDA adds one case.  A CUDA error of the DEVICE_LOST kind is sticky: it
poisons the process's context, and no replay on the card can succeed.  So
after a DEVICE_LOST the context is probed once (``torch.cuda.synchronize``);
if the probe raises, the runtime is marked poisoned and the partition goes
straight to the host operators, with ``deviceLostCount`` and
``partitionFallbackCount`` counted.  From then on the host completion
makes no CUDA call: the catalog's device handles go to the lost tier with
their buffers kept (freeing one may call into the dead context).

The port drives partitions eagerly and has no whole-stage pipeline (its
``run_pipeline_with_recovery`` waits for ROADMAP item 5a);
:func:`run_plan_with_recovery` takes its place for a failure outside any
partition (the plan's eager work, the collect's final copy): the whole
collect replays, and its fallback is the whole query on the host.
"""

from __future__ import annotations

import logging
import os
import traceback
from typing import Callable, List, Optional

from spark_rapids_tpu_torch.fault import metrics as fault_metrics
from spark_rapids_tpu_torch.fault.errors import (
    ErrorClass, PartitionTimeout, classify_error,
)
from spark_rapids_tpu_torch.fault.retry import RetryPolicy
from spark_rapids_tpu_torch.fault.watchdog import partition_deadline

_LOG = logging.getLogger(__name__)


def _fallback_enabled(conf) -> bool:
    from spark_rapids_tpu_torch.config import FALLBACK_ON_DEVICE_ERROR
    return FALLBACK_ON_DEVICE_ERROR.get(conf)


def context_poisoned(ctx) -> bool:
    """Probe the CUDA context once after a device loss: True (and the
    runtime marked poisoned) when a synchronize raises."""
    rt = ctx.runtime
    if rt is None or rt.device.type != "cuda":
        return False
    if not rt.poisoned:
        import torch
        try:
            torch.cuda.synchronize(rt.device)
        except Exception:  # noqa: BLE001 - any failure means unusable
            rt.poisoned = True
    return rt.poisoned


def recover_device_lost(ctx, err: Optional[BaseException] = None) -> None:
    """Reset device state after a DEVICE_LOST-class failure: a new
    runtime generation and semaphore, the catalog kept with its device
    tier invalidated.  After a PartitionTimeout the rescue copy is
    skipped: the device is wedged, and a copy would block on the very
    hang being recovered from."""
    if ctx.runtime is not None:
        ctx.runtime.recover(rescue=not isinstance(err, PartitionTimeout))


def _pre_replay(ctx, err, cls) -> None:
    if cls is ErrorClass.DEVICE_LOST:
        recover_device_lost(ctx, err)
    elif cls is ErrorClass.RETRYABLE_OOM:
        ctx.catalog.handle_alloc_failure(error=err)


def _where(err: BaseException) -> str:
    """The innermost frame of the package's own code that ``err`` passed
    through, as ``file:line (function)``."""
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if "spark_rapids_tpu_torch" in f.filename]
    if not frames:
        return "?"
    f = frames[-1]
    return f"{os.path.basename(f.filename)}:{f.lineno} ({f.name})"


def _drop_frames(err: BaseException) -> None:
    """Free what the failed attempt's frames still reference (its device
    buffers, after an OOM) before the replay allocates again."""
    traceback.clear_frames(err.__traceback__)


def _recover_loop(ctx, policy: RetryPolicy, attempt: Callable,
                  fallback: Callable, label: str,
                  error: Optional[Exception] = None,
                  attempts_used: int = 0):
    """The one ladder: classify -> NON_RETRYABLE raises -> retryable
    errors recover (spill, runtime reset) and replay under a fresh
    deadline with deterministic backoff -> exhausted attempts (or a
    poisoned context) degrade to ``fallback()`` (None: unavailable, the
    last device error raises).  Every DEVICE_LOST-classified error is
    counted once, here."""
    last = error
    attempts = attempts_used
    while True:
        if last is not None:
            cls = classify_error(last)
            if not isinstance(last, Exception) or \
                    cls is ErrorClass.NON_RETRYABLE:
                raise last
            _LOG.warning("%s attempt %d failed (%s) at %s: %s", label,
                         max(attempts, 1), cls.value, _where(last),
                         str(last).splitlines()[0] if str(last) else
                         type(last).__name__)
            if cls is ErrorClass.DEVICE_LOST:
                fault_metrics.record("device_lost")
                if context_poisoned(ctx):
                    recover_device_lost(ctx, last)
                    attempts = max(attempts, policy.max_attempts)
            if attempts >= policy.max_attempts:
                out = fallback()
                if out is None:
                    raise last
                fault_metrics.record("partition_fallbacks")
                ctx.metric("task", "partitionFallbacks").add(1)
                return out
            _drop_frames(last)
            _pre_replay(ctx, last, cls)
            fault_metrics.record("retries")
            ctx.metric("task", "retries").add(1)
            policy.backoff(attempts)
        try:
            with partition_deadline(ctx.conf, label):
                return attempt()
        except Exception as e:  # noqa: BLE001 - classified above
            last = e
            attempts += 1


def run_partition_with_retry(root, ctx, index: int,
                             error: Optional[Exception] = None) -> List:
    """Replay partition ``index`` of ``root`` under the policy; ``error``
    is the failure that used attempt 1.  Exhausted device-class errors
    degrade to the partition on the host operators."""
    return _recover_loop(
        ctx, RetryPolicy.from_conf(ctx.conf),
        attempt=lambda: list(root.partitions(ctx)[index]),
        fallback=lambda: _cpu_fallback_partition(root, ctx, index),
        label=f"partition:{index}", error=error,
        attempts_used=1 if error is not None else 0)


def run_plan_with_recovery(ctx, attempt: Callable,
                           error: Optional[Exception] = None):
    """Replay a whole collect (``attempt()``, host batches) after a
    failure outside any partition; the fallback is the whole query on the
    host operators."""
    return _recover_loop(
        ctx, RetryPolicy.from_conf(ctx.conf), attempt=attempt,
        fallback=lambda: _cpu_fallback_collect(ctx), label="plan",
        error=error, attempts_used=1 if error is not None else 0)


# -- host fallback --------------------------------------------------------


def _cpu_plan(ctx):
    """The query's all-host physical plan (lowered once per context from
    the logical plan ``session.execute`` attached), or None."""
    cached = getattr(ctx, "_cpu_fallback_plan", None)
    if cached is not None:
        return cached
    logical = getattr(ctx, "logical_plan", None)
    if logical is None:
        return None
    from spark_rapids_tpu_torch.plan.overrides import GpuOverrides
    cpu_conf = ctx.conf.copy(**{"spark.rapids.sql.enabled": False})
    try:
        plan = GpuOverrides(cpu_conf).apply(logical)
    except Exception:  # noqa: BLE001 - must not mask the device error
        return None
    ctx._cpu_fallback_plan = plan
    ctx._cpu_fallback_conf = cpu_conf
    return plan


def _cpu_context(ctx):
    import torch
    from spark_rapids_tpu_torch.plan.physical import ExecContext
    return ExecContext(ctx._cpu_fallback_conf, torch.device("cpu"))


def _cpu_fallback_partition(root, ctx, index: int) -> Optional[List]:
    """Partition ``index`` of the host plan; None when fallback is off, no
    logical plan is attached, or the two plans' partitions do not
    align."""
    if not _fallback_enabled(ctx.conf):
        return None
    cpu_root = _cpu_plan(ctx)
    if cpu_root is None:
        return None
    cpu_ctx = _cpu_context(ctx)
    try:
        parts = cpu_root.partitions(cpu_ctx)
        n_dev = root.num_partitions(ctx)
        if len(parts) != n_dev:
            if n_dev == 1 and index == 0:
                # one partition: "that partition" is the query
                return [hb for p in parts for hb in p]
            return None
        return list(parts[index])
    finally:
        cpu_ctx.close_deferred()


def _cpu_fallback_collect(ctx) -> Optional[List]:
    """The whole query on the host plan, as host batches."""
    if not _fallback_enabled(ctx.conf):
        return None
    cpu_root = _cpu_plan(ctx)
    if cpu_root is None:
        return None
    cpu_ctx = _cpu_context(ctx)
    try:
        return [hb for p in cpu_root.partitions(cpu_ctx) for hb in p]
    finally:
        cpu_ctx.close_deferred()
