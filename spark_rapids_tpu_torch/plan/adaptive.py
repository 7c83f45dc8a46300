"""Runtime-stats replanning (port of ``spark_rapids_tpu/plan/adaptive.py``).

Every decision here reads sizes the engine already holds on the host: the
shuffle split's one bulk sync records each piece's rows and bytes and each
partition's totals (``_last_part_rows``/``_last_part_bytes`` on the
exchange), so the adaptive layer adds no host round trip.  Three
mechanisms under one gate (``spark.rapids.sql.tpu.adaptive.enabled``):

* post-shuffle coalescing (:func:`plan_groups`): adjacent small target
  partitions merge until each group reaches the byte target;
* the skew split (:func:`skew_flags`): a partition far above the median
  stays alone, and a shuffled join streams its pieces in bounded slices;
* the shuffled-to-broadcast join switch: the legal build sides
  (:func:`broadcast_build_sides`) and :func:`broadcast_threshold`; the
  switch itself is ``ops/gpu_exec.py``'s.

Host arithmetic over known integers; no torch.  The history-seeded skew
marks and the replan event log wait for ``history/`` and ``obs/``, the
only readers they have.
"""

from __future__ import annotations

import statistics
from typing import List, Optional, Tuple

from spark_rapids_tpu_torch.config import (
    ADAPTIVE_COALESCE_TARGET_BYTES, ADAPTIVE_SKEW_THRESHOLD_BYTES,
    AQE_COALESCE_ENABLED, AQE_REPLAN_JOINS, AQE_SKEW_FACTOR,
    AQE_TARGET_BYTES, AQE_TARGET_ROWS, AUTO_BROADCAST_THRESHOLD,
    TPU_ADAPTIVE_ENABLED,
)


# ---------------------------------------------------------------- gates

def enabled(ctx) -> bool:
    """Master gate for every adaptive mechanism."""
    return TPU_ADAPTIVE_ENABLED.get(ctx.conf)


def coalesce_enabled(ctx) -> bool:
    return enabled(ctx) and AQE_COALESCE_ENABLED.get(ctx.conf)


def replan_joins_enabled(ctx) -> bool:
    return enabled(ctx) and AQE_REPLAN_JOINS.get(ctx.conf)


# -------------------------------------------------------------- targets

def target_rows(ctx) -> int:
    return AQE_TARGET_ROWS.get(ctx.conf)


def target_bytes(ctx) -> int:
    """The adaptive byte target, inheriting the advisory target at 0."""
    v = ADAPTIVE_COALESCE_TARGET_BYTES.get(ctx.conf)
    return v if v > 0 else AQE_TARGET_BYTES.get(ctx.conf)


def target_for(ctx, unit: str) -> int:
    return target_bytes(ctx) if unit == "bytes" else target_rows(ctx)


def skew_factor(ctx) -> float:
    return AQE_SKEW_FACTOR.get(ctx.conf)


def skew_floor(ctx, unit: str) -> int:
    """The size a partition must also exceed to count as skewed (0
    inherits the coalesce target)."""
    if unit == "bytes":
        v = ADAPTIVE_SKEW_THRESHOLD_BYTES.get(ctx.conf)
        return v if v > 0 else target_bytes(ctx)
    return target_rows(ctx)


# ---------------------------------------------------------------- stats

def part_stats(child, n_parts: int
               ) -> Tuple[Optional[List[int]], Optional[str]]:
    """The shuffle-recorded per-partition sizes as (sizes, unit), bytes
    before rows; (None, None) when the child recorded nothing."""
    for attr, unit in (("_last_part_bytes", "bytes"),
                       ("_last_part_rows", "rows")):
        v = getattr(child, attr, None)
        if v is not None and len(v) == n_parts:
            return v, unit
    return None, None


def record_stats(ctx, op_id: str, sizes: List[int], unit: str) -> None:
    """Count the known sizes a decision read (aqeStatsBytes or
    aqeStatsRows)."""
    name = "aqeStatsBytes" if unit == "bytes" else "aqeStatsRows"
    ctx.metric(op_id, name).add(sum(sizes))


# ------------------------------------------------------------- grouping

def group_by_target(items: List, sizes: List[int], target: int
                    ) -> List[List]:
    """Group consecutive items until each group reaches the target."""
    groups, cur, cur_sz = [], [], 0
    for it, sz in zip(items, sizes):
        cur.append(it)
        cur_sz += sz
        if cur_sz >= target:
            groups.append(cur)
            cur, cur_sz = [], 0
    if cur or not groups:
        groups.append(cur)
    return groups


def skew_flags(ctx, sizes: List[int], unit: str) -> List[bool]:
    """Per-partition skew marks: above ``skewedPartitionFactor`` times the
    median raw size (0 when most partitions are empty) and above the
    floor."""
    if not sizes:
        return []
    med = statistics.median(sizes)
    factor = skew_factor(ctx)
    floor = skew_floor(ctx, unit)
    return [s > factor * med and s > floor for s in sizes]


def plan_groups(ctx, op_id: str, items: List, sizes: List[int],
                unit: str, record: bool = True, detect_skew: bool = True
                ) -> Tuple[List[List], List[bool]]:
    """Group adjacent small partitions to the target while a skewed one
    stays alone.  Returns (groups, each group's skew flag) and counts
    aqeCoalescedPartitions, aqeSkewSplits and (with ``record``) the
    stats metrics.  ``detect_skew=False`` is for a consumer that cannot
    act on a skewed partition (a full outer join)."""
    target = target_for(ctx, unit)
    flags = skew_flags(ctx, sizes, unit) if detect_skew \
        else [False] * len(sizes)
    groups: List[List] = []
    gflags: List[bool] = []
    cur: List = []
    cur_sz = 0
    for it, sz, fl in zip(items, sizes, flags):
        if fl:
            if cur:
                groups.append(cur)
                gflags.append(False)
                cur, cur_sz = [], 0
            groups.append([it])
            gflags.append(True)
            continue
        cur.append(it)
        cur_sz += sz
        if cur_sz >= target:
            groups.append(cur)
            gflags.append(False)
            cur, cur_sz = [], 0
    if cur or not groups:
        groups.append(cur)
        gflags.append(False)
    if record:
        record_stats(ctx, op_id, sizes, unit)
    merged_away = len(items) - len(groups)
    if merged_away > 0:
        ctx.metric(op_id, "aqeCoalescedPartitions").add(merged_away)
    n_skew = sum(1 for f in gflags if f)
    if n_skew:
        ctx.metric(op_id, "aqeSkewSplits").add(n_skew)
    return groups, gflags


# ------------------------------------------------------ broadcast switch

def broadcast_build_sides(how: str) -> List[str]:
    """Legal build sides for the runtime shuffled-to-broadcast switch, in
    preference order (right first); broadcasting an outer side's opposite
    would drop its unmatched rows."""
    sides = []
    if how in ("inner", "left", "left_semi", "left_anti", "cross"):
        sides.append("right")
    if how in ("inner", "right", "cross"):
        sides.append("left")
    return sides


def broadcast_threshold(ctx) -> int:
    return AUTO_BROADCAST_THRESHOLD.get(ctx.conf)
