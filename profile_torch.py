#!/usr/bin/env python3
"""Where the time goes in one of the PyTorch port's main paths on one GPU.

    python3 profile_torch.py [--query headline|q1|part|q3] [--mesh]
                             [--batches 16] [--out build/profile.txt]

Runs one of chip_smoke.py's main paths, cached and warmed: ``headline``
(bench.py's headline query over 16,777,216 rows cached as ``--batches``
batches), ``q1`` (TPC-H Q1 over lineitem, 6,000,000 rows), ``part`` (the
``LIKE '%green%'`` part query, 2,000,000 rows) or ``q3`` (TPC-H Q3 over
customer, orders and lineitem at TPC-H SF1's counts; host-driven joins, or
with ``--mesh`` both joins fused on a one-device mesh through joinProbe);
all but the headline are cached as batches of ``reader.batchSizeRows``
rows.  Then it measures:

* the collect wall: median of 7 collects, each ending in a synchronize;
* the host syncs of one collect, as ``torch.cuda.set_sync_debug_mode``
  reports them;
* per layer: every operator of the physical plan driven on its own, bottom
  up, each drive in a fresh execution context and ending in
  ``torch.cuda.synchronize()``; the layer's time is its drive minus its
  children's (execution is eager, so a drive re-runs what lies below it;
  the cached scan hands out device batches); a join's layer is its build
  sort, probe and output gathers;
* one whole collect under ``torch.profiler`` (CPU and CUDA activity): the
  wall, the device busy time (sum of the device-side events' self time),
  the idle share (1 - busy / wall) and the kernels by device time.

Prints one JSON line; the profiler's table goes to ``--out``.  Needs a CUDA
device.
"""

import argparse
import json
import os
import sys
import time
import warnings


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from spark_rapids_tpu_torch.benchmarks import datagen
    from spark_rapids_tpu_torch.config import (
        READER_BATCH_SIZE_ROWS, RapidsConf,
    )
    from spark_rapids_tpu_torch.dataframe import DataFrame
    from spark_rapids_tpu_torch.interop import host_batches
    from spark_rapids_tpu_torch.kernels import cuda_tier
    from spark_rapids_tpu_torch.plan.logical import InMemoryScan
    from spark_rapids_tpu_torch.plan.physical import ExecContext
    from spark_rapids_tpu_torch.session import GpuSparkSession

    ap = argparse.ArgumentParser()
    ap.add_argument("--query", choices=("headline", "q1", "part", "q3"),
                    default="headline")
    ap.add_argument("--mesh", action="store_true",
                    help="q3 only: install a one-device mesh "
                         "(spark.rapids.shuffle.ici.enabled)")
    ap.add_argument("--batches", type=int, default=16,
                    help="headline only: batches the table is cached as")
    ap.add_argument("--out", default="build/profile.txt")
    args = ap.parse_args()

    cuda_tier.build_all()
    conf = RapidsConf(dict(C.SETTINGS, **C.Q3_MODES[
        "mesh-fused" if args.mesh else "host-driven"]))
    session = GpuSparkSession(conf)
    batch_rows = READER_BATCH_SIZE_ROWS.get(conf)
    if args.query == "q3":
        tables = C.q3_tables(session, {
            "customer": datagen.gen_customer(C.Q3_SF),
            "orders": datagen.gen_orders(C.Q3_SF),
            "lineitem": datagen.gen_lineitem(C.Q3_SF)}, batch_rows)
        n_batches = sum(len(t.plan.children[0].batches)
                        for t in tables.values())
        query = C.q3_query(tables)
    else:
        if args.query == "headline":
            data, build = C.headline_data(C.ROWS), C.headline_query
            batch_rows = C.ROWS // args.batches
        elif args.query == "q1":
            data, build = datagen.gen_lineitem(C.LINEITEM_SF), C.q1_query
        else:
            data, build = datagen.gen_part(C.PART_SF), C.part_query
        parts = host_batches(data, batch_rows)
        n_batches = len(parts)
        df = DataFrame(InMemoryScan(parts, parts[0].schema, 1),
                       session).cache()
        query = build(df)
    for _ in range(3):  # materialize the cache, warm the allocator
        query.collect()
    walls = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        query.collect()
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    collect_ms = sorted(walls)[len(walls) // 2] * 1e3

    # ---- host syncs: torch flags every synchronizing call in one collect -
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            query.collect()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0][:120] for w in caught
             if "synchroniz" in str(w.message)]

    # ---- per layer: drive each operator alone, bottom up -----------------
    mesh = session._shuffle_mesh()
    layers = []

    def drive(op, depth):
        """Median drive of ``op`` (ms); appends its layer after its
        children's."""
        below = sum(drive(c, depth + 1) for c in op.children)
        walls = []
        for _ in range(5):
            ctx = ExecContext(session.conf, session.device, mesh)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for part in op.partitions(ctx):
                for _b in part:
                    pass
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
        walls.sort()
        wall = walls[len(walls) // 2] * 1e3
        layers.append({"op": op.describe(), "depth": depth,
                       "cumulative_ms": wall, "layer_ms": wall - below})
        return wall

    drive(session.last_physical_plan, 0)

    # ---- one collect under the profiler ----------------------------------
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda_tier.reset_launch_counts()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        rows = query.collect()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    events = prof.key_averages()
    # device-side events only (kernels, copies): the operators that
    # launched them report the same time again
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in on_device)
    kernels = sorted(((e.key, e.self_device_time_total, e.count)
                      for e in on_device), key=lambda x: -x[1])
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(events.table(sort_by="self_device_time_total",
                             row_limit=40))
    print(json.dumps({
        "card": C.card_line(), "query": args.query, "mesh": args.mesh,
        "batches": n_batches, "rows": len(rows),
        "metrics": session.last_metrics,
        "collect_median_ms": collect_ms, "profiled_collect_ms": wall * 1e3,
        "launches": {n: cuda_tier.launch_count(n)
                     for n in cuda_tier.SOURCES},
        "host_syncs": len(syncs), "host_sync_kinds": sorted(set(syncs)),
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - (busy_us / 1e3) / (wall * 1e3),
        "layers": layers,
        "top_kernels": [{"name": k[:80], "device_ms": t / 1e3, "calls": c}
                        for k, t, c in kernels[:12]],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
