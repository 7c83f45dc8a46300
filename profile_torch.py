#!/usr/bin/env python3
"""Where the time goes in one of the PyTorch port's main paths on one GPU.

    python3 profile_torch.py [--query headline|q1|part|q3|q1sql|q3sql|
                              q5|q6|q10|q12|q14] [--mesh]
                             [--batches 16] [--out build/profile.txt]

Runs one of chip_smoke.py's main paths, cached and warmed: ``headline``
(bench.py's headline query over 16,777,216 rows cached as ``--batches``
batches), ``q1`` (TPC-H Q1 over lineitem, 6,000,000 rows), ``part`` (the
``LIKE '%green%'`` part query, 2,000,000 rows), ``q3`` (TPC-H Q3 over
customer, orders and lineitem at TPC-H SF1's counts; host-driven joins, or
with ``--mesh`` both joins fused on a one-device mesh through joinProbe),
or a TPC-H text through ``session.sql`` (``q1sql``, ``q3sql``, ``q5``,
``q6``, ``q10``, ``q12``, ``q14``: ``benchmarks/tpch_like.py`` over views
of the tables at TPC-H SF1's counts, ``--mesh`` for the join queries); all
but the headline are cached as batches of ``reader.batchSizeRows`` rows.
Then it measures:

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

Prints one JSON line, with the static capacities of every fused join;
the profiler's table goes to ``--out``.  A fused query that runs out of
device memory prints those capacities and the allocator's message instead
and exits 4.  Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time
import warnings


def record_static_joins() -> list:
    """Records the capacities of every fused join the query runs (rows of
    each side, the static pair capacity, each string column's static
    output bytes) by wrapping the exec module's ``hash_join_static``."""
    from spark_rapids_tpu_torch.batch import round_up_capacity
    from spark_rapids_tpu_torch.kernels.join import _static_byte_caps
    from spark_rapids_tpu_torch.ops import gpu_exec
    joins, real = [], gpu_exec.hash_join_static

    def wrapped(left, lk, right, rk, how, schema, growth=2.0):
        pair_cap = round_up_capacity(max(int(left.capacity * growth), 1))
        joins.append({
            "how": how, "left_capacity": left.capacity,
            "right_capacity": right.capacity, "pair_capacity": pair_cap,
            "byte_caps": _static_byte_caps(left, growth, pair_cap) +
            _static_byte_caps(right, growth, pair_cap)})
        return real(left, lk, right, rk, how, schema, growth=growth)

    gpu_exec.hash_join_static = wrapped
    return joins


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
    sql = {"q1sql": "q1", "q3sql": "q3", "q5": "q5", "q6": "q6",
           "q10": "q10", "q12": "q12", "q14": "q14"}
    ap.add_argument("--query", choices=("headline", "q1", "part", "q3",
                                        *sql), default="headline")
    ap.add_argument("--mesh", action="store_true",
                    help="join queries only: install a one-device mesh "
                         "(spark.rapids.shuffle.ici.enabled)")
    ap.add_argument("--batches", type=int, default=16,
                    help="headline only: batches the table is cached as")
    ap.add_argument("--out", default="build/profile.txt")
    args = ap.parse_args()

    if args.mesh and args.query not in ("q3", "q3sql", "q5", "q10", "q12"):
        ap.error(f"--mesh needs a join query, not {args.query}")
    cuda_tier.build_all()
    conf = RapidsConf(dict(
        C.SQL_SETTINGS if args.query in sql else C.SETTINGS,
        **C.Q3_MODES["mesh-fused" if args.mesh else "host-driven"]))
    session = GpuSparkSession(conf)
    batch_rows = READER_BATCH_SIZE_ROWS.get(conf)
    if args.query in sql:
        data = {"customer": datagen.gen_customer(C.Q3_SF),
                "orders": datagen.gen_orders(C.Q3_SF),
                "lineitem": datagen.gen_lineitem(C.Q3_SF),
                "supplier": datagen.gen_supplier(C.SUPPLIER_SF),
                "nation": datagen.gen_nation(), "region": datagen.gen_region()}
        C.sql_tables(session, data, batch_rows)
        n_batches = sum(len(session.table(name).plan.children[0].batches)
                        for name in data)
        query = C.sql_query(session, sql[args.query])(None)
    elif args.query == "q3":
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
    joins = record_static_joins()
    try:
        for _ in range(3):  # materialize the cache, warm the allocator
            query.collect()
    except torch.OutOfMemoryError as e:
        # a fused query whose static capacities do not fit the card: the
        # sizes each fused join asked for, and the allocator's message
        print(json.dumps({
            "card": C.card_line(), "query": args.query, "mesh": args.mesh,
            "out_of_memory": str(e).splitlines()[0],
            "max_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "static_joins": joins}), flush=True)
        return 4
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
        "layers": layers, "static_joins": joins[-8:],
        "top_kernels": [{"name": k[:80], "device_ms": t / 1e3, "calls": c}
                        for k, t, c in kernels[:12]],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
