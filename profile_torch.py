#!/usr/bin/env python3
"""Where the time goes in one of the PyTorch port's main paths on one GPU.

    python3 profile_torch.py [--query headline|q1|part|q3|q1sql|q3sql|
                              q2|q4|q5|q6|q7|q8|q9|q10|q11|q12|q13|q14|
                              q15|q16|q17|q18|q19|q20|q21|q22|
                              scan|q1pq|q6pq|q3pq|ds_q1|...|ds_q99|
                              mortgage_etl|mortgage_simple|mortgage_join|
                              mortgage_pct|xbb_q5|...|xbb_q22 ...]
                             [--mesh] [--batches 16] [--set KEY=VALUE ...]
                             [--out build/profile.txt]

Runs one of chip_smoke.py's main paths, cached and warmed: ``headline``
(bench.py's headline query over 16,777,216 rows cached as ``--batches``
batches), ``q1`` (TPC-H Q1 over lineitem, 6,000,000 rows), ``part`` (the
``LIKE '%green%'`` part query, 2,000,000 rows), ``q3`` (TPC-H Q3 over
customer, orders and lineitem at TPC-H SF1's counts; host-driven joins, or
with ``--mesh`` both joins fused on a one-device mesh through joinProbe),
or a TPC-H text through ``session.sql`` (``q1sql``, ``q3sql`` and
``q2``, ``q4`` to ``q22``: ``benchmarks/tpch_like.py`` over views of the
tables at TPC-H SF1's counts, part and partsupp included, ``--mesh`` for
the join queries Q3, Q5, Q10 and Q12), or a TPC-DS text (``ds_q1`` to
``ds_q99``, ``ds_ss_max``: ``benchmarks/tpcds_like.py`` over chip_smoke's
TPC-DS tables, generator sf 29 in 3 partitions; q67 and q70 without
``variableFloatAgg``), or a path of the mortgage lane
(``benchmarks/mortgage_like.py`` over chip_smoke's tables, generator sf 50
in 3 partitions, the device settings: ``mortgage_etl`` run_mortgage,
``mortgage_simple`` simple_aggregates, ``mortgage_join``
aggregates_with_join, ``mortgage_pct`` aggregates_with_percentiles, whose
largest layers are the 12-way explode and the percentile rewrite's
window), or a TPCxBB text (``xbb_q5`` to ``xbb_q22``,
``benchmarks/tpcxbb_like.py`` at generator sf 30 in 3 partitions, the JAX
suite's settings); all but the headline and the TPC-DS, mortgage and
TPCxBB tables are cached as batches of ``reader.batchSizeRows`` rows.
``--query`` may be given several times for texts of one kind (TPC-H,
TPC-DS, mortgage or TPCxBB): the tables are made once and each is
measured in turn, one JSON line each.
The scan lane's paths read parquet files instead, written with pyarrow at
its default row groups into a temporary directory, in every collect:
``scan`` (bench.py's scan query over 4,194,304 rows of its table, 4 row
groups), ``q1pq``, ``q6pq`` and ``q3pq`` (SQL Q1, Q6 and Q3 over parquet
views of lineitem, orders and customer at TPC-H SF1's counts,
host-driven).  ``--set`` overrides a setting of the session (for example
``spark.rapids.sql.tpu.stage.readAheadBatches=0``).  Then it measures:

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

For the scan lane it also reports the scan's own metrics apart from the
device layers: the decode wall summed over the decode threads
(``scanDecodeWallNs``), the part of it the consumer did not wait for
(``scanH2dOverlapNs``), the bytes decoded, the staging's host time
(``stageTime``), the device bytes one collect stages, the device time of
its host-to-device copies in the profiled collect, and the rate of one
256 MiB pinned host-to-device copy on this card.

Prints one JSON line per query, with the static capacities of every fused
join; the profiler's table goes to ``--out`` (one file per query, the
query's name before the extension, when there are several).  A fused
query that runs out of device memory prints those capacities and the
allocator's message instead and exits 4.  Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import tempfile
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


def pinned_h2d_gbps() -> float:
    """GB/s of a 256 MiB pinned host-to-device copy (median of 5)."""
    import torch
    host = torch.empty(256 << 20, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty_like(host, device="cuda")
    times = []
    for _ in range(6):
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        dev.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return host.numel() / (sorted(times[1:])[2] * 1e-3) / 1e9


def staged_bytes(plan, session) -> int:
    """Device bytes every HostToDeviceExec of ``plan`` stages in one
    drive (each batch's buffers at their capacities)."""
    from spark_rapids_tpu_torch.plan.physical import (
        ExecContext, HostToDeviceExec, _batch_tensors,
    )
    total, todo = 0, [plan]
    while todo:
        op = todo.pop()
        todo.extend(op.children)
        if isinstance(op, HostToDeviceExec):
            ctx = ExecContext(session.conf, session.device)
            for part in op.partitions(ctx):
                for b in part:
                    total += sum(t.numel() * t.element_size()
                                 for t in _batch_tensors(b))
    return total


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
    sql = {"q1sql": "q1", "q3sql": "q3",
           **{q: q for q in ("q2", "q4", "q5", "q6", "q7", "q8", "q9",
                             "q10", "q11", "q12", "q13", "q14", "q15",
                             "q16", "q17", "q18", "q19", "q20", "q21",
                             "q22")}}
    on_parquet = {"scan": None, "q1pq": "q1", "q6pq": "q6", "q3pq": "q3"}
    from spark_rapids_tpu_torch.benchmarks.tpcds_like import (
        QUERIES as TPCDS_QUERIES, build_tables,
    )
    tpcds = {f"ds_{q}": q for q in TPCDS_QUERIES}
    from spark_rapids_tpu_torch.benchmarks import mortgage_like as M
    from spark_rapids_tpu_torch.benchmarks import tpcxbb_like as X
    mortgage = {"mortgage_etl": M.run_mortgage,
                "mortgage_simple": M.simple_aggregates,
                "mortgage_join": M.aggregates_with_join,
                "mortgage_pct": M.aggregates_with_percentiles}
    xbb = {f"xbb_{q}": q for q in X.QUERIES}
    ap.add_argument("--query", action="append",
                    choices=("headline", "q1", "part", "q3", *sql,
                             *on_parquet, *tpcds, *mortgage, *xbb))
    ap.add_argument("--mesh", action="store_true",
                    help="join queries only: install a one-device mesh "
                         "(spark.rapids.shuffle.ici.enabled)")
    ap.add_argument("--batches", type=int, default=16,
                    help="headline only: batches the table is cached as")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE", help="a session setting")
    ap.add_argument("--out", default="build/profile.txt")
    args = ap.parse_args()
    queries = args.query or ["headline"]
    if len(queries) > 1 and not any(all(q in kind for q in queries)
                                    for kind in (sql, tpcds, mortgage, xbb)):
        ap.error("several --query are texts of one kind only (TPC-H, "
                 "TPC-DS, mortgage or TPCxBB)")
    novar = {tpcds[q] in C.TPCDS_NO_VAR_AGG for q in queries if q in tpcds}
    if len(novar) > 1:
        ap.error("q67 and q70 run without variableFloatAgg: profile them "
                 "apart from the other TPC-DS texts")
    for q in queries:
        if args.mesh and q not in ("q3", "q3sql", "q5", "q10", "q12"):
            ap.error(f"--mesh needs a join query, not {q}")
    args.query = queries[0]
    cuda_tier.build_all()
    conf = RapidsConf(dict(
        C.TPCXBB_SETTINGS if args.query in xbb else
        C.SQL_SETTINGS if args.query in sql or args.query in on_parquet or
        args.query in tpcds or args.query in mortgage else C.SETTINGS,
        **C.Q3_MODES["mesh-fused" if args.mesh else "host-driven"]))
    if novar == {True}:
        conf.set("spark.rapids.sql.variableFloatAgg.enabled", False)
    for kv in args.set:
        key, _, value = kv.partition("=")
        conf.set(key, value)
    session = GpuSparkSession(conf)
    batch_rows = READER_BATCH_SIZE_ROWS.get(conf)
    tmp = tempfile.TemporaryDirectory(prefix="profile_torch_")
    if args.query in on_parquet:
        import pyarrow.parquet as pq
        if args.query == "scan":
            data = {"store_sales": C.headline_data(C.SCAN_ROWS)}
        else:
            data = {"lineitem": datagen.gen_lineitem(C.Q3_SF)}
            if args.query == "q3pq":
                data.update(customer=datagen.gen_customer(C.Q3_SF),
                            orders=datagen.gen_orders(C.Q3_SF))
        dirs = C.write_tables(data, tmp.name)
        del data
        n_batches = sum(pq.ParquetFile(os.path.join(
            d, "part-0.parquet")).metadata.num_row_groups
            for d in dirs.values())
        if args.query == "scan":
            query = C.scan_query(session.read.parquet(dirs["store_sales"]))
        else:
            C.parquet_views(session, dirs)
            query = C.sql_query(session, on_parquet[args.query])(None)
    elif args.query in mortgage or args.query in xbb:
        data = ({"perf_raw": M.gen_performance(C.MORTGAGE_SF),
                 "acq_raw": M.gen_acquisition(C.MORTGAGE_SF)}
                if args.query in mortgage else X.build_tables(C.TPCXBB_SF))
        C.lane_views(session, data)
        n_batches = sum(len(session.table(name).plan.children[0].batches)
                        for name in data)
        del data
        query = mortgage[args.query](session) if args.query in mortgage \
            else session.sql(X.QUERIES[xbb[args.query]])
    elif args.query in tpcds:
        data = build_tables(C.TPCDS_SF)
        C.tpcds_views(session, data, cache=True)
        n_batches = sum(len(session.table(name).plan.children[0].batches)
                        for name in data)
        del data
        query = session.sql(TPCDS_QUERIES[tpcds[args.query]])
    elif args.query in sql:
        data = {"customer": datagen.gen_customer(C.Q3_SF),
                "orders": datagen.gen_orders(C.Q3_SF),
                "lineitem": datagen.gen_lineitem(C.Q3_SF),
                "supplier": datagen.gen_supplier(C.SUPPLIER_SF),
                "nation": datagen.gen_nation(), "region": datagen.gen_region(),
                "part": datagen.gen_part(C.SQL_PART_SF),
                "partsupp": datagen.gen_partsupp(C.SQL_PART_SF)}
        C.sql_tables(session, data, batch_rows)
        n_batches = sum(len(session.table(name).plan.children[0].batches)
                        for name in data)
        del data
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
    for name in queries:
        if name != args.query:
            args.query = name
            if name in tpcds:
                query = session.sql(TPCDS_QUERIES[tpcds[name]])
            elif name in mortgage:
                query = mortgage[name](session)
            elif name in xbb:
                query = session.sql(X.QUERIES[xbb[name]])
            else:
                query = C.sql_query(session, sql[name])(None)
            joins.clear()
        out = args.out if len(queries) == 1 else \
            "{0}_{2}{1}".format(*os.path.splitext(args.out), name)
        code = measure(args, query, session, joins, n_batches, out,
                       on_parquet)
        if code:
            return code
    tmp.cleanup()
    return 0


def measure(args, query, session, joins, n_batches, out, on_parquet) -> int:
    """Collect walls, host syncs, per-layer times and one profiled collect
    of ``query``; prints its JSON line.  4 when it runs out of device
    memory."""
    import torch
    import chip_smoke as C
    from spark_rapids_tpu_torch.kernels import cuda_tier
    from spark_rapids_tpu_torch.plan.physical import ExecContext
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
    h2d_us = sum(e.self_device_time_total for e in on_device
                 if "HtoD" in e.key)
    kernels = sorted(((e.key, e.self_device_time_total, e.count)
                      for e in on_device), key=lambda x: -x[1])
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(events.table(sort_by="self_device_time_total",
                             row_limit=40))
    scan = {}
    if args.query in on_parquet:
        stage_s = sum(ms.get("stageTime", 0.0)
                      for ms in session.last_op_metrics.values())
        m = session.last_metrics
        scan = {"decode_wall_ms": m["scanDecodeWallNs"] / 1e6,
                "h2d_overlap_ms": m["scanH2dOverlapNs"] / 1e6,
                "bytes_decoded": m["scanBytesDecoded"],
                "stage_host_ms": stage_s * 1e3,
                "staged_device_bytes": staged_bytes(
                    session.last_physical_plan, session),
                "h2d_copy_device_ms": h2d_us / 1e3,
                "pinned_h2d_gbps": pinned_h2d_gbps()}
    print(json.dumps({
        "card": C.card_line(), "query": args.query, "mesh": args.mesh,
        "settings": args.set, "batches": n_batches, "rows": len(rows),
        "metrics": session.last_metrics, "scan": scan,
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
