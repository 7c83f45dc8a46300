#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spark_rapids_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every hand-written kernel from ``spark_rapids_tpu_torch/csrc`` with
   nvcc, one process per source, all started together (into
   ``build/kernels``);
3. kernel phase: every kernel against its plain PyTorch version on the card
   (``torch.equal`` on the raw output) over a case matrix: gatherScatter
   over input counts (up to 1000, past one launch's table), widths and
   windows; stringHash over capacities 1,
   511, 512, 513 and 2^20, an all-empty column, a 4 KiB row (inside a
   contains tile's staged bytes) and a 64 KiB row (past them), multi-byte
   UTF-8, NULL rows, rows past ``num_rows``, garbage past ``offsets[-1]`` and
   byte buffers whose data_ptr() is not 16-byte aligned, then
   ``string_hash_columns`` over six such columns in one launch; contains
   over the same columns with needles of 1, 5, 16 and 70 bytes, matches at
   a row's first and last byte, needles spanning a row boundary and a
   match ending exactly at ``offsets[-1]``; joinProbe (all four
   outputs) over INT, LONG, DATE, DOUBLE, STRING and two-column keys,
   duplicates on both sides (long runs of one key too), NULL keys, a
   forced first-hash collision, empty sides, pair capacities below the
   total, a total past 2^31 - 1 (the int32 prefix sums wrap), and 2^20
   probe rows against 2^22 build rows; and gatherScatter's every-buffer
   concat (:func:`pack_columns`) over k = 1/2/16/200 batches, every
   width, take_head-truncated string columns, empty batches and zero
   tails, k = 200 with six string columns (grouped packs); and its
   row-window form (:func:`pack_column_windows`, the shuffle split's
   piece gather) over windows that start past row 0, empty windows and
   string windows whose bytes start mid-buffer, k = 1/2/6/16/200;
4. main paths, each collected twice with the launch counts zeroed just
   before each collect and read just after, rows checked against an
   independent numpy reference:
   * bench.py's headline query (filter, project, group by two int keys,
     order by) over 16,777,216 rows cached as 16 batches of
     ``reader.batchSizeRows`` rows, then as bench.py's one batch;
   * TPC-H Q1 (group and order by the string keys l_returnflag,
     l_linestatus) over lineitem at 6,000,000 rows, 6 batches;
   * the part query (``p_name LIKE '%green%'``, group and order by
     p_brand, p_type) over part at 2,000,000 rows, 2 batches;
   * TPC-H Q3 (``c_mktsegment = 'BUILDING'``, customer JOIN orders JOIN
     lineitem, group by three keys, ORDER BY revenue DESC, LIMIT 10) over
     customer 150,000, orders 1,500,000 and lineitem 6,000,000 rows
     (TPC-H SF1's counts), cached as batches of ``reader.batchSizeRows``
     rows, host-driven (shuffled hash joins) and fused on a one-device
     mesh (``spark.rapids.shuffle.ici.enabled``: both joins through the
     joinProbe kernel, and no overflow rerun); then, per way, every group
     before the LIMIT against numpy;
   * Q3 at generator sf 1 (1,500 / 15,000 / 60,000 rows), where both joins
     plan as broadcast joins, fused on the one-device mesh, top 10 and all
     groups against numpy;
   * the SQL texts of TPC-H Q1, Q3, Q5, Q6, Q10, Q12 and Q14
     (``benchmarks/tpch_like.py``) through ``session.sql`` over views of
     the tables at TPC-H SF1's counts (lineitem 6,000,000, orders
     1,500,000, customer 150,000, supplier 10,000 rows, nation and region
     whole), cached as batches of ``reader.batchSizeRows`` rows; the
     join queries host-driven and fused on the one-device mesh (where
     every join overflows its static pair capacity at the default growth
     factor and reruns host-driven; Q12 once more at growth 4, where its
     join fits and runs fused; Q5 fused at generator sf 10, since at
     SF1's counts its static capacities do not fit the card); rows
     against numpy (SQL Q1 and Q3 also against the DataFrame forms' rows
     of the same run), and every stringHash and joinProbe call of each
     query's second collect held equal to its plain version on the
     inputs the path handed it (a fused join that overflows throws
     joinProbe's output away, so no row check sees it); then the other
     fifteen texts (Q2, Q4, Q7, Q8, Q9, Q11, Q13, Q15-Q22: residual join
     conditions, the nested-loop joins of Q11, Q15 and Q22, the date
     parts, substring, count(DISTINCT)) host-driven over the same views
     with part at 200,000 and partsupp at 800,000 rows (TPC-H SF1's
     counts), rows against independent numpy answers
     (``sql_references_more``), every stringHash and contains call of
     the second collect held equal to its plain version, each text's
     rows, collect time and launches on a line of its own; then the
     fallback phase, operators the planner places on the host by their
     tags and the confs, over the same views: (a) SQL Q1 without
     ``variableFloatAgg`` (the aggregate on the host, the filter, project
     and sort on the card: stringHash launches, the explain names the
     reason, and the test mode over it raises naming the aggregate), (b)
     SQL Q10 at the default ``hasNans`` (the joins and filter on the card,
     the aggregate keyed on the DOUBLE c_acctbal on the host, the sort
     and limit on the card), (c) the part query with
     ``spark.rapids.sql.exec.Aggregate`` off (contains in the device
     filter, the string-keyed aggregate on the host), (d) SQL Q6 with
     ``spark.rapids.sql.enabled`` off (every operator on the host, no
     launch, ``torch.cuda.memory_allocated()`` unchanged across the
     collect), each against numpy with its explain lines, collect ms, the
     host operators' ms and the bytes the transitions moved; then the
     casts from DOUBLE and FLOAT to every integral type at NaN, ±inf,
     ±2^63 and ±2^31 ± 1 on the card against Java's rules and the CPU;
   * the exchange phase, over the same views with
     ``spark.rapids.sql.tpu.exchange.collapseLocal`` off and
     ``spark.sql.shuffle.partitions`` at its default 8 (the adaptive
     layer on, the broadcast threshold 10 MiB): (a) the 22 TPC-H texts,
     rows against numpy and the collapsed runs' rows, one host sync per
     split exchange, every gatherScatter (concats and the split's
     pieces), stringHash and contains call of the second collect held to
     its plain version, each text's ms beside the collapsed one's and its
     split metrics on a line; (b) a skewed join: lineitem with half its
     rows on one supplier joined to supplier (the broadcast off), grouped
     by nation, against numpy, with ``aqeSkewSplits`` >= 1 and
     ``skewSplitChunks`` > 1; (c) the partitioning API over lineitem:
     ``repartition(8, l_orderkey)`` with ``spark_partition_id``,
     ``monotonically_increasing_id`` and ``rand(7)``, ``sample(0.1)``,
     ``sort_within_partitions``, ``write_parquet`` and
     ``session.read.parquet``, the rows read back against the port's
     host engine's (rand against its device form on CPU tensors), round
     robin into 16 and ``coalesce(2)`` with each partition's rows exact,
     and a global ``orderBy`` through the range split against numpy; (d)
     ``drop_duplicates``, ``dropna``, ``fillna``, ``describe``,
     ``pivot``, ``crosstab``, ``approx_quantile``, ``freq_items``,
     ``head``, ``take``, ``first`` and ``is_empty`` over lineitem against
     numpy; then gatherScatter timed at the split's own piece shape;
     the phase's wall, peak device memory and the card on a line
     (``--exchange-only`` runs this phase alone);
   * the scan lane, over parquet files written with pyarrow at its
     default row groups into a temporary directory: bench.py's scan query
     (``bench.py:273-296``: read, filter, project revenue, group by
     ss_item_sk, sum and count) over 4,194,304 rows of bench.py's table
     (4 row groups, so 4 batches and 4 partials: one gatherScatter launch
     a collect) with the v2 scan and the staging read-ahead at 2, at 0,
     and with the v1 scan, every row against numpy and the three ways
     against each other; then SQL Q1, Q6 and Q3 (host-driven, the join
     strategies from the files' sizes) over parquet views of lineitem,
     orders and customer at TPC-H SF1's counts: Q1 must launch stringHash
     8 times and gatherScatter once a collect, as the cached Q1 does, and
     Q3's rows must equal the cached SQL Q3's;
   * the TPC-DS phase: the port's own TPC-DS-like tables
     (``benchmarks/tpcds_like.py``) at generator sf 29 (store_sales
     2,900,000 rows, about TPC-DS SF1's 2,880,404; catalog_sales
     1,160,000), cached on the card in 3 partitions; the 40 texts of the
     tenth slice (UNION, INTERSECT, EXCEPT, window functions, ROLLUP,
     stddev) and then the 65 texts that planned before it (at
     ``TPCDS_EARLIER_SF``) through ``session.sql`` with the SQL phases'
     settings (q67 and q70 without ``variableFloatAgg``, their float sums
     on the host, as the reference's suite runs them), each held in order
     to the port's host engine's rows over the same tables (computed
     first, in worker processes on the host's cores), every stringHash
     and gatherScatter call of each second collect held to its plain
     version, each text's second-collect ms and launches on a line
     (``python3 chip_smoke.py --tpcds-only`` runs this phase alone,
     after the build, and prints no result line);
   * the mortgage and TPCxBB lanes: the mortgage tables
     (``benchmarks/mortgage_like.py``) at generator sf 50 (perf_raw
     6,000,000 rows, 250,000 loans of 24 months; acq_raw 250,000 rows)
     cached on the card in 3 partitions, the four entry points
     (run_mortgage with its 12-way explode, simple_aggregates,
     aggregates_with_join with murmur3 ``hash`` and ``first``,
     aggregates_with_percentiles with the exact percentile rewrite) at the
     device settings, then run_mortgage over CSV files of the same
     tables (written with pyarrow into a temporary directory, read anew
     each collect), each against an independent numpy answer on the
     generator's dense layout (the CSV run also against the cached run's
     rows); then the eight TPCxBB texts (``benchmarks/tpcxbb_like.py``)
     at generator sf 30 (store_sales and web_clickstreams 3,000,000 rows)
     cached in 3 partitions, at the JAX suite's settings and again at the
     device settings with the test mode on, against the port's host
     engine's rows (computed first in worker processes); every
     stringHash and gatherScatter call of each second collect held to its
     plain version, each path's rows, collect ms, launches and peak
     device memory on a line (``--lanes-only`` runs this phase alone);
   * the ETL phase, the expression layer's strings built on the device,
     time and formatting, bitwise, array functions and corr/covar: part
     at 2,000,000 rows and lineitem at 6,000,000 rows (TPC-H SF10's and
     SF1's counts) cached as batches of ``reader.batchSizeRows`` rows;
     (a) ``ETL_PART_SQL`` through ``session.sql`` over a view that adds
     ``locate``: a ``LIKE '%green%'`` filter over ``lower(concat_ws(...))``
     (contains over a built string), two group keys built on the device
     (stringHash), every string builder (trims, concat and ``||``, pads,
     ``hex``, ``replace``, ``regexp_replace`` as a literal and as a class,
     ``split_part``, ``substring_index``, ``initcap``, ``upper``); (b)
     :func:`etl_lineitem_query` through the DataFrame API: a TIMESTAMP
     made on the device, grouped by ``from_unixtime`` of ``last_day`` and
     l_returnflag, the time parts, ``date_format`` of ``TimeAdd``, the
     shifts and bitwise operators, ``array``/``size``/``array_min``/
     ``array_max``/``array_contains``/``sort_array``/``array_position``,
     and corr/covar (their rewrite's windows); each against numpy
     (``etl_*_reference``), planned wholly on the card in the test mode,
     every stringHash, contains and gatherScatter call of the second
     collect held to its plain version, rows, collect ms, launches and
     peak device memory on a line (``--etl-only`` runs this phase
     alone);
   * the memory phase, the spill catalog, the OOM retry and the fault
     ladder (``--memory-only`` runs it alone, after the build): (a) the
     out-of-core run at its own settings (``benchmarks/oocore_run.py``):
     lineitem (60,000,000 rows), orders and customer at SF10, written as
     parquet into a temporary directory (its free space checked first),
     cached in one session under a 256 MiB device budget and the 1 GiB
     host store, its joins' inputs pruned to the columns read above them,
     SQL Q1 and Q18 twice each against numpy,
     every recorded gatherScatter and stringHash call held to its plain
     version, ``spilled_to_host``, ``spilled_to_disk`` and ``unspilled``
     above 0, and Q1 at the default budget, where nothing spills; (b)
     Q18 split into 8 partitions under the same budget, its shuffle
     pieces spilled and read back, its rows those of (a); (c) a real
     allocator OOM: lineitem at SF1 cached, the caching allocator's cap
     lowered until Q1 no longer fits beside the cache, the OOM answered
     by a spill and a replay on the card; (d) Q1 at SF1 under each
     injected spec of ``FAULT_SPECS``, its counters exact; (e) a sticky
     CUDA error in a child process (``--sticky-child``): the filter's
     step indexes out of bounds on the card, and Q1 completes on the host
     twins with numpy's rows; one line a step with collect ms, the
     catalog's counters, handles and bytes by tier, the bytes written to
     disk, peak device memory, the fault counters and the card.  Every
     collect of every other phase must leave the fault ladder's counters
     at 0 (``install_fault_guard``);
   each query must launch every kernel of its path, and every path but
   the fallback phase's must plan wholly on the card in the test mode
   (``spark.rapids.sql.test.enabled``: no host exec but a scan, a
   transition or a collapsed host exchange; q67 and q70 their host
   aggregate too, run_mortgage the project of its string ``coalesce``,
   as the JAX planner places them);
5. timings at the main paths' own shapes (gatherScatter: the headline
   merge's concat of its partials, every buffer, and a concat of the cached
   lineitem batches with its string columns; stringHash: Q1's two keys
   and the part query's two keys in one launch each, Q3's c_mktsegment,
   SQL Q12's IN over l_shipmode and SQL Q10's group sort by c_name (both
   on the joined batch), each first held equal to its plain version, then
   an l_returnflag batch and a p_type batch alone; contains: a p_name
   batch; for both, each launch's device time by ``torch.profiler`` with
   its inputs in L2 and with L2 flushed; joinProbe: the inputs that Q3's
   two joins, SQL Q3's two whole-table joins, SQL Q12's join at growth 4
   and SQL Q5's fused joins handed it, and each of its launches by
   ``torch.profiler``),
   medians of CUDA-event timings: the wrapper call as the path makes it,
   the kernel alone (calls captured back to back in a CUDA graph, per
   call), the plain version, the
   library call where one computes the same function (gatherScatter: one
   ``torch.cat`` per buffer), and the bound (bytes moved / 3.35 TB/s, each
   input read once and each output written once, stringHash's output as
   the function's two u32 a row; where the bytes depend on the data, as
   joinProbe's build-side reads do, what this run's inputs need).

Prints a ``{"kernels": [...]}`` JSON line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits non-zero before printing any result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROWS = 1 << 24
LINEITEM_SF = 100   # 6,000,000 rows: TPC-H SF1's lineitem count
PART_SF = 1000      # 2,000,000 rows: TPC-H SF10's part count
Q3_SF = 100         # TPC-H SF1's customer, orders and lineitem counts
Q3_BROADCAST_SF = 1  # 1,500 / 15,000 / 60,000 rows: both joins broadcast
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
#: kernel -> the TPU kernel it replaces (its pallas_call entry)
REPLACES = {
    "gatherScatter": "spark_rapids_tpu/kernels/pallas_tier.py:232",
    "stringHash": "spark_rapids_tpu/kernels/pallas_tier.py:397",
    "strings": "spark_rapids_tpu/kernels/pallas_strings.py:81",
    "joinProbe": "spark_rapids_tpu/kernels/pallas_tier.py:334",
}
SETTINGS = {"spark.rapids.sql.variableFloatAgg.enabled": True,
            "spark.sql.shuffle.partitions": 1}
#: Q3's two ways: host-driven (the default) and fused on a one-device mesh
Q3_MODES = {"host-driven": {},
            "mesh-fused": {"spark.rapids.shuffle.ici.enabled": True}}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def graph_ms(call, launches: int = 20) -> float:
    """The launches of one ``call()`` alone, without its host work:
    ``launches`` calls captured back to back in one CUDA graph and
    replayed, the median of CUDA-event timings divided by ``launches``.
    (A graph of one call, replayed on an idle stream, also times the host's
    submission of the graph: 10-15 us beside an H100, more than a short
    kernel takes.)"""
    import torch
    call()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            call()
    return time_ms(graph.replay) / launches


def host_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean host time of one ``fn()`` call, by the host clock, no sync."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of one ``fn()`` call, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# kernel phase: gatherScatter
# ---------------------------------------------------------------------------

PACK_DTYPES = ("bool", "uint8", "int32", "int64", "float32", "float64")


def _pack_inputs(rng, dtype, sizes, device):
    import torch
    arrays = []
    for n in sizes:
        if dtype == "bool":
            a = rng.rand(n) < 0.5
        elif dtype.startswith("float"):
            a = (rng.randn(n) * 1e6).astype(dtype)
        else:
            a = rng.randint(1, 120, n).astype(dtype)
        arrays.append(torch.from_numpy(a).to(device))
    return arrays


def _dev_ints(vals, device):
    import torch
    return [torch.tensor(v, dtype=torch.int32, device=device) for v in vals]


def check_pack_matrix(device) -> int:
    """gatherScatter vs its plain version, raw output buffers equal, over
    k = 1/2/16, every width, empty segments, lo > 0 windows, an out_cap
    that is not a multiple of the block, and a total below out_cap (zero
    tail).  Returns the number of cases."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_tier
    rng = np.random.RandomState(11)
    cases = 0
    for k in (1, 2, 16, 200, 1000):  # 1000 > one launch's: grouped packs
        for dtype in PACK_DTYPES:
            for layout in ("full", "windows"):
                sizes = [int(s) for s in rng.randint(1, 3000, k)]
                arrays = _pack_inputs(rng, dtype, sizes, device)
                if layout == "full":
                    los, his = [0] * k, list(sizes)
                else:
                    los, his = [], []
                    for j, n in enumerate(sizes):
                        lo = int(rng.randint(0, n + 1))
                        hi = lo if j % 3 == 1 else int(rng.randint(lo, n + 1))
                        los.append(lo)
                        his.append(hi)
                total = sum(h - lo for lo, h in zip(los, his))
                for out_cap in {total, total + 1 + int(rng.randint(0, 999))}:
                    if out_cap == 0:
                        continue
                    lo_t, hi_t = _dev_ints(los, device), _dev_ints(his, device)
                    got = cuda_tier.pack_segments(arrays, lo_t, hi_t, out_cap)
                    want = cuda_tier.pack_segments_reference(
                        arrays, lo_t, hi_t, out_cap)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"gatherScatter != plain version: k={k} "
                            f"{dtype} {layout} out_cap={out_cap}")
                    if got[total:].any():
                        raise AssertionError("gatherScatter: nonzero tail")
                    cases += 1
    return cases


def _string_parts(rng, cap, n, device):
    """(data u8, validity, offsets int32[cap+1]) of one batch's string
    column as a ``take_head`` leaves it: ``n`` live rows, offsets still
    growing past them, random bytes past ``offsets[-1]``."""
    import torch
    lens = rng.randint(0, 13, cap)  # rows of 0-12 bytes
    offsets = np.zeros(cap + 1, dtype=np.int32)
    np.cumsum(lens, out=offsets[1:])
    data = rng.randint(0, 256, int(offsets[-1]) + rng.randint(0, 40))
    valid = rng.rand(cap) < 0.9
    return (torch.from_numpy(data.astype(np.uint8)).to(device),
            torch.from_numpy(valid).to(device),
            torch.from_numpy(offsets).to(device))


def columns_case(rng, k, dtypes, n_strings, device, max_cap=3000):
    """A concat's inputs: per column, k batches' (data, validity,
    offsets); k live-row counts (0 and full batches among them) as 0-d
    int32 device tensors; the batch capacities; each string column's live
    bytes."""
    import torch
    caps = [int(c) for c in rng.randint(1, max_cap, k)]
    ns = [0 if j % 7 == 3 else cap if j % 5 == 1 else
          int(rng.randint(0, cap + 1)) for j, cap in enumerate(caps)]
    columns = []
    for dtype in dtypes:
        datas = _pack_inputs(rng, dtype, caps, device)
        valids = _pack_inputs(rng, "bool", caps, device)
        columns.append([(d, v, None) for d, v in zip(datas, valids)])
    live_bytes = []
    for _ in range(n_strings):
        parts = [_string_parts(rng, cap, n, device)
                 for cap, n in zip(caps, ns)]
        columns.append(parts)
        live_bytes.append(sum(int(o[n]) for (_, _, o), n in zip(parts, ns)))
    return columns, _dev_ints(ns, device), caps, live_bytes


def _same_buffers(got, want, label) -> None:
    """Every buffer of two packs equal bit for bit (torch.equal of the
    bytes), zero tails and rebuilt offsets included."""
    import torch
    torch.cuda.synchronize()
    for ci, (g, w) in enumerate(zip(got, want)):  # bit for bit
        for name, gb, wb in zip(("data", "validity", "offsets"), g, w):
            if (gb is None) != (wb is None) or (
                    gb is not None and (gb.dtype != wb.dtype or not
                                        torch.equal(gb.view(torch.uint8),
                                                    wb.view(torch.uint8)))):
                raise AssertionError(f"gatherScatter (all buffers) != plain "
                                     f"version: {label} column {ci} {name}")


def check_columns(columns, ns, out_cap, byte_caps, label) -> None:
    """The multi-buffer pack against its plain version."""
    from spark_rapids_tpu_torch.kernels import cuda_tier
    _same_buffers(cuda_tier.pack_columns(columns, ns, out_cap, byte_caps),
                  cuda_tier.pack_columns_reference(columns, ns, out_cap,
                                                   byte_caps), label)


def check_windows(columns, starts, counts, out_cap, byte_caps,
                  label) -> None:
    """The row-window pack (the shuffle split's piece gather) against its
    plain version."""
    from spark_rapids_tpu_torch.kernels import cuda_tier
    _same_buffers(
        cuda_tier.pack_column_windows(columns, starts, counts, out_cap,
                                      byte_caps),
        cuda_tier.pack_column_windows_reference(columns, starts, counts,
                                                out_cap, byte_caps),
        f"windows {label}")


def check_columns_matrix(device) -> int:
    """pack_columns (one launch for every buffer of a concat) against its
    plain version over k = 1/2/16/200 batches, every fixed width, string
    columns truncated by take_head, empty batches, output capacities at
    the live total and past it (zero tails), and k = 200 with six string
    columns, more inputs than one launch's table holds (the grouped
    packs).  Returns the number of cases."""
    rng = np.random.RandomState(12)
    cases = 0
    for k, n_strings in ((1, 1), (2, 2), (16, 2), (200, 1), (200, 6)):
        columns, ns, caps, live_bytes = columns_case(
            rng, k, PACK_DTYPES, n_strings, device)
        total = sum(int(n) for n in ns)
        for tail in (0, 1 + int(rng.randint(0, 999))):
            out_cap = total + tail
            if out_cap == 0:
                continue
            byte_caps = [b + tail for b in live_bytes]
            check_columns(columns, ns, out_cap, byte_caps,
                          f"k={k} strings={n_strings} tail={tail}")
            cases += 1
    return cases + check_windows_matrix(rng, device)


def check_windows_matrix(rng, device) -> int:
    """pack_column_windows (the split's piece gather: one row window per
    batch, every buffer in one launch) against its plain version: windows
    that start past row 0, empty windows (every third batch), string
    windows whose bytes start mid-buffer (take_head-truncated columns,
    offsets growing past the live rows), zero tails, k = 200 with six
    string columns (grouped packs, then a concat of the groups), and a
    pack over a reordered subset of inputs checked once (the split's
    ``PackInputs.take``).  Returns the number of cases."""
    from spark_rapids_tpu_torch.kernels import cuda_tier
    cases = 0
    for k, n_strings in ((1, 1), (2, 2), (6, 4), (16, 2), (200, 6)):
        columns, ns, caps, _ = columns_case(rng, k, PACK_DTYPES, n_strings,
                                            device)
        starts, counts = [], []
        for j, n in enumerate(int(n) for n in ns):
            start = int(rng.randint(0, n + 1))
            starts.append(start)
            counts.append(0 if j % 3 == 2 else
                          int(rng.randint(0, n - start + 1)))
        live = [sum(int(o[a + c]) - int(o[a]) for (_, _, o), a, c in
                    zip(parts, starts, counts))
                for parts in columns if parts[0][2] is not None]
        for tail in (0, 1 + int(rng.randint(0, 999))):
            out_cap = sum(counts) + tail
            if out_cap == 0:
                continue
            check_windows(columns, starts, counts, out_cap,
                          [b + tail for b in live],
                          f"k={k} strings={n_strings} tail={tail}")
            cases += 1
        # the split's form: inputs checked once, then a pack over a
        # subset of them in another order (PackInputs.take)
        sub = list(range(k))[::-2]
        sub_cols = [[parts[j] for j in sub] for parts in columns]
        sub_starts = [starts[j] for j in sub]
        sub_counts = [counts[j] for j in sub]
        sub_live = [sum(int(o[a + c]) - int(o[a]) for (_, _, o), a, c in
                        zip(parts, sub_starts, sub_counts))
                    for parts in sub_cols if parts[0][2] is not None]
        _same_buffers(
            cuda_tier.pack_column_windows(
                None, sub_starts, sub_counts, max(sum(sub_counts), 1),
                sub_live, inputs=cuda_tier.PackInputs(columns).take(sub)),
            cuda_tier.pack_column_windows_reference(
                sub_cols, sub_starts, sub_counts, max(sum(sub_counts), 1),
                sub_live),
            f"windows k={k} strings={n_strings}, a taken subset")
        cases += 1
    return cases


def _concat_numbers(columns, ns, out_cap, byte_caps, device,
                    launches: int = 20):
    """One whole concat (every buffer): the wrapper, the launch alone, the
    plain version, and the library (one ``torch.cat`` per buffer of the
    host-known live windows into a preallocated output; string offsets
    concatenated as they are, not rebuilt, so the library moves no more
    than the kernel).  Bytes: each live window read once, each output
    written once, the k bounds (and the string ends) read once."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_tier
    n_host = [int(n) for n in ns]
    live = sum(n_host)
    k = len(ns)
    nbytes = k * 4
    windows, outs = [], []
    str_caps = iter(byte_caps)
    for parts in columns:
        offs0 = parts[0][2]
        bufs = [([v[:n] for (_, v, _), n in zip(parts, n_host)], out_cap)]
        if offs0 is None:
            bufs.append(([d[:n] for (d, _, _), n in zip(parts, n_host)],
                         out_cap))
        else:
            ends = [int(o[n]) for (_, _, o), n in zip(parts, n_host)]
            bufs.append(([d[:e] for (d, _, _), e in zip(parts, ends)],
                         next(str_caps)))
            bufs.append(([o[:n + 1] for (_, _, o), n in zip(parts, n_host)],
                         out_cap + 1))
            nbytes += k * 8
        for wins, cap in bufs:
            got = sum(int(w.numel()) for w in wins)
            width = wins[0].element_size()
            nbytes += got * width + cap * width
            windows.append(wins)
            outs.append(torch.empty(got, dtype=wins[0].dtype, device=device))

    def library():
        for wins, out in zip(windows, outs):
            torch.cat(wins, out=out)

    def call():
        return cuda_tier.pack_columns(columns, ns, out_cap, byte_caps)

    return {
        "ms": time_ms(call), "kernel_only_ms": graph_ms(call, launches),
        "plain_ms": time_ms(lambda: cuda_tier.pack_columns_reference(
            columns, ns, out_cap, byte_caps), reps=10, warmup=2),
        "library_ms": time_ms(library),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
        "buffers": len(windows), "live_rows": live,
    }


def batch_columns(batches):
    """pack_columns' arguments for a concat of ``batches`` as
    ``layout.concat_kway`` makes them, with the live-total capacities the
    executor's ``_concat_all`` chooses."""
    import torch
    from spark_rapids_tpu_torch.batch import round_up_capacity
    columns = [[(c.data, c.validity, c.offsets) for c in parts]
               for parts in zip(*(b.columns for b in batches))]
    ns = [b.num_rows for b in batches]
    out_cap = round_up_capacity(max(int(torch.stack(ns).sum()), 1))
    byte_caps = [round_up_capacity(max(sum(int(o[n]) for (_, _, o), n in
                                           zip(parts, ns)), 16), minimum=16)
                 for parts in columns if parts[0][2] is not None]
    return columns, ns, out_cap, byte_caps


def _pack_numbers(arrays, los, his, out_cap, device):
    """kernel/plain/library ms and the bytes bound for one pack."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_tier
    lo_t, hi_t = _dev_ints(los, device), _dev_ints(his, device)
    width = arrays[0].element_size()
    live = sum(h - lo for lo, h in zip(los, his))
    # outputs written once, live windows and the 2k int32 bounds read once
    nbytes = out_cap * width + live * width + 2 * len(arrays) * 4
    out = torch.empty(out_cap, dtype=arrays[0].dtype, device=device)
    windows = [a[lo:hi] for a, lo, hi in zip(arrays, los, his)]

    def library():  # one torch.cat into a preallocated output
        torch.cat(windows, out=out[:live])

    def call():
        return cuda_tier.pack_segments(arrays, lo_t, hi_t, out_cap)

    return {
        "ms": time_ms(call),
        "kernel_only_ms": graph_ms(call, launches=4),
        "plain_ms": time_ms(lambda: cuda_tier.pack_segments_reference(
            arrays, lo_t, hi_t, out_cap)),
        "library_ms": time_ms(library),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bytes": nbytes,
    }


# ---------------------------------------------------------------------------
# main path: bench.py's headline query
# ---------------------------------------------------------------------------


def headline_data(rows: int):
    """bench.py:make_data."""
    from spark_rapids_tpu_torch import types as T
    rng = np.random.RandomState(42)
    return {
        "ss_item_sk": (T.INT, rng.randint(0, 2000, rows).astype(np.int32)),
        "ss_promo_sk": (T.INT, rng.randint(0, 3, rows).astype(np.int32)),
        "ss_quantity": (T.INT, rng.randint(1, 101, rows).astype(np.int32)),
        "ss_sales_price": (T.DOUBLE, (rng.rand(rows) * 200).round(2)),
        "ss_ext_discount_amt": (T.DOUBLE, (rng.rand(rows) * 100).round(2)),
    }


def headline_query(df):
    """bench.py:build_query after cache()."""
    from spark_rapids_tpu_torch import functions as F
    return (df
            .filter((df["ss_quantity"] < 25) &
                    (df["ss_ext_discount_amt"] > 10.0))
            .with_column("revenue",
                         df["ss_sales_price"] * df["ss_ext_discount_amt"])
            .group_by("ss_item_sk", "ss_promo_sk")
            .agg(F.sum("revenue").alias("sum_rev"),
                 F.count("revenue").alias("cnt"),
                 F.avg("ss_sales_price").alias("avg_price"),
                 F.min("ss_sales_price").alias("min_price"),
                 F.max("revenue").alias("max_rev"))
            .order_by("ss_item_sk", "ss_promo_sk"))


def numpy_reference(data):
    """Independent group-by of the same arrays: sorted (item, promo) keys,
    count, sum(revenue), avg(price), min(price), max(revenue)."""
    col = {k: v for k, (_, v) in data.items()}
    keep = (col["ss_quantity"] < 25) & (col["ss_ext_discount_amt"] > 10.0)
    price = col["ss_sales_price"][keep]
    rev = price * col["ss_ext_discount_amt"][keep]
    key = col["ss_item_sk"][keep].astype(np.int64) * 3 + \
        col["ss_promo_sk"][keep]
    order = np.argsort(key, kind="stable")
    ks = key[order]
    uniq, starts = np.unique(ks, return_index=True)
    cnt = np.diff(np.append(starts, len(ks)))
    return {
        "item": uniq // 3, "promo": uniq % 3, "cnt": cnt,
        "sum_rev": np.add.reduceat(rev[order], starts),
        "avg_price": np.add.reduceat(price[order], starts) / cnt,
        "min_price": np.minimum.reduceat(price[order], starts),
        "max_rev": np.maximum.reduceat(rev[order], starts),
    }


def check_rows(rows, ref, label: str) -> None:
    """Keys, counts, min and max exact; sum and avg within 1e-9 relative:
    the port sums in another order than numpy, and its slot aggregate sums
    floats as 53-bit fixed-point limbs against a per-chunk scale (error at
    most scale * 2^-53 per row); every revenue and price is >= 0, so there
    is no cancellation to magnify either."""
    got = {name: np.array([r[i] for r in rows]) for i, name in enumerate(
        ["item", "promo", "sum_rev", "cnt", "avg_price", "min_price",
         "max_rev"])}
    if len(rows) != len(ref["cnt"]):
        raise AssertionError(f"{label}: {len(rows)} rows, numpy has "
                             f"{len(ref['cnt'])}")
    for name in ("item", "promo", "cnt", "min_price", "max_rev"):
        if not np.array_equal(got[name], ref[name]):
            raise AssertionError(f"{label}: {name} differs from numpy")
    for name in ("sum_rev", "avg_price"):
        if not np.all(np.isfinite(got[name])):
            raise AssertionError(f"{label}: non-finite {name}")
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-9, atol=0,
                                   err_msg=f"{label}: {name}")


def run_query(df, label: str, ref) -> dict:
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_tier
    out = {}
    for i in range(2):
        cuda_tier.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rows = headline_query(df).collect()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {n: cuda_tier.launch_count(n) for n in cuda_tier.SOURCES}
        check_rows(rows, ref, label)
        print(f"main path [{label}] collect {i + 1}: {len(rows)} rows, "
              f"{wall:.4f} s, launches {launches}", flush=True)
        out[f"collect{i + 1}"] = {"rows": len(rows), "wall_s": wall,
                                  "launches": launches}
    check_on_gpu(headline_query(df), f"headline {label}")
    return out


def _find(op, pred):
    if pred(op):
        return op
    for c in op.children:
        hit = _find(c, pred)
        if hit is not None:
            return hit
    return None


def merge_partials(session, device):
    """The partial batches the merge aggregate concatenates on the main
    path, read back from the executed plan's update aggregate."""
    from spark_rapids_tpu_torch.ops.gpu_exec import GpuHashAggregateExec
    from spark_rapids_tpu_torch.plan.physical import ExecContext
    update = _find(session.last_physical_plan,
                   lambda o: isinstance(o, GpuHashAggregateExec)
                   and o.mode == "update")
    ctx = ExecContext(session.conf, device)
    return [b for part in update.partitions(ctx) for b in part]


# ---------------------------------------------------------------------------
# kernel phase: stringHash and strings (contains)
# ---------------------------------------------------------------------------

_WORDS = ["a", "green", "\u00e9", "\u4e2d\u6587", "\U0001f642x",
          "greengreen", "lemon navy", "Brand#13", "g", "n", "ee"]


def string_case(seed, cap, num_rows, long_row=0, empty=False):
    """(data u8, offsets int32[cap+1]) as the device holds a string
    column: rows of 0-30 bytes (multi-byte UTF-8 among them, some empty
    as NULL rows are), offsets constant past ``num_rows``, random garbage
    past ``offsets[-1]`` up to a power-of-two byte capacity; row 1 is
    ``long_row`` bytes when that is set."""
    rng = np.random.RandomState(seed)
    rows = []
    for r in range(num_rows):
        if empty or rng.rand() < 0.15:
            rows.append(b"")
        elif r == 1 and long_row:
            rows.append(bytes(rng.randint(32, 127, long_row, dtype=np.uint8)))
        else:
            rows.append(" ".join(rng.choice(_WORDS, rng.randint(1, 5)))
                        .encode()[:30])
    lens = np.array([len(b) for b in rows] + [0] * (cap - num_rows))
    offsets = np.zeros(cap + 1, dtype=np.int32)
    np.cumsum(lens, out=offsets[1:])
    total = int(offsets[-1])
    nbytes = max(16, 1 << max(total + 7, 1).bit_length())
    data = rng.randint(0, 256, nbytes).astype(np.uint8)
    data[:total] = np.frombuffer(b"".join(rows), dtype=np.uint8)
    return data, offsets


def big_string_case(seed, cap, num_rows):
    """A ``string_case`` built by numpy alone, for large capacities: rows
    of 0-30 random bytes (every byte value, so multi-byte UTF-8 sequences
    among them), 15% empty, offsets constant past ``num_rows``, garbage
    past ``offsets[-1]``."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, 31, cap)
    lens[rng.rand(cap) < 0.15] = 0
    lens[num_rows:] = 0
    offsets = np.zeros(cap + 1, dtype=np.int32)
    np.cumsum(lens, out=offsets[1:])
    nbytes = 1 << (int(offsets[-1]) + 7).bit_length()
    return rng.randint(0, 256, nbytes).astype(np.uint8), offsets


def needle_case():
    """Rows around the needle edge cases: "green" at a row's first and
    last byte, "gre"+"en" spanning a row boundary, the last row's "green"
    ending exactly at offsets[-1] before garbage that would extend it."""
    rows = [b"green", b"xgreen", b"greenx", b"gre", b"en", b"",
            b"abcdeabcde", b"abcd", b"eabcd", b"g" * 16, b"g" * 15,
            b"q" * 70, b"q" * 69, b"zzgreen"]
    offsets = np.zeros(len(rows) + 1, dtype=np.int32)
    np.cumsum([len(r) for r in rows], out=offsets[1:])
    data = np.frombuffer(b"".join(rows) + b"een" + b"q" * 80,
                         dtype=np.uint8).copy()
    return data, offsets


NEEDLES = [b"g", b"green", b"g" * 16, b"q" * 70, b"greene", b"deab",
           "\u00e9".encode()]


def unaligned(data, shift: int = 3):
    """A view of ``data``'s bytes whose data_ptr() is ``shift`` bytes past
    a 16-byte boundary."""
    import torch
    buf = torch.zeros(data.numel() + 16, dtype=torch.uint8,
                      device=data.device)
    at = (shift - buf.data_ptr()) % 16
    view = buf[at:at + data.numel()]
    view.copy_(data)
    return view


def check_string_matrix(device, big_columns) -> int:
    """stringHash and contains against their plain versions, raw outputs
    equal (torch.equal).  ``big_columns`` are 2^20-row (data, offsets)
    pairs from the main paths' cached batches.  A 4 KiB row lies within
    a contains tile's staged bytes, a 64 KiB row does not; the unaligned
    views start 3 bytes past a 16-byte boundary.  Then string_hash_columns
    over columns of different capacities (the 64 KiB row, an all-empty
    one, an unaligned view) in one launch.  Returns the case count."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_tier
    columns = [("cap1-empty", string_case(1, 1, 1, empty=True)),
               ("cap511", string_case(2, 511, 500)),
               ("cap512", string_case(3, 512, 512)),
               ("cap513", string_case(4, 513, 300)),
               ("all-empty", string_case(5, 64, 40, empty=True)),
               ("row-4KiB", string_case(8, 3000, 2900, long_row=1 << 12)),
               ("row-64KiB", string_case(6, 16, 9, long_row=1 << 16)),
               ("cap2^20", big_string_case(7, 1 << 20, (1 << 20) - 1000)),
               ("needles", needle_case())]
    columns = [(n, (torch.from_numpy(d).to(device),
                    torch.from_numpy(o).to(device))) for n, (d, o) in columns]
    named = dict(columns)
    columns += [(f"{n} unaligned", (unaligned(named[n][0]), named[n][1]))
                for n in ("cap513", "row-64KiB", "cap2^20", "needles")]
    columns += list(big_columns)
    cases = 0
    for name, (data, offsets) in columns:
        got = cuda_tier.string_hash_rows(data, offsets)
        want = cuda_tier.string_hash_rows_reference(data, offsets)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and
                torch.equal(got[1], want[1])):
            raise AssertionError(f"stringHash != plain version on {name}")
        cases += 1
        for needle in NEEDLES:
            got = cuda_tier.rows_with_match(data, offsets, needle)
            want = cuda_tier.rows_with_match_reference(data, offsets, needle)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"contains != plain version on {name} "
                                     f"needle {needle!r}")
            cases += 1
    multi = [named["cap511"], named["row-64KiB"], named["all-empty"],
             (unaligned(named["cap2^20"][0], 7), named["cap2^20"][1]),
             named["cap1-empty"], named["row-4KiB"]]
    before = cuda_tier.launch_count("stringHash")
    got = cuda_tier.string_hash_columns(multi)
    want = cuda_tier.string_hash_columns_reference(multi)
    torch.cuda.synchronize()
    if cuda_tier.launch_count("stringHash") - before != 1:
        raise AssertionError("string_hash_columns made more than one launch")
    for i, (g, w) in enumerate(zip(got, want)):
        if not (torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])):
            raise AssertionError(f"string_hash_columns != plain version on "
                                 f"column {i}")
        cases += 1
    data, offsets = needle_case()
    rows = [data[offsets[i]:offsets[i + 1]].tobytes()
            for i in range(len(offsets) - 1)]
    td, to = torch.from_numpy(data).to(device), \
        torch.from_numpy(offsets).to(device)
    for needle in NEEDLES:  # and against Python's own `in`, row by row
        got = cuda_tier.rows_with_match(td, to, needle).cpu().tolist()
        if got != [needle in r for r in rows]:
            raise AssertionError(f"contains wrong for {needle!r}")
    return cases


def kernel_numbers(call, plain, nbytes: int) -> dict:
    """Wrapper ms (as the path calls it), the kernel alone (``graph_ms``),
    the plain version's ms and the bytes bound, each a median of
    CUDA-event timings."""
    call()  # warm: builds, caches the needle on the device
    return {"ms": time_ms(call), "kernel_only_ms": graph_ms(call),
            "plain_ms": time_ms(plain, reps=10, warmup=2),
            "library_ms": None,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}


_FLUSH = []  # a buffer larger than the L2 cache, made at first use


def launch_ms(call, reps: int = 20, cold: bool = False) -> dict:
    """Device ms of each kernel one ``call()`` launches, by kernel name:
    the mean over ``reps`` calls under ``torch.profiler`` (where it
    records no device time, the whole call's by CUDA events).  With ``cold``
    the 50 MB L2 cache is flushed before each call (a 256 MiB fill, whose
    own kernel is left out), so the kernel reads device memory as a
    caller that last touched its inputs long ago would."""
    import torch
    if cold and not _FLUSH:
        _FLUSH.append(torch.empty(256 << 20, dtype=torch.uint8,
                                  device="cuda"))
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):  # a session now and then records no device events
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                if cold:
                    _FLUSH[0].zero_()
                call()
            torch.cuda.synchronize()
        got = {e.key.replace("(anonymous namespace)::", "").split("(")[0][:60]:
               e.self_device_time_total / 1e3 / reps
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not (cold and "elementwise" in e.key)}
        if got:
            return got
    # no device events in 3 sessions: CUDA events around each call instead
    # (all of the call's launches together, the host gaps between them too)
    total = 0.0
    for _ in range(reps):
        if cold:
            _FLUSH[0].zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    print("launch_ms: torch.profiler recorded no device time in 3 tries; "
          "timed each call with CUDA events", flush=True)
    return {"whole call (CUDA events)": total / reps}


def string_kernel_numbers(call, plain, nbytes: int) -> dict:
    """``kernel_numbers`` and the launch's device ms by ``torch.profiler``
    with the inputs in L2 (back to back) and with L2 flushed."""
    out = kernel_numbers(call, plain, nbytes)
    out["device_ms"] = sum(launch_ms(call).values())
    out["device_cold_ms"] = sum(launch_ms(call, cold=True).values())
    return out


def check_hashes(columns, label: str) -> int:
    """stringHash against its plain version on the same columns: every
    (h1, h2) equal (torch.equal).  Returns the largest absolute difference
    (0 when equal)."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_tier
    got = cuda_tier.string_hash_columns(columns)
    want = cuda_tier.string_hash_columns_reference(columns)
    torch.cuda.synchronize()
    err = 0
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        if not (torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])):
            raise AssertionError(f"stringHash != plain version on {label}, "
                                 f"column {i}")
        if g[0].numel():
            err = max(err, int((g[0] - w[0]).abs().max()),
                      int((g[1] - w[1]).abs().max()))
    return err


def hash_numbers(columns, label: str) -> dict:
    """stringHash at a main-path shape: every (data, offsets) column of
    ``columns`` in one string_hash_columns call, as a sort makes it, its
    outputs first held equal (torch.equal) to the per-column plain
    versions.  Bytes: per column the live bytes and the cap+1 offsets read
    once, the function's two u32 hashes per row written once (8 bytes);
    ``bound_ms_int64_words`` counts the 16 bytes a row of the two int64
    words the port writes."""
    from spark_rapids_tpu_torch.kernels import cuda_tier
    err = check_hashes(columns, label)
    caps = [int(o.numel()) - 1 for _, o in columns]
    live = sum(int(o[-1]) for _, o in columns)
    read = live + sum(4 * (cap + 1) for cap in caps)
    out = string_kernel_numbers(
        lambda: cuda_tier.string_hash_columns(columns),
        lambda: cuda_tier.string_hash_columns_reference(columns),
        read + sum(8 * cap for cap in caps))
    out["max_abs_err"] = err
    out["bytes_int64_words"] = read + sum(16 * cap for cap in caps)
    out["bound_ms_int64_words"] = (out["bytes_int64_words"] /
                                   HBM_BYTES_PER_S * 1e3)
    out["shape"] = (f"{label}: {len(columns)} column(s) of "
                    f"{'/'.join(map(str, caps))} rows, {live} live bytes")
    return out


def contains_numbers(data, offsets, needle: bytes, label: str) -> dict:
    """contains at a main-path shape.  Bytes: the live bytes, the cap+1
    offsets and the needle read once, one bool per row written once."""
    from spark_rapids_tpu_torch.kernels import cuda_tier
    cap = int(offsets.numel()) - 1
    live = int(offsets[-1])
    out = string_kernel_numbers(
        lambda: cuda_tier.rows_with_match(data, offsets, needle),
        lambda: cuda_tier.rows_with_match_reference(data, offsets, needle),
        live + 4 * (cap + 1) + len(needle) + cap)
    out["shape"] = (f"{label}: {cap} rows, {live} live bytes, needle "
                    f"{needle!r}")
    return out


# ---------------------------------------------------------------------------
# main paths: TPC-H Q1 and the part query
# ---------------------------------------------------------------------------


def q1_query(df):
    """TPC-H Q1 as the repo defines it (benchmarks/tpch_like.py Q1)."""
    from spark_rapids_tpu_torch import functions as F
    return (df
            .filter(df["l_shipdate"] <= 10471)
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.sum("l_quantity").alias("sum_qty"),
                 F.sum("l_extendedprice").alias("sum_base_price"),
                 F.avg("l_quantity").alias("avg_qty"),
                 F.avg("l_extendedprice").alias("avg_price"),
                 F.avg("l_discount").alias("avg_disc"),
                 F.count("*").alias("count_order"))
            .order_by("l_returnflag", "l_linestatus"))


def part_query(df):
    """Q9's part predicate with Q16's part grouping."""
    from spark_rapids_tpu_torch import functions as F
    return (df
            .filter(df["p_name"].like("%green%"))
            .group_by("p_brand", "p_type")
            .agg(F.count("*").alias("cnt"),
                 F.avg("p_retailprice").alias("avg_price"),
                 F.min("p_size").alias("min_size"),
                 F.max("p_size").alias("max_size"))
            .order_by("p_brand", "p_type"))


def _groups(keys):
    """Group ids of string key arrays, ordered as the keys' bytes order
    (UTF-8 keeps code point order), and each group's key values."""
    codes, uniq = [], []
    for k in keys:
        u, inv = np.unique(k, return_inverse=True)
        codes.append(inv.astype(np.int64))
        uniq.append(u)
    g = codes[0]
    for c, u in zip(codes[1:], uniq[1:]):
        g = g * len(u) + c
    present, gid = np.unique(g, return_inverse=True)
    key_vals = []
    rest = present
    for u in reversed(uniq):
        key_vals.append(u[rest % len(u)])
        rest = rest // len(u)
    return gid, len(present), key_vals[::-1]


def q1_reference(data):
    col = {k: np.asarray(v) for k, (_, v) in data.items()}
    keep = col["l_shipdate"] <= 10471
    gid, n, keys = _groups([col["l_returnflag"][keep],
                            col["l_linestatus"][keep]])
    cnt = np.bincount(gid, minlength=n)

    def total(name):
        return np.bincount(gid, weights=col[name][keep], minlength=n)

    return {"keys": keys, "exact": {"count_order": cnt}, "approx": {
        "sum_qty": total("l_quantity"),
        "sum_base_price": total("l_extendedprice"),
        "avg_qty": total("l_quantity") / cnt,
        "avg_price": total("l_extendedprice") / cnt,
        "avg_disc": total("l_discount") / cnt}}


def part_reference(data):
    col = {k: np.asarray(v) for k, (_, v) in data.items()}
    keep = np.char.find(col["p_name"], "green") >= 0
    gid, n, keys = _groups([col["p_brand"][keep], col["p_type"][keep]])
    cnt = np.bincount(gid, minlength=n)
    size = col["p_size"][keep]
    lo = np.full(n, np.iinfo(np.int32).max)
    hi = np.full(n, np.iinfo(np.int32).min)
    np.minimum.at(lo, gid, size)
    np.maximum.at(hi, gid, size)
    return {"keys": keys,
            "exact": {"cnt": cnt, "min_size": lo, "max_size": hi},
            "approx": {"avg_price": np.bincount(
                gid, weights=col["p_retailprice"][keep], minlength=n) / cnt}}


def check_string_rows(rows, names, ref, label: str) -> None:
    """Keys (in byte order), counts, min and max exact; sums and averages
    within 1e-9 relative: the merge sums floats with atomics in another
    order than numpy, and every summed value is >= 0."""
    got = {name: [r[i] for r in rows] for i, name in enumerate(names)}
    nk = len(ref["keys"])
    if len(rows) != len(ref["keys"][0]):
        raise AssertionError(f"{label}: {len(rows)} rows, numpy has "
                             f"{len(ref['keys'][0])}")
    for name, want in zip(names[:nk], ref["keys"]):
        if got[name] != [str(w) for w in want]:
            raise AssertionError(f"{label}: key {name} differs from numpy")
    for name, want in ref["exact"].items():
        if not np.array_equal(np.array(got[name]), want):
            raise AssertionError(f"{label}: {name} differs from numpy")
    for name, want in ref["approx"].items():
        g = np.array(got[name], dtype=np.float64)
        if not np.all(np.isfinite(g)):
            raise AssertionError(f"{label}: non-finite {name}")
        np.testing.assert_allclose(g, want, rtol=1e-9, atol=0,
                                   err_msg=f"{label}: {name}")


def run_path(df, query, check, label: str, recorders=(),
             on_gpu: bool = True) -> dict:
    """Two collects of one query, launch counts zeroed just before each
    and read just after; rows checked after each.  Each of ``recorders``
    is emptied before each collect, so it keeps the second one's calls.
    With ``on_gpu`` the query must also plan wholly on the GPU in the test
    mode (:func:`check_on_gpu`)."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_tier
    out = {}
    for i in range(2):
        for recorder in recorders:
            recorder.calls.clear()
        cuda_tier.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rows = query(df).collect()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {n: cuda_tier.launch_count(n) for n in cuda_tier.SOURCES}
        check(rows)
        print(f"main path [{label}] collect {i + 1}: {len(rows)} rows, "
              f"{wall:.4f} s, launches {launches}", flush=True)
        out[f"collect{i + 1}"] = {"rows": len(rows), "wall_s": wall,
                                  "launches": launches}
    if on_gpu:
        check_on_gpu(query(df), label)
    return out


#: the labels of the paths the test mode has planned
ON_GPU_CHECKED = []


def check_on_gpu(frame, label: str) -> None:
    """The test mode over one path: its plan at its session's own settings
    plus ``spark.rapids.sql.test.enabled`` must hold no host exec but a
    scan, a transition or a collapsed host exchange (the session's check
    raises naming the first other one)."""
    from spark_rapids_tpu_torch.plan.overrides import GpuOverrides
    from spark_rapids_tpu_torch.session import _assert_on_gpu
    conf = frame.session.conf.copy(**{"spark.rapids.sql.test.enabled": True})
    _assert_on_gpu(GpuOverrides(conf).apply(frame.plan))
    ON_GPU_CHECKED.append(label)


def _require(path: dict, label: str, names) -> None:
    for i in (1, 2):
        launches = path[f"collect{i}"]["launches"]
        for name in names:
            if launches[name] == 0:
                raise AssertionError(f"{label} collect {i} never launched "
                                     f"{name}")


def cached_column(df, name: str):
    """(data, offsets) of a string column of the first cached batch."""
    batch = df.plan.holder.partitions[0][0].get()
    col = batch.column(name)
    return col.data, col.offsets



# ---------------------------------------------------------------------------
# kernel phase: joinProbe
# ---------------------------------------------------------------------------

#: two LONG keys whose first join hashes are equal and whose key words
#: differ: a candidate the exact verify must reject
COLLIDE = (110526240400, 994712892952)


def _key_side(data, cap, device):
    """(batch, key DevVals) of a pydict ``{name: (type, values)}`` on the
    card at capacity ``cap``; every column is a key."""
    from spark_rapids_tpu_torch.batch import HostBatch, host_to_device
    from spark_rapids_tpu_torch.exprs.base import DevVal
    batch = host_to_device(HostBatch.from_pydict(data), device, capacity=cap)
    return batch, [DevVal.from_column(c) for c in batch.columns]


def probe_args(lkeys, l_rows, rkeys, r_rows):
    """joinProbe's inputs as ``join_pairs_static`` makes them."""
    from spark_rapids_tpu_torch.kernels import join as J
    l_h1, l_ok, l_live, perm, r_sorted = J._hashed_sides(
        lkeys, l_rows, rkeys, r_rows)
    a_words, a_valid = J._exact_words(lkeys)
    b_words, b_valid = J._exact_words(rkeys)
    return (l_h1, l_ok & l_live, r_sorted, perm, a_words, a_valid, b_words,
            b_valid)


def _pick(rng, values, n, null_frac):
    idx = rng.randint(0, len(values), n)
    return [None if rng.rand() < null_frac else values[i] for i in idx]


def probe_cases(device):
    """(name, args, pair_cap) of the joinProbe matrix: the CPU tests'
    cases, on the card, plus 2^20 probe rows against 2^22 build rows."""
    from spark_rapids_tpu_torch import types as T
    rng = np.random.RandomState(5)
    strs = ["", "a", "BUILDING", "MACHINERY", "\u00e9t\u00e9",
            "p" * 64 + "-one", "p" * 64 + "-two"]
    small = {
        "long": ([(T.LONG, range(12))], 40, 24, 0.1),
        "int": ([(T.INT, range(-8, 8))], 50, 30, 0.25),
        "date": ([(T.DATE, range(9190, 9215))], 60, 20, 0.1),
        "double": ([(T.DOUBLE, [0.0, -0.0, 1.5, -2.25, float("nan"),
                                float("inf"), 1e300])], 40, 14, 0.1),
        "string": ([(T.STRING, strs)], 40, 20, 0.1),
        "two-column": ([(T.LONG, range(4)),
                        (T.STRING, ["AIR", "RAIL", "", "TRUCK"])],
                       40, 24, 0.05),
        "dup-heavy": ([(T.LONG, [1, 2])], 24, 30, 0.1),
    }
    cases = []
    for name, (cols, nl, nr, nulls) in small.items():
        sides = []
        for n in (nl, nr):
            data = {f"k{i}": (t, _pick(rng, list(v), n, nulls))
                    for i, (t, v) in enumerate(cols)}
            sides.append(_key_side(data, 64, device))
        (lb, lk), (rb, rk) = sides
        for pair_cap in (128, 16):
            cases.append((f"{name} pair_cap={pair_cap}", probe_args(
                lk, lb.num_rows, rk, rb.num_rows), pair_cap))
    edge = {"h1-collision": ([COLLIDE[0], 7, COLLIDE[0], None, 3],
                             [COLLIDE[1], COLLIDE[1], 7, COLLIDE[0]]),
            "empty-probe": ([], list(range(5)) * 4),
            "empty-build": (list(range(5)) * 4, [])}
    for name, (lv, rv) in edge.items():
        lb, lk = _key_side({"k": (T.LONG, lv)}, 32, device)
        rb, rk = _key_side({"k": (T.LONG, rv)}, 32, device)
        cases.append((name, probe_args(lk, lb.num_rows, rk, rb.num_rows),
                      64))
    # a total past 2^31 - 1, where the int32 cum wraps: 2^16 probes and
    # 2^15 + 1 build rows of one key
    lb, lk = _key_side({"k": (T.LONG, [7] * (1 << 16))}, 1 << 16, device)
    rb, rk = _key_side({"k": (T.LONG, [7] * ((1 << 15) + 1))}, 1 << 16,
                       device)
    cases.append(("wrapped total", probe_args(lk, lb.num_rows, rk,
                                              rb.num_rows), 1 << 20))
    # 2^20 probes against 2^22 build rows, ~2 build rows per key, 20% of
    # the probes without a partner
    n_l, n_r, span = 1 << 20, 1 << 22, 1 << 21
    lb, lk = _key_side({"k": (T.LONG, rng.randint(0, span * 5 // 4, n_l))},
                       n_l, device)
    rb, rk = _key_side({"k": (T.LONG, rng.randint(0, span, n_r))}, n_r,
                       device)
    args = probe_args(lk, lb.num_rows, rk, rb.num_rows)
    cases.append(("2^20 x 2^22", args, 2 * n_l))
    cases.append(("2^20 x 2^22 pair_cap below total", args, n_l))
    return cases


def check_probe(args, pair_cap: int, label: str) -> int:
    """joinProbe against its plain version on the same inputs: all four
    outputs equal (torch.equal).  Returns the largest absolute difference
    of the outputs (0 when equal)."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_tier
    got = cuda_tier.probe_join(*args, pair_cap)
    want = cuda_tier.probe_join_reference(*args, pair_cap)
    torch.cuda.synchronize()
    for name, g, w in zip(("probe_row", "build_row", "match", "total"),
                          got, want):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"joinProbe != plain version on {label}: "
                                 f"{name}")
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def probe_bytes(args, pair_cap: int) -> int:
    """Bytes joinProbe must move on these inputs, counted from what this
    data needs (as the port hands them over: int64 hashes and words, int32
    permutation, bool masks): the probe mask of every row and the hash of
    every live row; the sorted build hashes once; the key words and
    validity of each probe row and each build row that fills one of the
    first min(total, pair_cap) slots, and the permutation entry of each
    such build row; every output written once (int32 probe and build rows,
    bool match, int64 total).  Build rows that no probe reaches are not
    read."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_tier
    l_h1, l_mask, r_sorted, perm, a_words, a_valid, b_words, b_valid = args
    probe_row, build_row, _, total = cuda_tier.probe_join_reference(
        *args, pair_cap)
    slots = min(int(total), pair_cap)
    n_probe = int(torch.unique(probe_row[:slots]).numel())
    n_build = int(torch.unique(build_row[:slots]).numel())
    w = int(a_words.shape[0])
    return (l_mask.numel() * l_mask.element_size()
            + int(l_mask.sum()) * l_h1.element_size()
            + r_sorted.numel() * r_sorted.element_size()
            + n_probe * (w * a_words.element_size() + a_valid.element_size())
            + n_build * (w * b_words.element_size() + b_valid.element_size()
                         + perm.element_size())
            + pair_cap * (4 + 4 + 1) + 8)


def probe_numbers(args, pair_cap: int, label: str) -> dict:
    """joinProbe at one of Q3's join shapes: wrapper ms, kernel alone (the
    call's two launches, ``graph_ms``), each launch's device ms
    (torch.profiler), plain ms, bound."""
    from spark_rapids_tpu_torch.kernels import cuda_tier
    out = kernel_numbers(
        lambda: cuda_tier.probe_join(*args, pair_cap),
        lambda: cuda_tier.probe_join_reference(*args, pair_cap),
        probe_bytes(args, pair_cap))
    out["launch_ms"] = launch_ms(lambda: cuda_tier.probe_join(*args,
                                                              pair_cap))
    out["shape"] = (f"{label}: {int(args[0].numel())} probe rows, "
                    f"{int(args[2].numel())} build rows, "
                    f"{int(args[4].shape[0])} key words, pair_cap {pair_cap}")
    return out


# ---------------------------------------------------------------------------
# main path: TPC-H Q3
# ---------------------------------------------------------------------------


def q3_groups_query(tables):
    """TPC-H Q3 before its ORDER BY and LIMIT: every group's revenue."""
    from spark_rapids_tpu_torch import functions as F
    c = tables["customer"].filter(F.col("c_mktsegment") == "BUILDING")
    o = tables["orders"].filter(F.col("o_orderdate") < 9204)
    li = tables["lineitem"].filter(F.col("l_shipdate") > 9204)
    return (c.join(o, F.col("c_custkey") == F.col("o_custkey"))
            .join(li, F.col("o_orderkey") == F.col("l_orderkey"))
            .group_by("o_orderkey", "o_orderdate", "o_shippriority")
            .agg(F.sum("l_extendedprice").alias("revenue")))


def q3_query(tables):
    """TPC-H Q3 as the repo defines it (benchmarks/tpch_like.py Q3)."""
    from spark_rapids_tpu_torch import functions as F
    return (q3_groups_query(tables)
            .order_by(F.col("revenue").desc(), "o_orderdate").limit(10))


def q3_reference(customer, orders, lineitem):
    """Independent Q3 over the same arrays.  The generators' keys are
    dense (c_custkey and o_orderkey are 1..n), so each join is an index
    lookup; a foreign key past n has no partner.  Returns the top 10
    groups as (o_orderkey, o_orderdate, o_shippriority, revenue) arrays,
    and under "groups" the same arrays for every group, by o_orderkey."""
    c = {k: np.asarray(v) for k, (_, v) in customer.items()}
    o = {k: np.asarray(v) for k, (_, v) in orders.items()}
    li = {k: np.asarray(v) for k, (_, v) in lineitem.items()}
    n_c, n_o = len(c["c_custkey"]), len(o["o_orderkey"])
    c_ok = np.append(c["c_mktsegment"] == "BUILDING", False)
    cust = np.minimum(o["o_custkey"] - 1, n_c)   # n_c: no partner
    o_ok = np.append((o["o_orderdate"] < 9204) & c_ok[cust], False)
    order = np.minimum(li["l_orderkey"] - 1, n_o)
    l_ok = (li["l_shipdate"] > 9204) & o_ok[order]
    revenue = np.bincount(order[l_ok], weights=li["l_extendedprice"][l_ok],
                          minlength=n_o)
    present = np.bincount(order[l_ok], minlength=n_o) > 0
    idx = np.nonzero(present[:n_o])[0]
    top = idx[np.lexsort((o["o_orderdate"][idx], -revenue[idx]))][:10]

    def rows(sel):
        return {"o_orderkey": o["o_orderkey"][sel],
                "o_orderdate": o["o_orderdate"][sel],
                "o_shippriority": o["o_shippriority"][sel],
                "revenue": revenue[sel]}

    return dict(rows(top), groups=rows(idx))


def check_q3_rows(rows, ref, label: str) -> None:
    """Keys and dates exact; revenue within 1e-9 relative: the aggregate
    sums each group's prices in another order than numpy, and every price
    is positive, so there is no cancellation to magnify."""
    if len(rows) != len(ref["revenue"]):
        raise AssertionError(f"{label}: {len(rows)} rows, numpy has "
                             f"{len(ref['revenue'])}")
    for i, name in enumerate(("o_orderkey", "o_orderdate",
                              "o_shippriority")):
        if [r[i] for r in rows] != [int(x) for x in ref[name]]:
            raise AssertionError(f"{label}: {name} differs from numpy")
    got = np.array([r[3] for r in rows], dtype=np.float64)
    if not np.all(np.isfinite(got)):
        raise AssertionError(f"{label}: non-finite revenue")
    np.testing.assert_allclose(got, ref["revenue"], rtol=1e-9, atol=0,
                               err_msg=f"{label}: revenue")


def check_q3_joins(session, label: str, fused: bool) -> None:
    """The last collect's joins ran the way its mode says: both fused and
    none rerun host-driven (at these sizes the static pair capacity holds
    every join, so a rerun would mean the fused output went unchecked),
    or none fused."""
    m = session.last_metrics
    want = {"meshJoinsFused": 2 if fused else 0, "joinOverflowFallback": 0}
    got = {k: m.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{label}: joins {got}, expected {want}")


def check_q3_groups(rows, ref, label: str) -> None:
    """Every group before the LIMIT against numpy's, ordered by
    o_orderkey, with check_q3_rows' tolerances: a pair the join dropped or
    doubled anywhere changes a group's revenue or the group count."""
    check_q3_rows(sorted(rows, key=lambda r: r[0]), ref["groups"],
                  f"{label} (all groups)")


def q3_tables(session, data, batch_rows):
    from spark_rapids_tpu_torch.dataframe import DataFrame
    from spark_rapids_tpu_torch.interop import host_batches
    from spark_rapids_tpu_torch.plan.logical import InMemoryScan
    out = {}
    for name, table in data.items():
        parts = host_batches(table, batch_rows)
        out[name] = DataFrame(InMemoryScan(parts, parts[0].schema, 1),
                              session).cache()
    return out


class Recorder:
    """Wraps ``cuda_tier.<name>`` while installed, keeping each call as
    (origin, args): the main path's own inputs for the checks and timings.
    ``origin`` is ``file:qualified name`` of the first caller outside
    ``cuda_tier.py`` and ``exprs/strings.py`` (``string_hash_rows`` and
    ``string_hash2`` go through ``string_hash_columns``).  A
    ``pack_column_windows`` call given its inputs as a ``PackInputs`` is
    kept with those inputs' columns in place of ``columns``.  The calls
    go through to the kernel unchanged."""

    _PASS = ("cuda_tier.py", "strings.py")

    def __init__(self, name: str):
        self.name = name
        self.calls = []

    def __enter__(self):
        from spark_rapids_tpu_torch.kernels import cuda_tier
        self._real = getattr(cuda_tier, self.name)

        def record(*args, **kwargs):
            f = sys._getframe(1)
            while f is not None and \
                    os.path.basename(f.f_code.co_filename) in self._PASS:
                f = f.f_back
            origin = ("?" if f is None else
                      f"{os.path.basename(f.f_code.co_filename)}:"
                      f"{f.f_code.co_qualname}")
            kept = args
            if kwargs.get("inputs") is not None and args[0] is None:
                kept = (kwargs["inputs"].columns,) + args[1:]
            self.calls.append((origin, kept))
            return self._real(*args, **kwargs)

        setattr(cuda_tier, self.name, record)
        return self

    def __exit__(self, *exc):
        from spark_rapids_tpu_torch.kernels import cuda_tier
        setattr(cuda_tier, self.name, self._real)
        return False


# ---------------------------------------------------------------------------
# main paths: the SQL texts through session.sql
# ---------------------------------------------------------------------------

#: the TPC-H texts the port runs (benchmarks/tpch_like.py); Q10 groups by
#: the DOUBLE c_acctbal, which needs spark.rapids.sql.hasNans off
SQL_SETTINGS = dict(SETTINGS, **{"spark.rapids.sql.hasNans": False})
SQL_JOIN_QUERIES = ("q3", "q5", "q10", "q12")
SUPPLIER_SF = 100   # 10,000 rows: TPC-H SF1's supplier count
#: Q5 fused does not fit the card at SF1's counts: a fused join's output
#: capacities are static and compound join by join (PERF.md §6 gives the
#: sizes), so it runs fused at generator sf 10 (lineitem 600,000 rows),
#: host-driven at SF1's counts
Q5_FUSED_SF = 10
#: the kernels each SQL query launches in every collect: gatherScatter at
#: the merge's concat of its partials or a join's side concat, stringHash
#: at a string key, '=' or IN; joinProbe besides on every fused way
SQL_KERNELS = {"q1": ("gatherScatter", "stringHash"),
               "q3": ("gatherScatter", "stringHash"),
               "q5": ("gatherScatter", "stringHash"),
               "q6": ("gatherScatter",),
               "q10": ("gatherScatter", "stringHash"),
               "q12": ("gatherScatter", "stringHash"),
               "q14": ("gatherScatter",),
               # the other fifteen texts, host-driven: gatherScatter
               # wherever a side or the partials span batches (lineitem's
               # 6 and orders' 2; part, partsupp and customer are one
               # batch each), contains at LIKE '%needle%'
               "q2": ("stringHash",),
               "q4": ("gatherScatter", "stringHash"),
               "q7": ("gatherScatter", "stringHash"),
               "q8": ("gatherScatter", "stringHash"),
               "q9": ("gatherScatter", "stringHash", "strings"),
               "q11": ("stringHash",),
               "q13": ("gatherScatter", "stringHash"),
               "q15": ("gatherScatter",),
               "q16": ("stringHash", "strings"),
               "q17": ("gatherScatter", "stringHash"),
               "q18": ("gatherScatter", "stringHash"),
               "q19": ("gatherScatter", "stringHash"),
               "q20": ("gatherScatter", "stringHash"),
               "q21": ("gatherScatter", "stringHash"),
               "q22": ("gatherScatter", "stringHash")}
#: the texts of the eighth slice (residual conditions, nested-loop and
#: cross joins, date parts, substring, count(DISTINCT)), host-driven
SQL_MORE = ("q2", "q4", "q7", "q8", "q9", "q11", "q13", "q15", "q16",
            "q17", "q18", "q19", "q20", "q21", "q22")
#: the texts whose plan holds a nested-loop join (their CROSS JOIN)
SQL_NESTED_LOOP = ("q11", "q15", "q22")
SQL_PART_SF = 100   # 200,000 part and 800,000 partsupp rows: TPC-H SF1's


def _np(table):
    return {k: np.asarray(v) for k, (_, v) in table.items()}


def _partner(keys, n):
    """Row index of each dense 1..n foreign key; n (one past the end,
    where the has-partner arrays hold False) for a key past n."""
    return np.minimum(np.asarray(keys) - 1, n)


def _top(idx, revenue, limit=None):
    """``idx`` ordered by revenue descending (stable), cut to ``limit``;
    a tie at the cut would leave the engine's choice open, so it fails."""
    order = idx[np.argsort(-revenue[idx], kind="stable")]
    if limit is not None and len(order) > limit:
        if revenue[order[limit - 1]] == revenue[order[limit]]:
            raise AssertionError("a revenue tie at the LIMIT")
        order = order[:limit]
    return order


def sql_references(data):
    """Independent numpy answers of Q5, Q6, Q10, Q12 and Q14 over the same
    arrays.  c_custkey, o_orderkey and s_suppkey are dense 1..n and
    n_nationkey 0..n-1, so each join is an index lookup; a foreign key
    past n has no partner.  Each answer: (column names, {name: array}, the
    key names compared exactly)."""
    c, o, li = _np(data["customer"]), _np(data["orders"]), \
        _np(data["lineitem"])
    s, n = _np(data["supplier"]), _np(data["nation"])
    n_c, n_o, n_s = len(c["c_custkey"]), len(o["o_orderkey"]), \
        len(s["s_suppkey"])
    cust = _partner(o["o_custkey"], n_c)
    has_cust = np.append(np.ones(n_c, bool), False)[cust]
    order = _partner(li["l_orderkey"], n_o)
    supp = _partner(li["l_suppkey"], n_s)
    price = li["l_extendedprice"]
    out = {}

    o_ok = np.append(has_cust & (o["o_orderdate"] >= 8766) &
                     (o["o_orderdate"] < 9131), False)
    l_ok = o_ok[order] & (supp < n_s)
    nation = s["s_nationkey"][supp[l_ok]]
    revenue = np.bincount(nation, weights=price[l_ok],
                          minlength=len(n["n_name"]))
    idx = _top(np.nonzero(np.bincount(nation, minlength=len(revenue)))[0],
               revenue)
    out["q5"] = (["n_name", "revenue"],
                 {"n_name": n["n_name"][idx], "revenue": revenue[idx]},
                 ["n_name"])

    ship = li["l_shipdate"]
    keep = (ship >= 8766) & (ship < 9131) & (li["l_discount"] >= 0.05) & \
        (li["l_discount"] <= 0.07) & (li["l_quantity"] < 24)
    out["q6"] = (["revenue"], {"revenue": np.array([price[keep].sum()])},
                 [])

    o_ok = np.append(has_cust & (o["o_orderdate"] >= 8766) &
                     (o["o_orderdate"] < 8766 + 90), False)
    l_ok = o_ok[order] & (li["l_returnflag"] == "R")
    who = cust[order[l_ok]]
    revenue = np.bincount(who, weights=price[l_ok], minlength=n_c)
    idx = _top(np.nonzero(np.bincount(who, minlength=n_c))[0], revenue, 20)
    out["q10"] = (["c_custkey", "c_name", "revenue", "c_acctbal"],
                  {"c_custkey": c["c_custkey"][idx],
                   "c_name": c["c_name"][idx], "revenue": revenue[idx],
                   "c_acctbal": c["c_acctbal"][idx]},
                  ["c_custkey", "c_name", "c_acctbal"])

    commit, receipt = li["l_commitdate"], li["l_receiptdate"]
    l_ok = np.isin(li["l_shipmode"], ["MAIL", "SHIP"]) & \
        (commit < receipt) & (ship < commit) & (receipt >= 8766) & \
        (receipt < 9131) & (order < n_o)
    modes, counts = np.unique(li["l_shipmode"][l_ok], return_counts=True)
    out["q12"] = (["l_shipmode", "mode_count"],
                  {"l_shipmode": modes, "mode_count": counts},
                  ["l_shipmode", "mode_count"])

    keep = (ship >= 9131) & (ship < 9161) & (li["l_discount"] > 0.02)
    out["q14"] = (["promo_revenue"],
                  {"promo_revenue": np.array([price[keep].sum()])}, [])
    return out


def _year(days):
    """Calendar year of each day since the epoch (numpy's calendar)."""
    return np.asarray(days).astype("datetime64[D]").astype(
        "datetime64[Y]").astype(np.int64) + 1970


def _group_rows(*keys):
    """(unique key columns, group index of each row) of the rows' key
    tuples, groups in ascending key order."""
    uniq, inv = np.unique(np.rec.fromarrays(keys), return_inverse=True)
    return [uniq[f] for f in uniq.dtype.names], inv.ravel()


def _pair_index(a, b, keys_a, keys_b, n):
    """Row of (keys_a, keys_b) holding each (a, b) pair, or -1: both key
    pairs packed into one int64 (b < n)."""
    table = keys_a.astype(np.int64) * (n + 2) + keys_b
    order = np.argsort(table, kind="stable")
    probe = np.asarray(a, np.int64) * (n + 2) + b
    at = np.searchsorted(table[order], probe)
    at_c = np.minimum(at, len(order) - 1)
    hit = (at < len(order)) & (table[order][at_c] == probe)
    return np.where(hit, order[at_c], -1)


def _ordered(cols, keys, limit=None):
    """Every column of ``cols`` in the order of ``keys`` (first key
    major; a key array is negated for descending), cut to ``limit``."""
    order = np.lexsort(tuple(reversed(keys)))
    if limit is not None:
        order = order[:limit]
    return {k: v[order] for k, v in cols.items()}


def sql_references_more(data):
    """Independent numpy answers of Q2, Q4, Q7, Q8, Q9, Q11, Q13 and
    Q15-Q22 (``benchmarks/tpch_like.py``) over the same arrays, in the
    form of :func:`sql_references`.  Every order the texts ask for is a
    total order of the answer here (its last keys are unique), so a LIMIT
    cuts at one place.  A join to a dense key is an index lookup (one past
    the end: no partner); partsupp's (partkey, suppkey) pairs and
    lineitem's (orderkey, suppkey) pairs are found by a sorted search."""
    c, o, li = _np(data["customer"]), _np(data["orders"]), \
        _np(data["lineitem"])
    s, n, r = _np(data["supplier"]), _np(data["nation"]), \
        _np(data["region"])
    p, ps = _np(data["part"]), _np(data["partsupp"])
    n_c, n_o, n_s, n_p = len(c["c_custkey"]), len(o["o_orderkey"]), \
        len(s["s_suppkey"]), len(p["p_partkey"])
    region_of = r["r_name"][n["n_regionkey"]]     # nation -> region name
    s_nat = s["s_nationkey"]
    l_ord = _partner(li["l_orderkey"], n_o)
    l_supp = _partner(li["l_suppkey"], n_s)
    l_part = _partner(li["l_partkey"], n_p)
    o_cust = _partner(o["o_custkey"], n_c)
    o_ok = np.append(o_cust < n_c, False)          # order has a customer
    l_cust = np.append(o_cust, n_c)[l_ord]
    price, qty = li["l_extendedprice"], li["l_quantity"]
    ship = li["l_shipdate"]
    commit, receipt = li["l_commitdate"], li["l_receiptdate"]
    out = {}

    # Q2: the cheapest European supplier of each size-15 part
    ps_s = ps["ps_suppkey"] - 1
    ps_p = ps["ps_partkey"] - 1
    cost = ps["ps_supplycost"]
    eu = region_of[s_nat[ps_s]] == "EUROPE"
    min_cost = np.full(n_p, np.inf)
    np.minimum.at(min_cost, ps_p[eu], cost[eu])
    keep = eu & (p["p_size"][ps_p] == 15) & (cost == min_cost[ps_p])
    rows = {"s_acctbal": s["s_acctbal"][ps_s[keep]],
            "s_name": s["s_name"][ps_s[keep]],
            "n_name": n["n_name"][s_nat[ps_s[keep]]],
            "p_partkey": ps["ps_partkey"][keep],
            "p_mfgr": p["p_mfgr"][ps_p[keep]]}
    out["q2"] = (list(rows), _ordered(rows, [
        -rows["s_acctbal"], rows["n_name"], rows["s_name"],
        rows["p_partkey"]], 100),
        ["s_name", "n_name", "p_partkey", "p_mfgr"])

    # Q4: orders of a quarter with a late line, by priority
    late = np.zeros(n_o + 1, bool)
    late[l_ord[commit < receipt]] = True
    od = o["o_orderdate"]
    keep = late[:n_o] & (od >= 8582) & (od < 8674)
    prio, counts = np.unique(o["o_orderpriority"][keep], return_counts=True)
    out["q4"] = (["o_orderpriority", "order_count"],
                 {"o_orderpriority": prio, "order_count": counts},
                 ["o_orderpriority", "order_count"])

    # Q7: revenue between France and Germany by year
    ok = (l_supp < n_s) & (l_ord < n_o) & (l_cust < n_c)
    sn = np.where(ok, n["n_name"][s_nat[np.minimum(l_supp, n_s - 1)]], "")
    cn = np.where(ok, n["n_name"][c["c_nationkey"][
        np.minimum(l_cust, n_c - 1)]], "")
    keep = ok & (((sn == "FRANCE") & (cn == "GERMANY")) |
                 ((sn == "GERMANY") & (cn == "FRANCE"))) & \
        (ship >= 9131) & (ship <= 9861)
    (gs, gc, gy), inv = _group_rows(sn[keep], cn[keep], _year(ship[keep]))
    out["q7"] = (["supp_nation", "cust_nation", "l_year", "revenue"],
                 {"supp_nation": gs, "cust_nation": gc, "l_year": gy,
                  "revenue": np.bincount(inv, weights=price[keep],
                                         minlength=len(gs))},
                 ["supp_nation", "cust_nation", "l_year"])

    # Q8: Brazil's share of America's revenue by order year
    ok = (l_part < n_p) & (l_supp < n_s) & (l_ord < n_o) & (l_cust < n_c)
    lp, ls = np.minimum(l_part, n_p - 1), np.minimum(l_supp, n_s - 1)
    lo, lc = np.minimum(l_ord, n_o - 1), np.minimum(l_cust, n_c - 1)
    odate = od[lo]
    keep = ok & (region_of[c["c_nationkey"][lc]] == "AMERICA") & \
        (odate >= 9131) & (odate <= 9861) & (p["p_size"][lp] < 30)
    (years,), inv = _group_rows(_year(odate[keep]))
    brazil = np.where(n["n_name"][s_nat[ls[keep]]] == "BRAZIL",
                      price[keep], 0.0)
    out["q8"] = (["o_year", "mkt_share"],
                 {"o_year": years,
                  "mkt_share": np.bincount(inv, weights=brazil) /
                  np.bincount(inv, weights=price[keep])}, ["o_year"])

    # Q9: profit of the green parts by nation and year
    at = _pair_index(li["l_partkey"], li["l_suppkey"], ps["ps_partkey"],
                     ps["ps_suppkey"], n_s)
    green = np.char.find(p["p_name"], "green") >= 0
    keep = (at >= 0) & (l_supp < n_s) & (l_ord < n_o) & (l_part < n_p)
    keep &= green[lp]
    profit = price * (1 - li["l_discount"]) - \
        ps["ps_supplycost"][at] * qty
    (gn, gy), inv = _group_rows(n["n_name"][s_nat[ls[keep]]],
                            _year(od[lo[keep]]))
    rows = {"n_name": gn, "o_year": gy,
            "profit": np.bincount(inv, weights=profit[keep],
                                  minlength=len(gn))}
    out["q9"] = (list(rows), _ordered(rows, [gn, -gy]), ["n_name", "o_year"])

    # Q11: the German stock worth more than 0.01 % of the total
    de = n["n_name"][s_nat[ps_s]] == "GERMANY"
    worth = cost * ps["ps_availqty"]
    value = np.bincount(ps_p[de], weights=worth[de], minlength=n_p)
    held = np.bincount(ps_p[de], minlength=n_p) > 0
    keep = held & (value > worth[de].sum() * 0.0001)
    rows = {"ps_partkey": np.nonzero(keep)[0] + 1, "value": value[keep]}
    out["q11"] = (list(rows), _ordered(rows, [-rows["value"],
                                              rows["ps_partkey"]]),
                  ["ps_partkey"])

    # Q13: customers by their count of orders that are not urgent
    mine = (o_cust < n_c) & (o["o_orderpriority"] != "1-URGENT")
    per = np.bincount(o_cust[mine], minlength=n_c)
    c_count, custdist = np.unique(per, return_counts=True)
    rows = {"c_count": c_count, "custdist": custdist}
    out["q13"] = (list(rows), _ordered(rows, [-custdist, -c_count]),
                  list(rows))

    # Q15: the suppliers of the largest quarter revenue
    keep = (ship >= 9496) & (ship < 9587)
    rev = np.bincount(li["l_suppkey"][keep], weights=price[keep],
                      minlength=n_s + 2)
    has = np.bincount(li["l_suppkey"][keep], minlength=n_s + 2) > 0
    top = rev[has].max()
    best = np.nonzero(has & (np.abs(rev - top) <= top * 0.000001))[0]
    best = best[best <= n_s]
    out["q15"] = (["s_suppkey", "s_name", "total_revenue"],
                  {"s_suppkey": best, "s_name": s["s_name"][best - 1],
                   "total_revenue": rev[best]}, ["s_suppkey", "s_name"])

    # Q16: suppliers of the sizes asked for, without complaints
    bad = np.char.find(s["s_name"], "0000009") >= 0
    keep = ~bad[ps_s] & (p["p_brand"][ps_p] != "Brand#45") & \
        np.isin(p["p_size"][ps_p], [1, 4, 7, 10, 15])
    (gb, gt, gz, _), inv = _group_rows(p["p_brand"][ps_p[keep]],
                                   p["p_type"][ps_p[keep]],
                                   p["p_size"][ps_p[keep]],
                                   ps["ps_suppkey"][keep])
    (gb, gt, gz), inv2 = _group_rows(gb, gt, gz)
    rows = {"p_brand": gb, "p_type": gt, "p_size": gz,
            "supplier_cnt": np.bincount(inv2, minlength=len(gb))}
    out["q16"] = (list(rows), _ordered(rows, [
        -rows["supplier_cnt"], gb, gt, gz], 100), list(rows))

    # Q17: small orders of Brand#23 parts
    pk = li["l_partkey"]
    avg_qty = np.bincount(pk, weights=qty) / np.maximum(np.bincount(pk), 1)
    keep = (l_part < n_p) & (p["p_brand"][lp] == "Brand#23") & \
        (qty < avg_qty[pk] * 0.5)
    out["q17"] = (["avg_yearly"],
                  {"avg_yearly": np.array([price[keep].sum() / 7.0])}, [])

    # Q18: orders of more than 150 units, with their customers
    big_qty = np.bincount(l_ord, weights=qty, minlength=n_o + 1)[:n_o]
    keep = (big_qty > 150) & (o_cust < n_c)
    idx = np.nonzero(keep)[0]
    rows = {"c_name": c["c_name"][o_cust[idx]],
            "c_custkey": c["c_custkey"][o_cust[idx]],
            "o_orderkey": o["o_orderkey"][idx], "o_orderdate": od[idx],
            "o_totalprice": o["o_totalprice"][idx],
            "total_qty": big_qty[idx]}
    out["q18"] = (list(rows), _ordered(rows, [
        -rows["o_totalprice"], rows["o_orderdate"], rows["o_orderkey"]],
        100), ["c_name", "c_custkey", "o_orderkey", "o_orderdate"])

    # Q19: three kinds of parts bought in some quantity
    brand, cont = p["p_brand"][lp], p["p_container"][lp]
    size = p["p_size"][lp]

    def kind(b, conts, lo, hi, max_size):
        return (brand == b) & np.isin(cont, conts) & (qty >= lo) & \
            (qty <= hi) & (size >= 1) & (size <= max_size)

    keep = (l_part < n_p) & (
        (kind("Brand#12", ["SM CASE", "SM BOX", "SM PACK", "SM PKG"],
              1, 11, 5) & np.isin(li["l_shipmode"], ["AIR", "REG AIR"])) |
        kind("Brand#23", ["MED BAG", "MED BOX", "MED PKG", "MED PACK"],
             10, 20, 10) |
        kind("Brand#34", ["LG CASE", "LG BOX", "LG PACK", "LG PKG"],
             20, 30, 15))
    out["q19"] = (["revenue"], {"revenue": np.array([price[keep].sum()])},
                  [])

    # Q20: Canadian suppliers with excess stock of forest parts
    keep = (ship >= 8766) & (ship < 9131)
    (hp, hs), inv = _group_rows(li["l_partkey"][keep], li["l_suppkey"][keep])
    period = np.bincount(inv, weights=qty[keep], minlength=len(hp))
    at = _pair_index(ps["ps_partkey"], ps["ps_suppkey"], hp, hs, n_s)
    forest = np.char.startswith(p["p_name"], "forest")
    ok = forest[ps_p] & (at >= 0)
    ok &= ps["ps_availqty"] > period[np.maximum(at, 0)] * 0.5
    good = np.zeros(n_s, bool)
    good[ps_s[ok]] = True
    keep = good & (n["n_name"][s_nat] == "CANADA")
    out["q20"] = (["s_name"], {"s_name": np.sort(s["s_name"][keep])},
                  ["s_name"])

    # Q21: German suppliers who alone kept a multi-supplier order waiting
    lk, sk = li["l_orderkey"], li["l_suppkey"]
    is_late = receipt > commit

    def others(rows_mask):
        """Per lineitem row: rows of ``rows_mask`` in its order with
        another supplier."""
        per_order = np.bincount(lk[rows_mask], minlength=n_o + 2)
        (po, psk), inv = _group_rows(lk[rows_mask], sk[rows_mask])
        per_pair = np.bincount(inv, minlength=len(po))
        at = _pair_index(lk, sk, po, psk, n_s)
        same = np.where(at >= 0, per_pair[np.maximum(at, 0)], 0)
        return per_order[lk] - same

    keep = (l_ord < n_o) & (l_supp < n_s) & is_late
    keep &= np.append(o["o_orderstatus"] == "F", False)[l_ord]
    keep &= n["n_name"][s_nat[ls]] == "GERMANY"
    keep &= (others(np.ones(len(lk), bool)) > 0) & (others(is_late) == 0)
    names, counts = np.unique(s["s_name"][ls[keep]], return_counts=True)
    rows = {"s_name": names, "numwait": counts}
    out["q21"] = (list(rows), _ordered(rows, [-counts, names], 100),
                  list(rows))

    # Q22: rich customers of some countries who never ordered
    bal = c["c_acctbal"]
    code = np.array([x[:2] for x in c["c_phone"].tolist()])
    has_order = np.bincount(o["o_custkey"], minlength=n_c + 2)[1:n_c + 1] > 0
    keep = (bal > bal[bal > 0.0].mean()) & ~has_order & \
        np.isin(code, ["13", "31", "23", "29", "30", "18", "17"])
    (codes,), inv = _group_rows(code[keep])
    out["q22"] = (["cntrycode", "numcust", "totacctbal"],
                  {"cntrycode": codes,
                   "numcust": np.bincount(inv, minlength=len(codes)),
                   "totacctbal": np.bincount(inv, weights=bal[keep],
                                             minlength=len(codes))},
                  ["cntrycode", "numcust"])
    return out


def check_sql_rows(rows, ref, label: str) -> None:
    """Keys and counts exact, in order; sums within 1e-9 relative: the
    port sums each group's prices in another order than numpy (the merge
    with atomics), and every price is positive, so there is no
    cancellation to magnify."""
    names, want, exact = ref
    n = len(next(iter(want.values())))
    if len(rows) != n:
        raise AssertionError(f"{label}: {len(rows)} rows, numpy has {n}")
    for i, name in enumerate(names):
        got = [r[i] for r in rows]
        if name in exact:
            if got != want[name].tolist():
                raise AssertionError(f"{label}: {name} differs from numpy")
            continue
        g = np.array(got, dtype=np.float64)
        if not np.all(np.isfinite(g)):
            raise AssertionError(f"{label}: non-finite {name}")
        np.testing.assert_allclose(g, want[name], rtol=1e-9, atol=0,
                                   err_msg=f"{label}: {name}")


def check_same_rows(rows, other, label: str) -> None:
    """The SQL form's rows against the DataFrame form's from the same run:
    ints and strings exact, in order; floats within 1e-9 relative (the
    merge's atomics sum in another order each collect)."""
    if len(rows) != len(other):
        raise AssertionError(f"{label}: {len(rows)} rows against "
                             f"{len(other)}")
    for r, w in zip(rows, other):
        for g, x in zip(r, w):
            ok = (abs(g - x) <= 1e-9 * abs(x)) if isinstance(x, float) \
                else g == x
            if not ok:
                raise AssertionError(f"{label}: {r} against {w}")


def sql_tables(session, data, batch_rows):
    """The tables cached as batches of ``batch_rows`` rows and registered
    as the session's views."""
    for name, df in q3_tables(session, data, batch_rows).items():
        df.create_or_replace_temp_view(name)


def sql_query(session, name: str):
    """The DataFrame of one of the port's TPC-H texts."""
    from spark_rapids_tpu_torch.benchmarks.tpch_like import QUERIES
    return lambda _: session.sql(QUERIES[name])


def run_sql(session, name: str, check, label: str) -> dict:
    """``run_path`` of one TPC-H text through :func:`run_checked`."""
    return run_checked(sql_query(session, name), check, label)


def run_checked(query, check, label: str, on_gpu: bool = True,
                concats: bool = False) -> dict:
    """``run_path`` of one query with stringHash, joinProbe and contains
    recorded, then each call of the second collect held equal to its plain
    version on its own inputs: a launch at a shape no earlier path makes
    is checked where it ran (and a fused join that overflows and reruns
    host-driven throws joinProbe's output away, so no row check sees it).
    With ``concats`` every gatherScatter call (``pack_columns``) of the
    second collect is recorded and checked too.  Returns the path, the
    recorded (origin, args) calls and the largest differences (0 when
    equal)."""
    import contextlib
    with Recorder("probe_join") as probes, \
            Recorder("string_hash_columns") as hashes, \
            Recorder("rows_with_match") as matches, \
            (Recorder("pack_columns") if concats else
             contextlib.nullcontext()) as packs, \
            (Recorder("pack_column_windows") if concats else
             contextlib.nullcontext()) as windows:
        recorders = (probes, hashes, matches) + \
            ((packs, windows) if concats else ())
        path = run_path(None, query, check, label, recorders,
                        on_gpu=on_gpu)
    launches = path["collect2"]["launches"]
    n_packs = len(packs.calls) + len(windows.calls) if concats else 0
    if len(hashes.calls) < launches["stringHash"] or \
            len(probes.calls) != launches["joinProbe"] or \
            len(matches.calls) < launches["strings"] or \
            (concats and n_packs < launches["gatherScatter"]):
        raise AssertionError(f"{label}: {len(hashes.calls)} stringHash, "
                             f"{len(probes.calls)} joinProbe, "
                             f"{len(matches.calls)} contains and "
                             f"{n_packs if concats else '-'} "
                             f"gatherScatter calls recorded for launches "
                             f"{launches}")
    for i, (origin, args) in enumerate(packs.calls if concats else ()):
        check_columns(*args, f"{label}, concat {i} ({origin})")
    for i, (origin, args) in enumerate(windows.calls if concats else ()):
        check_windows(*args, f"{label}, piece {i} ({origin})")
    hash_err = max((check_hashes(args[0], f"{label}, {origin}")
                    for origin, args in hashes.calls), default=0)
    probe_err = max((check_probe(args[:-1], args[-1], f"{label}, join {i}")
                     for i, (_, args) in enumerate(probes.calls)), default=0)
    for origin, args in matches.calls:
        check_contains(*args, f"{label}, {origin}")
    origins = sorted({origin for origin, _ in hashes.calls})
    packed = f", {n_packs} gatherScatter calls" if concats else ""
    print(f"{label}: the second collect's {len(hashes.calls)} stringHash "
          f"calls ({', '.join(origins) or 'none'}), {len(probes.calls)} "
          f"joinProbe calls{packed} and {len(matches.calls)} contains "
          "calls == plain versions on their own inputs", flush=True)
    return {"path": path, "probes": probes.calls, "hashes": hashes.calls,
            "matches": matches.calls, "hash_err": hash_err,
            "probe_err": probe_err, "packs": n_packs,
            "windows": windows.calls if concats else []}


def check_contains(data, offsets, needle: bytes, label: str) -> None:
    """contains against its plain version on the same inputs: the row
    flags equal (torch.equal)."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_tier
    got = cuda_tier.rows_with_match(data, offsets, needle)
    want = cuda_tier.rows_with_match_reference(data, offsets, needle)
    if not torch.equal(got, want):
        raise AssertionError(f"contains != plain version on {label}")


def run_sql_more(session, refs, kept=None):
    """The fifteen texts of :data:`SQL_MORE`, host-driven, each through
    :func:`run_sql` with its rows held to ``refs`` (and kept in ``kept``
    under "sql <name> host-driven" when given).  Every text runs before
    any failure is reported, so one run names them all.  Returns
    ({label: (run_sql's result, the query's metrics)}, [faults])."""
    runs, faults = {}, []
    kept = {} if kept is None else kept

    def check(rows, name, label):
        check_sql_rows(rows, refs[name], label)
        kept[f"sql {name} host-driven"] = rows

    for name in SQL_MORE:
        label = f"SQL {name.upper()} host-driven"
        try:
            rec = run_sql(session, name,
                          lambda rows, n=name, lb=label: check(rows, n, lb),
                          label)
        except Exception as e:  # noqa: BLE001  (named with the others)
            faults.append(f"{label}: {type(e).__name__}: {e}")
            print(f"{label}: FAILED {type(e).__name__}: {e}", flush=True)
            continue
        metrics = dict(session.last_metrics)
        plan = session.last_physical_plan.tree_string()
        c2 = rec["path"]["collect2"]
        print(f"{label}: {c2['rows']} rows, collect {c2['wall_s'] * 1e3:.1f}"
              f" ms, launches {c2['launches']}, metrics {metrics}",
              flush=True)
        if not len(next(iter(refs[name][1].values()))):
            print(f"{label}: the numpy answer is empty", flush=True)
        missing = [k for k in SQL_KERNELS[name]
                   if any(rec["path"][f"collect{i}"]["launches"][k] == 0
                          for i in (1, 2))]
        if missing:
            faults.append(f"{label} never launched {missing}")
        if c2["launches"]["joinProbe"]:
            faults.append(f"{label} launched joinProbe")
        if ("GpuNestedLoopJoin" in plan) != (name in SQL_NESTED_LOOP):
            faults.append(f"{label}: a nested-loop join in the plan is "
                          f"{'GpuNestedLoopJoin' in plan}")
        runs[label] = (rec, metrics)
    return runs, faults


def largest(calls, origin: str):
    """The recorded stringHash call from ``origin`` over the most rows."""
    mine = [args[0] for o, args in calls if o == origin]
    if not mine:
        raise AssertionError(f"no stringHash call from {origin}")
    return max(mine, key=lambda cols: sum(int(off.numel()) for _, off in cols))


# ---------------------------------------------------------------------------
# main paths over parquet files: the scan lane
# ---------------------------------------------------------------------------

SCAN_ROWS = 1 << 22  # bench.py:SCAN_ROWS: 4 row groups at pyarrow's default
#: bench.py's scan query three ways: the v2 scan with the staging
#: read-ahead at its default (2 batches), the same staged synchronously on
#: the consumer's stream, and the v1 scan
SCAN_MODES = {
    "v2, read-ahead 2": {},
    "v2, read-ahead 0": {"spark.rapids.sql.tpu.stage.readAheadBatches": 0},
    "v1": {"spark.rapids.sql.tpu.scan.v2.enabled": False},
}


def scan_query(df):
    """bench.py:time_scan_engine's query."""
    from spark_rapids_tpu_torch import functions as F
    return (df
            .filter((df["ss_quantity"] < 25) &
                    (df["ss_ext_discount_amt"] > 10.0))
            .with_column("revenue",
                         df["ss_sales_price"] * df["ss_ext_discount_amt"])
            .group_by("ss_item_sk")
            .agg(F.sum("revenue").alias("sum_rev"),
                 F.count("revenue").alias("cnt")))


def scan_reference(data):
    """Independent group-by of the scan query: item keys ascending, each
    group's revenue sum and count."""
    col = {k: v for k, (_, v) in data.items()}
    keep = (col["ss_quantity"] < 25) & (col["ss_ext_discount_amt"] > 10.0)
    rev = col["ss_sales_price"][keep] * col["ss_ext_discount_amt"][keep]
    item, gid = np.unique(col["ss_item_sk"][keep], return_inverse=True)
    return {"item": item, "cnt": np.bincount(gid),
            "sum_rev": np.bincount(gid, weights=rev)}


def check_scan_rows(rows, ref, label: str) -> None:
    """Keys and counts exact; sums within 1e-9 relative (another summing
    order than numpy's; every revenue is >= 0).  The query has no ORDER
    BY, so rows are compared by key."""
    rows = sorted(rows)
    if len(rows) != len(ref["item"]):
        raise AssertionError(f"{label}: {len(rows)} rows, numpy has "
                             f"{len(ref['item'])}")
    if [r[0] for r in rows] != ref["item"].tolist() or \
            [r[2] for r in rows] != ref["cnt"].tolist():
        raise AssertionError(f"{label}: keys or counts differ from numpy")
    got = np.array([r[1] for r in rows], dtype=np.float64)
    if not np.all(np.isfinite(got)):
        raise AssertionError(f"{label}: non-finite sum_rev")
    np.testing.assert_allclose(got, ref["sum_rev"], rtol=1e-9, atol=0,
                               err_msg=f"{label}: sum_rev")


def write_tables(data, root: str) -> dict:
    """Each generator table as one parquet file (pyarrow's default row
    groups) in a directory of its own under ``root``; name -> directory."""
    from spark_rapids_tpu_torch.benchmarks import datagen
    out = {}
    for name, table in data.items():
        out[name] = os.path.join(root, name)
        os.makedirs(out[name], exist_ok=True)
        datagen.write_parquet(table, os.path.join(out[name],
                                                  "part-0.parquet"))
    return out


def parquet_views(session, dirs: dict) -> None:
    for name, path in dirs.items():
        session.read.parquet(path).create_or_replace_temp_view(name)


def join_strategies(session) -> list:
    """(exec, how) of every join in the last physical plan, top down."""
    out, todo = [], [session.last_physical_plan]
    while todo:
        op = todo.pop(0)
        if "HashJoin" in type(op).__name__:
            out.append(f"{type(op).__name__}({op.how})")
        todo.extend(op.children)
    return out


def cast_edges():
    """DOUBLE and FLOAT values at and around the integral types' bounds,
    NaN and both infinities, with each cast's answer by Java's rules
    computed in plain Python: NaN is 0, a value at or past a bound is the
    bound, the rest truncates toward zero."""
    dbl = [float("nan"), float("inf"), float("-inf"), 2.0 ** 63,
           -(2.0 ** 63), 2.0 ** 63 - 1024, -(2.0 ** 63) + 1024, 1e300,
           2.0 ** 31 - 1, 2.0 ** 31, 2.0 ** 31 + 1, -(2.0 ** 31),
           -(2.0 ** 31) - 1, 2147483647.5, -2147483648.5, 32767.9, 32768.0,
           -32769.0, 127.5, 128.0, -129.0, -0.0, 0.9, -0.9, 3.0]
    with np.errstate(over="ignore"):
        flt = np.array(dbl, dtype=np.float32).astype(np.float64).tolist()
    bounds = {"int": 31, "bigint": 63, "smallint": 15, "tinyint": 7}

    def java(v, bits):
        lo, hi = -(2 ** bits), 2 ** bits - 1
        if v != v:
            return 0
        if v >= hi:
            return hi
        if v <= lo:
            return lo
        return int(v)

    # a FLOAT compares with the bound rounded to float, as torch and XLA do
    def java_f32(v, bits):
        hi_f = float(np.float32(2 ** bits - 1))
        lo = -(2 ** bits)
        if v != v:
            return 0
        if v >= hi_f:
            return 2 ** bits - 1
        if v <= lo:
            return lo
        return int(v)

    want = {f"d_{t}": [java(v, b) for v in dbl] for t, b in bounds.items()}
    want.update({f"f_{t}": [java_f32(v, b) for v in flt]
                 for t, b in bounds.items()})
    return dbl, flt, want


def check_cast_edges(device) -> int:
    """The casts from DOUBLE and FLOAT to each integral type on the card
    against Java's rules and against the same projection on the CPU."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.session import GpuSparkSession
    dbl, flt, want = cast_edges()
    rows = {}
    for dev in (device, "cpu"):
        session = GpuSparkSession(RapidsConf(SETTINGS), device=dev)
        df = session.create_dataframe({"d": (T.DOUBLE, dbl),
                                       "f": (T.FLOAT, flt)})
        cols = [df[src].cast(t).alias(f"{src}_{t}") for src in ("d", "f")
                for t in ("int", "bigint", "smallint", "tinyint")]
        got = df.select(*cols).collect()
        rows[str(dev)] = got
        for i, name in enumerate(c.expr.alias_name for c in cols):
            if [r[i] for r in got] != want[name]:
                raise AssertionError(f"cast {name} on {dev} differs from "
                                     "Java's rules")
    if rows[str(device)] != rows["cpu"]:
        raise AssertionError("casts differ between the card and the CPU")
    return len(dbl) * 8


# ---------------------------------------------------------------------------
# the fallback phase: operators the planner places on the host
# ---------------------------------------------------------------------------

#: SETTINGS without variableFloatAgg: Q1's float sums and averages go to
#: the host, as a user who leaves the confs alone gets them
FALLBACK_Q1_SETTINGS = {k: v for k, v in SETTINGS.items()
                        if k != "spark.rapids.sql.variableFloatAgg.enabled"}
#: per path: its settings over SETTINGS, the logical nodes its explain
#: must place on the host, and the kernels each collect must launch
FALLBACK_PATHS = {
    "a": ("SQL Q1, aggregate on the host", "q1", FALLBACK_Q1_SETTINGS,
          ("Aggregate",), ("stringHash",)),
    "b": ("SQL Q10 at the default hasNans", "q10", SETTINGS,
          ("Aggregate",), ("stringHash",)),
    "c": ("part query, exec.Aggregate off", None,
          dict(SETTINGS, **{"spark.rapids.sql.exec.Aggregate": False}),
          ("Aggregate",), ("strings", "stringHash")),
    "d": ("SQL Q6, spark.rapids.sql.enabled off", "q6",
          dict(SQL_SETTINGS, **{"spark.rapids.sql.enabled": False}),
          ("Filter", "Aggregate", "InMemoryScan"), ()),
}


def placement(session):
    """(host nodes, GPU nodes) of the last plan's explain: the logical
    node names of its "!" and "*" lines."""
    host, gpu = [], []
    for line in session.last_explain.splitlines():
        line = line.strip()
        name = line[1:].split(" ", 1)[0]
        (host if line.startswith("!") else gpu).append(name)
    return host, gpu


def host_numbers(session) -> dict:
    """The last query's host side from its per-operator metrics: the host
    operators' own ms, the transitions' bytes and the copies' ms."""
    out = {"host_ops_ms": 0.0, "d2h_bytes": 0, "d2h_ms": 0.0,
           "h2d_bytes": 0, "h2d_stage_ms": 0.0, "host_ops": {}}
    for op_id, ms in session.last_op_metrics.items():
        name = op_id.split("@", 1)[0]
        if "hostTime" in ms:
            out["host_ops_ms"] += ms["hostTime"] * 1e3
            out["host_ops"][name] = out["host_ops"].get(name, 0.0) + \
                ms["hostTime"] * 1e3
        out["d2h_bytes"] += int(ms.get("d2hBytes", 0))
        out["d2h_ms"] += ms.get("d2hTime", 0.0) * 1e3
        out["h2d_bytes"] += int(ms.get("h2dBytes", 0))
        out["h2d_stage_ms"] += ms.get("stageTime", 0.0) * 1e3
    return out


def run_fallback(key, session, query, check) -> dict:
    """One path of the fallback phase through :func:`run_checked` (not
    held to the test mode): its kernels' calls held to their plain
    versions on the columns the host operators built and the transitions
    staged, its placement held to :data:`FALLBACK_PATHS`, its explain
    lines, collect ms, host numbers and launches printed."""
    label, _, _, host_nodes, need = FALLBACK_PATHS[key]
    label = f"fallback ({key}) {label}"
    checked = run_checked(query, check, label, on_gpu=False)
    path = checked["path"]
    host, gpu = placement(session)
    print(f"{label}: explain\n{session.last_explain}", flush=True)
    missing = [n for n in host_nodes if n not in host]
    if missing:
        raise AssertionError(f"{label}: {missing} not placed on the host "
                             f"(host {host}, GPU {gpu})")
    nums = host_numbers(session)
    for i in (1, 2):
        launches = path[f"collect{i}"]["launches"]
        for name in need:
            if launches[name] == 0:
                raise AssertionError(f"{label} collect {i} never launched "
                                     f"{name}")
    c2 = path["collect2"]
    print(f"{label}: {c2['rows']} rows, collect {c2['wall_s'] * 1e3:.1f} "
          f"ms, host operators {nums['host_ops_ms']:.1f} ms "
          f"{ {k: round(v, 2) for k, v in nums['host_ops'].items()} }, "
          f"DeviceToHost {nums['d2h_bytes']} bytes in {nums['d2h_ms']:.1f} "
          f"ms, HostToDevice {nums['h2d_bytes']} bytes "
          f"({nums['h2d_stage_ms']:.1f} ms staging), launches "
          f"{c2['launches']}\nplan\n"
          f"{session.last_physical_plan.tree_string()}", flush=True)
    return {"path": path, "host": host, "gpu": gpu, "numbers": nums,
            "checked_calls": {"stringHash": len(checked["hashes"]),
                              "contains": len(checked["matches"]),
                              "joinProbe": len(checked["probes"])}}


def fallback_phase(sql_data, sql_refs, q1_names, q1_ref, part_df,
                   part_names, part_ref, batch_rows) -> dict:
    """The fallback phase's four paths over the tables the earlier phases
    made: (a) SQL Q1 with its aggregate on the host and its sort on the
    device, (b) SQL Q10 with its aggregate keyed on the DOUBLE c_acctbal
    on the host between device joins and a device sort and limit, (c) the
    part query with its string-keyed aggregate switched off the device
    and the contains filter on it, (d) SQL Q6 wholly on the host, no
    launch and no device allocation; then the test mode over (a), which
    must raise naming the aggregate."""
    import torch
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.dataframe import DataFrame
    from spark_rapids_tpu_torch.kernels import cuda_tier
    from spark_rapids_tpu_torch.session import GpuSparkSession
    out = {}

    def session_of(key, tables):
        sess = GpuSparkSession(RapidsConf(dict(FALLBACK_PATHS[key][2])))
        sql_tables(sess, {t: sql_data[t] for t in tables}, batch_rows)
        return sess

    sess = session_of("a", ["lineitem"])
    out["a"] = run_fallback("a", sess, sql_query(sess, "q1"),
                            lambda rows: check_string_rows(
                                rows, q1_names, q1_ref, "fallback (a)"))
    tree = sess.last_physical_plan.tree_string()
    for exe in ("CpuAggregate", "GpuSort", "GpuFilter", "DeviceToHost",
                "HostToDevice"):
        if exe not in tree:
            raise AssertionError(f"fallback (a): no {exe} in the plan")
    if "variableFloatAgg" not in sess.last_explain:
        raise AssertionError("fallback (a): the explain names no reason")
    try:
        check_on_gpu(sess.sql(q1_text()), "fallback (a)")
    except AssertionError as e:
        if "CpuAggregate" not in str(e):
            raise
        print(f"fallback (a): the test mode raises: {e}", flush=True)
    else:
        raise AssertionError("fallback (a): the test mode did not raise")
    del sess
    torch.cuda.empty_cache()

    sess = session_of("b", ["customer", "orders", "lineitem", "nation"])
    out["b"] = run_fallback("b", sess, sql_query(sess, "q10"),
                            lambda rows: check_sql_rows(
                                rows, sql_refs["q10"], "fallback (b)"))
    tree = sess.last_physical_plan.tree_string()
    for exe in ("CpuAggregate", "HashJoin", "GpuSort", "GpuLocalLimit"):
        if exe not in tree:
            raise AssertionError(f"fallback (b): no {exe} in the plan")
    if "CpuHashJoin" in tree or "hasNans" not in sess.last_explain:
        raise AssertionError("fallback (b): joins on the host or no reason")
    del sess
    torch.cuda.empty_cache()

    sess = GpuSparkSession(RapidsConf(dict(FALLBACK_PATHS["c"][2])))
    df = DataFrame(part_df.plan, sess)
    out["c"] = run_fallback("c", sess, lambda _: part_query(df),
                            lambda rows: check_string_rows(
                                rows, part_names, part_ref, "fallback (c)"))
    tree = sess.last_physical_plan.tree_string()
    if "CpuAggregate" not in tree or "GpuFilter" not in tree:
        raise AssertionError("fallback (c): the aggregate is not on the "
                             "host or the filter not on the device")
    del sess, df

    sess = session_of("d", ["lineitem"])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()

    def check_d(rows):
        check_sql_rows(rows, sql_refs["q6"], "fallback (d)")
        now = torch.cuda.memory_allocated()
        if now != before:
            raise AssertionError(f"fallback (d): device memory {before} -> "
                                 f"{now} bytes across the collect")

    out["d"] = run_fallback("d", sess, sql_query(sess, "q6"), check_d)
    tree = sess.last_physical_plan.tree_string()
    if "Gpu" in tree or "HostToDevice" in tree:
        raise AssertionError(f"fallback (d): a device exec\n{tree}")
    for i in (1, 2):
        launches = out["d"]["path"][f"collect{i}"]["launches"]
        if any(launches[n] for n in cuda_tier.SOURCES):
            raise AssertionError(f"fallback (d) launched {launches}")
    del sess
    return out


# ---------------------------------------------------------------------------
# the TPC-DS phase: all 105 TPC-DS-like texts through session.sql
# ---------------------------------------------------------------------------

#: generator sf 29: store_sales 2,900,000 rows, about TPC-DS SF1's
#: 2,880,404 (the JAX package's benchmarks/tpcds_sf1.py ratio); catalog_sales
#: 1,160,000, web_sales 580,000, inventory 870,000
TPCDS_SF = 29
TPCDS_PARTITIONS = 3
#: the texts of the tenth slice: the set operations, window functions,
#: ROLLUP and stddev the port's parser refused before it
TPCDS_SLICE = ("q4", "q5", "q11", "q14", "q22", "q23a", "q23b", "q33",
               "q56", "q60", "q71", "q74", "q75", "q76", "q77", "q80",
               "q12", "q20", "q36", "q44", "q47", "q49", "q51", "q53",
               "q57", "q63", "q70", "q86", "q89", "q98",
               "q14a", "q14b", "q38", "q87",
               "q18", "q27", "q67",
               "q17", "q39a", "q39b")
#: the reference's suite runs these two without variableFloatAgg
#: (tests/test_tpcds_like.py): their float sums aggregate on the host, the
#: one host exec they may hold besides the test mode's own
TPCDS_NO_VAR_AGG = ("q67", "q70")
#: the scale of the 65 texts that planned before this slice: sf 2.9
#: (store_sales 290,000 rows), since at sf 29 they add ~75 s to a phase
#: that would then grow the run's wall by ~200 s (PERF.md §4)
TPCDS_EARLIER_SF = 2.9


def tpcds_views(session, tables, cache: bool) -> None:
    """Every table as ``TPCDS_PARTITIONS`` host batches, one per
    partition, cached on the device or not, as the session's views."""
    from spark_rapids_tpu_torch.dataframe import DataFrame
    from spark_rapids_tpu_torch.interop import host_batches
    from spark_rapids_tpu_torch.plan.logical import InMemoryScan
    for name, data in tables.items():
        n = len(next(iter(data.values()))[1])
        parts = host_batches(data, max(1, -(-n // TPCDS_PARTITIONS)))
        df = DataFrame(InMemoryScan(parts, parts[0].schema,
                                    TPCDS_PARTITIONS), session)
        (df.cache() if cache else df).create_or_replace_temp_view(name)


def check_tpcds_rows(rows, want, label: str) -> None:
    """The device's rows against the port's host engine's over the same
    tables, in order: keys, counts and ranks exact; float sums, averages
    and moments within 1e-9 relative (the device sums in another order
    than the host engine's row-order ``np.sum``), NaN equal to NaN."""
    if len(rows) != len(want):
        raise AssertionError(f"{label}: {len(rows)} rows, the host engine "
                             f"has {len(want)}")
    for i, (r, w) in enumerate(zip(rows, want)):
        for g, x in zip(r, w):
            if isinstance(x, float) and isinstance(g, float):
                ok = (g != g and x != x) or g == x or \
                    abs(g - x) <= 1e-9 * abs(x)
            else:
                ok = g == x
            if not ok:
                raise AssertionError(f"{label} row {i}: {r} against the "
                                     f"host engine's {w}")


#: the host engine's sessions of a reference worker, by sf
_HOST_SESSIONS = {}


def _tpcds_host_rows(task):
    """(name, rows, host ms) of one TPC-DS text on the port's host engine
    (``spark.rapids.sql.enabled=false``, the CPU only) over the tables
    the generator makes at ``sf``: a task of the reference workers."""
    sf, name = task
    import torch
    from spark_rapids_tpu_torch.benchmarks.tpcds_like import (
        QUERIES, build_tables,
    )
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.session import GpuSparkSession
    torch.set_num_threads(1)
    if sf not in _HOST_SESSIONS:
        host = GpuSparkSession(RapidsConf(dict(
            SQL_SETTINGS, **{"spark.rapids.sql.enabled": False})),
            device="cpu")
        tpcds_views(host, build_tables(sf), cache=False)
        _HOST_SESSIONS[sf] = host
    t0 = time.monotonic()
    rows = _HOST_SESSIONS[sf].sql(QUERIES[name]).collect()
    return name, rows, (time.monotonic() - t0) * 1e3


def tpcds_references(sf, names) -> dict:
    """{name: (rows, host ms)}: the host engine's rows of every text, in
    worker processes (one per core but one; each makes the tables from
    the generator's seeds, the same arrays as the card's), all joined
    before this returns."""
    import multiprocessing
    workers = max(1, min(len(names), (os.cpu_count() or 2) - 1))
    # q67 first: its host aggregate over the ROLLUP's nine copies is the
    # longest task by far (~35 s at sf 29), so no worker starts it last
    tasks = [(sf, n) for n in sorted(names, key=lambda n: n != "q67")]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool:
        out = {name: (rows, ms) for name, rows, ms in pool.imap_unordered(
            _tpcds_host_rows, tasks)}
        pool.close()
        pool.join()
    return out


def run_tpcds(names, sessions, refs, label_sf) -> tuple:
    """Each text of ``names`` through :func:`run_checked` (every
    stringHash and gatherScatter call of its second collect held to its
    plain version), its rows held to the port's host engine's over the
    same tables (``refs``); each text's second-collect ms, host-engine ms
    and launches on a line.  Every text runs before a failure is raised.
    Returns ({label: result}, [faults])."""
    from spark_rapids_tpu_torch.benchmarks.tpcds_like import QUERIES
    from spark_rapids_tpu_torch.plan.overrides import GpuOverrides
    from spark_rapids_tpu_torch.session import (
        _TEST_MODE_ALLOWED, _assert_on_gpu,
    )
    runs, faults = {}, []
    for name in names:
        label = f"TPC-DS {name} (sf {label_sf})"
        novar = name in TPCDS_NO_VAR_AGG
        session = sessions["novar" if novar else "var"]
        text = QUERIES[name]
        try:
            want, host_ms = refs[name]
            rec = run_checked(
                lambda _: session.sql(text),
                lambda rows, w=want, lb=label: check_tpcds_rows(rows, w, lb),
                label, on_gpu=not novar, concats=True)
            if novar:
                # the test mode with the host aggregate allowed
                df = session.sql(text)
                conf = session.conf.copy(
                    **{"spark.rapids.sql.test.enabled": True})
                _assert_on_gpu(GpuOverrides(conf).apply(df.plan),
                               _TEST_MODE_ALLOWED + ("CpuAggregateExec",))
                if "variableFloatAgg" not in session.last_explain:
                    raise AssertionError(f"{label}: no host aggregate "
                                         "for its float sums")
        except Exception as e:  # noqa: BLE001  (named with the others)
            faults.append(f"{label}: {type(e).__name__}: {e}")
            print(f"{label}: FAILED {type(e).__name__}: {e}", flush=True)
            continue
        c2 = rec["path"]["collect2"]
        print(f"{label}: {c2['rows']} rows, collect "
              f"{c2['wall_s'] * 1e3:.1f} ms, host engine {host_ms:.1f} ms, "
              f"launches {c2['launches']}", flush=True)
        runs[label] = {"path": rec["path"], "host_ms": host_ms,
                       "hash_err": rec["hash_err"], "packs": rec["packs"]}
        del rec
    return runs, faults


def tpcds_phase() -> dict:
    """The TPC-DS phase: the port's own tables at ``TPCDS_SF``, cached on
    the card in ``TPCDS_PARTITIONS`` partitions, the 40 texts of this
    slice and then the 65 earlier ones (at ``TPCDS_EARLIER_SF``) through
    ``session.sql`` with the SQL phases' settings, in the test mode, rows
    held to the port's host engine (``spark.rapids.sql.enabled=false``)
    over the same tables.  Across the phase gatherScatter and stringHash
    must launch."""
    import torch
    from spark_rapids_tpu_torch.benchmarks.tpcds_like import (
        QUERIES, build_tables,
    )
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.session import GpuSparkSession
    out, faults = {}, []
    earlier = tuple(q for q in sorted(QUERIES) if q not in TPCDS_SLICE)
    scales = [(TPCDS_SF, TPCDS_SLICE), (TPCDS_EARLIER_SF, earlier)]
    for sf, names in scales:
        t0 = time.monotonic()
        refs = tpcds_references(sf, names)
        print(f"TPC-DS host engine at sf {sf}: {len(refs)} texts in "
              f"{time.monotonic() - t0:.1f} s (worker processes)",
              flush=True)
        t0 = time.monotonic()
        tables = build_tables(sf)
        sessions = {
            "var": GpuSparkSession(RapidsConf(SQL_SETTINGS)),
            "novar": GpuSparkSession(RapidsConf(dict(
                SQL_SETTINGS,
                **{"spark.rapids.sql.variableFloatAgg.enabled": False})))}
        for sess in sessions.values():
            tpcds_views(sess, tables, cache=True)
        print(f"TPC-DS tables at sf {sf}: " + ", ".join(
            f"{k} {len(next(iter(v.values()))[1])}"
            for k, v in tables.items()) +
            f" rows, generated in {time.monotonic() - t0:.1f} s", flush=True)
        del tables
        runs, fs = run_tpcds(names, sessions, refs, sf)
        out.update(runs)
        faults += fs
        del sessions, refs
        torch.cuda.empty_cache()
    if faults:
        raise AssertionError("; ".join(faults))
    for kernel in ("gatherScatter", "stringHash"):
        if not sum(r["path"]["collect2"]["launches"][kernel]
                   for r in out.values()):
            raise AssertionError(f"the TPC-DS phase never launched {kernel}")
    return out


# ---------------------------------------------------------------------------
# main paths: the mortgage ETL and TPCxBB lanes
# ---------------------------------------------------------------------------

#: the mortgage generator's scale: 250,000 loans, perf_raw 6,000,000 rows
#: (24 months a loan, TPC-H SF1's lineitem order of size), acq_raw 250,000
MORTGAGE_SF = 50
#: TPCxBB at sf 30: store_sales and web_clickstreams 3,000,000 rows,
#: web_sales 1,500,000, inventory 1,200,000, store_returns 300,000
TPCXBB_SF = 30
LANE_PARTITIONS = 3
MORTGAGE_ENTRIES = ("run_mortgage", "simple_aggregates",
                    "aggregates_with_join", "aggregates_with_percentiles")
#: the JAX suite's session (tests/compare.py tpu_session): the defaults
#: with 4 shuffle partitions; the float sums then aggregate on the host
TPCXBB_SETTINGS = {"spark.sql.shuffle.partitions": 4}
#: host execs a lane path's plan holds under the test mode at the device
#: settings, as the JAX planner's does (tests/test_torch_mortgage.py):
#: run_mortgage's coalesce over strings builds its column on the host
LANE_HOST_EXECS = {"run_mortgage": ("CpuProjectExec",),
                   "run_mortgage over csv": ("CpuProjectExec",)}
#: the kernels each mortgage path must launch: every aggregate's merge
#: concatenates one partial a partition (gatherScatter); run_mortgage's
#: string group keys and its join on seller names hash strings
MORTGAGE_KERNELS = {"run_mortgage": ("gatherScatter", "stringHash"),
                    "simple_aggregates": ("gatherScatter",),
                    "aggregates_with_join": ("gatherScatter",),
                    "aggregates_with_percentiles": ("gatherScatter",)}


def lane_views(session, tables, cache: bool = True) -> None:
    """Every table as ``LANE_PARTITIONS`` host batches, one a partition,
    cached on the device (or not), as the session's views."""
    from spark_rapids_tpu_torch.dataframe import DataFrame
    from spark_rapids_tpu_torch.interop import host_batches
    from spark_rapids_tpu_torch.plan.logical import InMemoryScan
    for name, data in tables.items():
        n = len(next(iter(data.values()))[1])
        parts = host_batches(data, max(1, -(-n // LANE_PARTITIONS)))
        df = DataFrame(InMemoryScan(parts, parts[0].schema,
                                    LANE_PARTITIONS), session)
        (df.cache() if cache else df).create_or_replace_temp_view(name)


def _loan_groups(hashes):
    """(order, starts): the loans grouped by their hash, each group's
    loans in loan order (a stable sort), and each group's first place."""
    order = np.argsort(hashes, kind="stable")
    starts = np.flatnonzero(np.r_[True, np.diff(hashes[order]) != 0])
    return order, starts


def _percentile(sorted_vals, p):
    """Spark's exact percentile of sorted values, as the rewrite computes
    it: pos = (n - 1) * p, the two closest ranks interpolated."""
    pos = float(len(sorted_vals) - 1) * p
    lo = int(np.floor(pos))
    frac = pos - lo
    out = sorted_vals[lo] * (1.0 - frac)
    return out + sorted_vals[lo + 1] * frac if frac > 0 else out


def mortgage_references(perf, acq) -> dict:
    """{entry: (names, {name: values}, exact names)}: the four entry
    points answered in numpy on the generator's dense layout (every loan
    has 24 consecutive months, loan-major; acq_raw one row a loan in
    loan order), so no 72,000,000-row explode is ever built.

    run_mortgage: the twelve-month expansion's bucket of (loan, year,
    month) holds that month and the next 11 of the same loan, so the row's
    delinquency_12 is (max status over them > 3) + (min UPB over them ==
    0).  aggregates_with_join's ``first(orig_interest_rate)`` assumes the
    input order, loans in loan order (acq_raw's partitions are contiguous
    slices in order): among loans whose hashes collide it is the smallest
    loan id's.  The hashes come from the port's host twin
    (``murmur3_cols_cpu``), which the CPU tests hold to the JAX
    package's bit for bit."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.benchmarks.mortgage_like import SELLER_MAP
    from spark_rapids_tpu_torch.exprs.base import CpuVal
    from spark_rapids_tpu_torch.exprs.hashing import murmur3_cols_cpu
    loans = len(acq["loan_id"][1])
    loan_id = np.asarray(perf["loan_id"][1])
    if len(loan_id) != loans * 24 or not np.array_equal(
            loan_id.reshape(loans, 24)[:, 0], np.arange(1, loans + 1)) or \
            not (np.diff(loan_id.reshape(loans, 24), axis=1) == 0).all():
        raise AssertionError("perf_raw is not 24 consecutive months a loan")
    period = perf["monthly_reporting_period"][1]
    for i in (0, 23, 24 * loans - 1):
        s = i % 24
        if period[i] != f"{2000 + s // 12:04d}-{s % 12 + 1:02d}-01":
            raise AssertionError(f"perf_raw row {i}: period {period[i]}")
    rate = np.asarray(perf["interest_rate"][1]).reshape(loans, 24)
    upb = np.asarray(perf["current_actual_upb"][1]).reshape(loans, 24)
    status = np.asarray(perf["current_loan_delinquency_status"][1]) \
        .astype(np.int64).reshape(loans, 24)
    a = {k: np.asarray(v) for k, (_, v) in acq.items()}
    out = {}

    # run_mortgage
    win_max = np.empty((loans, 24), dtype=np.int64)
    win_min = np.empty((loans, 24))
    for s in range(24):
        win_max[:, s] = status[:, s:s + 12].max(axis=1)
        win_min[:, s] = upb[:, s:s + 12].min(axis=1)
    d12 = (win_max > 3).astype(np.int64) + (win_min == 0).astype(np.int64)
    mapping = dict(SELLER_MAP)
    seller = np.array([mapping.get(x, x) for x in a["seller_name"]],
                      dtype=object)
    combo = np.array([f"{st}\x00{se}" for st, se in
                      zip(a["property_state"], seller)])
    keys, gid = np.unique(combo, return_inverse=True)
    gid = gid.reshape(-1)
    n_loans = np.bincount(gid)
    max_upb = np.full(len(keys), -np.inf)
    np.maximum.at(max_upb, gid, upb.max(axis=1))
    out["run_mortgage"] = (
        ["property_state", "seller", "rows_n", "delinq_12_sum", "avg_rate",
         "avg_score", "max_upb"],
        {"property_state": np.array([k.split("\x00")[0] for k in keys],
                                    dtype=object),
         "seller": np.array([k.split("\x00")[1] for k in keys],
                            dtype=object),
         "rows_n": 24 * n_loans,
         "delinq_12_sum": np.bincount(gid, weights=d12.sum(axis=1))
         .astype(np.int64),
         "avg_rate": np.bincount(gid, weights=rate.sum(axis=1)) /
         (24 * n_loans),
         "avg_score": np.bincount(gid, weights=a["borrower_credit_score"])
         / n_loans,
         "max_upb": max_upb},
        {"property_state", "seller", "rows_n", "delinq_12_sum", "max_upb"})

    # simple_aggregates: each (loan, month) has its two years' rows
    mm = np.maximum(rate[:, :12], rate[:, 12:]).reshape(-1)
    zips = np.repeat(a["zip"].astype(np.int64), 12)
    months = np.tile(np.arange(1, 13), loans)
    order = np.lexsort((months, zips))
    zk, mk = zips[order], months[order]
    starts = np.flatnonzero(np.r_[True, (np.diff(zk) != 0) |
                                  (np.diff(mk) != 0)])
    out["simple_aggregates"] = (
        ["zip", "timestamp_month", "min_max_monthly_rate"],
        {"zip": zk[starts], "timestamp_month": mk[starts],
         "min_max_monthly_rate": np.minimum.reduceat(mm[order], starts)},
        {"zip", "timestamp_month", "min_max_monthly_rate"})

    # aggregates_with_join and aggregates_with_percentiles, by hash
    ids = np.arange(1, loans + 1, dtype=np.int64)
    hashes = murmur3_cols_cpu([CpuVal(T.LONG, ids,
                                      np.ones(loans, dtype=np.bool_))])
    order, starts = _loan_groups(hashes)
    out["aggregates_with_join"] = (
        ["loan_id_hash", "min_int_rate", "first_int_rate", "max_dti"],
        {"loan_id_hash": hashes[order][starts],
         "min_int_rate": np.minimum.reduceat(rate.min(axis=1)[order],
                                             starts),
         "first_int_rate": a["orig_interest_rate"][order][starts],
         "max_dti": np.maximum.reduceat(a["dti"][order], starts)},
        {"loan_id_hash", "min_int_rate", "first_int_rate", "max_dti"})
    ends = np.r_[starts[1:], loans]
    srt = np.sort(rate, axis=1)
    ps = (0.5, 0.75, 0.9, 0.99)
    pct = {p: np.array([_percentile(srt[order[b]], p) for b in starts])
           for p in ps}
    for g in np.flatnonzero(ends - starts > 1):  # colliding hashes
        vals = np.sort(rate[order[starts[g]:ends[g]]].reshape(-1))
        for p in ps:
            pct[p][g] = _percentile(vals, p)
    sums = np.add.reduceat(rate.sum(axis=1)[order], starts)
    out["aggregates_with_percentiles"] = (
        ["loan_id_hash", "interest_rate_min", "interest_rate_max",
         "interest_rate_avg", "interest_rate_50p", "interest_rate_75p",
         "interest_rate_90p", "interest_rate_99p"],
        {"loan_id_hash": hashes[order][starts],
         "interest_rate_min": np.minimum.reduceat(rate.min(axis=1)[order],
                                                  starts),
         "interest_rate_max": np.maximum.reduceat(rate.max(axis=1)[order],
                                                  starts),
         "interest_rate_avg": sums / (24.0 * (ends - starts)),
         "interest_rate_50p": pct[0.5], "interest_rate_75p": pct[0.75],
         "interest_rate_90p": pct[0.9], "interest_rate_99p": pct[0.99]},
        {"loan_id_hash", "interest_rate_min", "interest_rate_max"})
    out["collisions"] = int((ends - starts > 1).sum())
    return out


def write_csv_tables(tables, root: str) -> dict:
    """Each table as ``LANE_PARTITIONS`` CSV files, contiguous slices in
    order (pyarrow: the port has no writer yet), in a directory of its
    own under ``root``: {name: directory}.  The scan reads one batch a
    file, as the cached views hold one a partition."""
    import pyarrow as pa
    import pyarrow.csv as pacsv
    dirs = {}
    for name, data in tables.items():
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        table = pa.table({k: pa.array(np.asarray(v)) for k, (_, v)
                          in data.items()})
        per = -(-table.num_rows // LANE_PARTITIONS)
        for i in range(LANE_PARTITIONS):
            pacsv.write_csv(table.slice(i * per, per),
                            os.path.join(d, f"part-{i}.csv"))
        dirs[name] = d
    return dirs


def _lane_test_mode(frame, label: str, expected=()) -> None:
    """The test mode over a lane path at the device settings: its plan
    holds no host exec but a scan, a transition, a collapsed host
    exchange and the ones the JAX planner also places on the host."""
    from spark_rapids_tpu_torch.plan.overrides import GpuOverrides
    from spark_rapids_tpu_torch.session import (
        _TEST_MODE_ALLOWED, _assert_on_gpu,
    )
    conf = frame.session.conf.copy(**dict(
        SQL_SETTINGS, **{"spark.rapids.sql.test.enabled": True}))
    _assert_on_gpu(GpuOverrides(conf).apply(frame.plan),
                   _TEST_MODE_ALLOWED + tuple(expected))
    ON_GPU_CHECKED.append(label)


def run_lane(query, check, label: str, need, on_gpu: bool = False) -> dict:
    """One lane path through :func:`run_checked` (every stringHash and
    gatherScatter call of its second collect held to its plain
    version; with ``on_gpu`` its plan held to the test mode too), with
    the device's peak memory over both collects; its rows,
    second-collect ms, launches and peak memory on a line."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = run_checked(query, check, label, on_gpu=on_gpu, concats=True)
    peak = torch.cuda.max_memory_allocated()
    _require(rec["path"], label, need)
    c2 = rec["path"]["collect2"]
    print(f"{label}: {c2['rows']} rows, collect {c2['wall_s'] * 1e3:.1f} "
          f"ms, launches {c2['launches']}, peak memory "
          f"{peak / 2 ** 30:.2f} GiB", flush=True)
    return {"path": rec["path"], "peak_bytes": peak,
            "hash_err": rec["hash_err"], "packs": rec["packs"]}


def _xbb_host_rows(task):
    """(name, rows, host ms) of one TPCxBB text on the port's host engine
    (the CPU only) over the generator's tables: a reference worker's
    task."""
    sf, name = task
    import torch
    from spark_rapids_tpu_torch.benchmarks.tpcxbb_like import (
        QUERIES, build_tables,
    )
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.session import GpuSparkSession
    torch.set_num_threads(1)
    key = ("xbb", sf)
    if key not in _HOST_SESSIONS:
        host = GpuSparkSession(RapidsConf(dict(
            TPCXBB_SETTINGS, **{"spark.rapids.sql.enabled": False})),
            device="cpu")
        lane_views(host, build_tables(sf), cache=False)
        _HOST_SESSIONS[key] = host
    t0 = time.monotonic()
    rows = _HOST_SESSIONS[key].sql(QUERIES[name]).collect()
    return name, rows, (time.monotonic() - t0) * 1e3


def tpcxbb_references(sf, names) -> dict:
    """{name: (rows, host ms)} from the host engine in worker processes."""
    import multiprocessing
    workers = max(1, min(len(names), (os.cpu_count() or 2) - 1))
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool:
        out = {name: (rows, ms) for name, rows, ms in pool.imap_unordered(
            _xbb_host_rows, [(sf, n) for n in names])}
        pool.close()
        pool.join()
    return out


def lanes_phase() -> dict:
    """The mortgage ETL and TPCxBB lanes: mortgage at ``MORTGAGE_SF``
    (tables cached on the card in ``LANE_PARTITIONS`` partitions), its
    four entry points and run_mortgage once more over CSV files, each
    against its numpy answer; the eight TPCxBB texts at ``TPCXBB_SF`` at
    the JAX suite's settings and again at the device settings in the test
    mode, against the port's host engine over the same tables.  Every
    stringHash and gatherScatter call of each second collect is held to
    its plain version."""
    import torch
    from spark_rapids_tpu_torch.benchmarks import mortgage_like as M
    from spark_rapids_tpu_torch.benchmarks.tpcxbb_like import (
        QUERIES, build_tables,
    )
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.session import GpuSparkSession
    out, faults = {}, []

    def attempt(label, fn):
        try:
            out[label] = fn()
        except Exception as e:  # noqa: BLE001  (named with the others)
            faults.append(f"{label}: {type(e).__name__}: {e}")
            print(f"{label}: FAILED {type(e).__name__}: {e}", flush=True)

    # ---- mortgage -------------------------------------------------------
    t0 = time.monotonic()
    tables = {"perf_raw": M.gen_performance(MORTGAGE_SF),
              "acq_raw": M.gen_acquisition(MORTGAGE_SF)}
    t1 = time.monotonic()
    refs = mortgage_references(tables["perf_raw"], tables["acq_raw"])
    print(f"mortgage tables at sf {MORTGAGE_SF}: perf_raw "
          f"{len(tables['perf_raw']['loan_id'][1])}, acq_raw "
          f"{len(tables['acq_raw']['loan_id'][1])} rows, generated in "
          f"{t1 - t0:.1f} s, numpy answers in {time.monotonic() - t1:.1f} s "
          f"({refs['collisions']} hash groups of more than one loan)",
          flush=True)
    session = GpuSparkSession(RapidsConf(SQL_SETTINGS))
    lane_views(session, tables)
    csv_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_csv_")
    t1 = time.monotonic()
    dirs = write_csv_tables(tables, csv_tmp.name)
    print(f"mortgage tables written as CSV in {time.monotonic() - t1:.1f} "
          "s", flush=True)
    del tables
    kept = {}
    for entry in MORTGAGE_ENTRIES:
        label = f"mortgage {entry} (sf {MORTGAGE_SF})"

        def check(rows, e=entry, lb=label):
            check_sql_rows(rows, refs[e], lb)
            kept[e] = rows

        def path(e=entry, lb=label):
            query = getattr(M, e)
            rec = run_lane(lambda _: query(session), check, lb,
                           MORTGAGE_KERNELS[e])
            _lane_test_mode(query(session), lb, LANE_HOST_EXECS.get(e, ()))
            return rec

        attempt(label, path)
    # the reference's Run.csv entry: the ETL over the CSV files, read anew
    # each collect (the period column infers as DATE)
    csv_session = GpuSparkSession(RapidsConf(SQL_SETTINGS))
    for name, d in dirs.items():
        csv_session.register_view(name, csv_session.read.csv(d))
    label = f"mortgage run_mortgage over csv (sf {MORTGAGE_SF})"

    def check_csv(rows):
        check_sql_rows(rows, refs["run_mortgage"], label)
        if "run_mortgage" in kept:
            check_same_rows(rows, kept["run_mortgage"],
                            f"{label} vs the cached run")

    def csv_path():
        rec = run_lane(lambda _: M.run_mortgage(csv_session), check_csv,
                       label, MORTGAGE_KERNELS["run_mortgage"])
        _lane_test_mode(M.run_mortgage(csv_session), label,
                        LANE_HOST_EXECS["run_mortgage over csv"])
        return rec

    attempt(label, csv_path)
    del session, csv_session, refs, kept
    csv_tmp.cleanup()
    torch.cuda.empty_cache()

    # ---- TPCxBB ---------------------------------------------------------
    names = sorted(QUERIES, key=lambda q: int(q[1:]))
    t0 = time.monotonic()
    xrefs = tpcxbb_references(TPCXBB_SF, names)
    print(f"TPCxBB host engine at sf {TPCXBB_SF}: {len(xrefs)} texts in "
          f"{time.monotonic() - t0:.1f} s (worker processes)", flush=True)
    t0 = time.monotonic()
    tables = build_tables(TPCXBB_SF)
    sessions = {
        "suite": GpuSparkSession(RapidsConf(TPCXBB_SETTINGS)),
        "test mode": GpuSparkSession(RapidsConf(dict(
            SQL_SETTINGS, **TPCXBB_SETTINGS,
            **{"spark.rapids.sql.test.enabled": True})))}
    for sess in sessions.values():
        lane_views(sess, tables)
    print(f"TPCxBB tables at sf {TPCXBB_SF}: " + ", ".join(
        f"{k} {len(next(iter(v.values()))[1])}" for k, v in tables.items())
        + f" rows, generated in {time.monotonic() - t0:.1f} s", flush=True)
    del tables
    for mode, sess in sessions.items():
        for name in names:
            label = f"TPCxBB {name} (sf {TPCXBB_SF}, {mode})"
            want, host_ms = xrefs[name]

            def path(n=name, s=sess, w=want, lb=label):
                return run_lane(lambda _: s.sql(QUERIES[n]),
                                lambda rows: check_tpcds_rows(rows, w, lb),
                                lb, ())

            attempt(label, path)
            if label in out:
                out[label]["host_ms"] = host_ms
    del sessions
    torch.cuda.empty_cache()
    if faults:
        raise AssertionError("; ".join(faults))
    ON_GPU_CHECKED.extend(f"TPCxBB {n} (test mode)" for n in names)
    for kernel in ("gatherScatter", "stringHash"):
        if not sum(r["path"]["collect2"]["launches"][kernel]
                   for label, r in out.items() if label.startswith("TPCxBB")):
            raise AssertionError(f"the TPCxBB lane never launched {kernel}")
    return out


# ---------------------------------------------------------------------------
# main paths: the expression layer on an ETL path (strings built on the
# device, time and formatting, bitwise, arrays, corr/covar)
# ---------------------------------------------------------------------------

#: path (a): the string functions over part, through session.sql over a
#: view whose ``ee_pos`` column is ``locate('ee', p_name)`` (locate has no
#: SQL name in either package)
ETL_PART_SQL = """
SELECT upper(split_part(p_type, ' ', 3)) AS material,
       initcap(substring_index(p_name, ' ', 1)) AS first_word,
       count(*) AS parts,
       sum(length(trim(concat('  ', p_container, '  ')))) AS container_len,
       sum(length(ltrim(concat(' ', p_brand)))
           + length(rtrim(p_brand || ' '))) AS brand_trim_len,
       max(ee_pos) AS ee_pos,
       sum(length(replace(lpad(hex(p_size), 4, '0'), '0', ''))) AS hex_len,
       sum(length(hex(p_size - 25))) AS hex_signed_len,
       sum(length(regexp_replace(p_brand, '#', '-'))) AS brand_len,
       sum(length(regexp_replace(p_container, '[A-E]', 'xy'))) AS class_len,
       sum(length(replace(p_type, 'BRUSHED', 'B'))) AS type_len,
       sum(length(replace(rpad(p_container, 7, '.'), '.', ''))) AS pad_len
FROM part_etl
WHERE lower(concat_ws(' ', p_mfgr, p_name)) LIKE '%green%'
GROUP BY upper(split_part(p_type, ' ', 3)),
         initcap(substring_index(p_name, ' ', 1))
ORDER BY material, first_word
"""
ETL_PART_NAMES = ["material", "first_word", "parts", "container_len",
                  "brand_trim_len", "ee_pos", "hex_len", "hex_signed_len",
                  "brand_len", "class_len", "type_len", "pad_len"]
ETL_LINEITEM_NAMES = [
    "month_end", "l_returnflag", "n", "tod", "fmt_len", "fmt_day",
    "packed", "mixed", "high_bits", "arr_max", "arr_min", "arr_size",
    "has_26", "median", "pos_25", "corr_qp", "covp_qt", "covs_dp"]
#: the kernels each ETL path must launch a collect
ETL_KERNELS = {"part": ("gatherScatter", "stringHash", "strings"),
               "lineitem": ("gatherScatter", "stringHash")}


def etl_part_view(part_df, F, S):
    """The part table with ``ee_pos = locate('ee', p_name)``, in either
    package's API (``F`` its functions, ``S`` its strings module)."""
    node = type(F.lit(0))
    return part_df.with_column("ee_pos", node(S.StringLocate(
        S.Literal("ee"), F.col("p_name").expr)))


def etl_lineitem_query(df, F, D):
    """Path (b) over lineitem in either package's DataFrame API (``D`` its
    datetime module: ``Hour``, ``Minute``, ``Second``, ``LastDay`` and
    ``TimeAdd`` have no function name in either package): a TIMESTAMP
    made on the device, grouped by a string built on the device
    (``from_unixtime`` of the month's last day) and l_returnflag, with the
    time parts, ``date_format``, the bitwise functions, the array
    functions and corr/covar."""
    node = type(F.lit(0))
    ts = (F.unix_timestamp("l_shipdate")
          + df["l_orderkey"] * 7919 % 86400).cast("timestamp")
    month_end = F.from_unixtime(F.unix_timestamp(node(D.LastDay(
        F.col("l_shipdate").expr))))
    df = df.with_column("ts", ts).with_column("month_end", month_end)
    t, k = df["ts"], df["l_orderkey"]
    later = node(D.TimeAdd(t.expr, 5 * 3_600_000_000 + 17))
    tod = node(D.Hour(t.expr)) * 3600 + node(D.Minute(t.expr)) * 60 + \
        node(D.Second(t.expr))
    arr = F.array(F.coalesce(df["l_quantity"], F.lit(0.0)),
                  F.coalesce(df["l_tax"] * 100, F.lit(0.0)), F.lit(25.0))
    return (df.group_by("month_end", "l_returnflag").agg(
        F.count("*").alias("n"),
        F.sum(tod).alias("tod"),
        F.sum(F.length(F.date_format(later))).alias("fmt_len"),
        F.sum(F.dayofmonth(F.to_date(F.date_format(later)))).alias(
            "fmt_day"),
        F.sum(F.shiftleft(df["l_suppkey"], 3).bitwiseOR(k.bitwiseAND(7)))
        .alias("packed"),
        F.sum(F.bitwise_not(k).bitwiseXOR(F.shiftrightunsigned(k, 3)))
        .alias("mixed"),
        F.sum(F.shiftrightunsigned(F.bitwise_not(k), 60)
              + F.shiftright(F.bitwise_not(k), 62)).alias("high_bits"),
        F.sum(F.array_max(arr)).alias("arr_max"),
        F.sum(F.array_min(arr)).alias("arr_min"),
        F.sum(F.size(arr)).alias("arr_size"),
        F.sum(F.when(F.array_contains(arr, 26.0), 1).otherwise(0))
        .alias("has_26"),
        F.sum(F.sort_array(arr).getItem(1)).alias("median"),
        F.sum(F.array_position(arr, 25.0)).alias("pos_25"),
        F.corr("l_quantity", "l_extendedprice").alias("corr_qp"),
        F.covar_pop("l_quantity", "l_tax").alias("covp_qt"),
        F.covar_samp("l_discount", "l_extendedprice").alias("covs_dp"))
        .order_by("month_end", "l_returnflag"))


def _per_unique(values, fn):
    """``fn`` of every row of a column, computed once per distinct
    value."""
    uniq, inv = np.unique(np.asarray(values), return_inverse=True)
    return np.array([fn(str(u)) for u in uniq], dtype=object)[inv]


def _initcap(s: str) -> str:
    out, head = [], True
    for ch in s:
        if head and "a" <= ch <= "z":
            ch = chr(ord(ch) - 32)
        elif not head and "A" <= ch <= "Z":
            ch = chr(ord(ch) + 32)
        out.append(ch)
        head = ch == " "
    return "".join(out)


def _key_codes(values, fn=None):
    """(sorted distinct keys, each row's index among them) of ``fn`` of a
    column (the column itself without ``fn``), ``fn`` computed once per
    distinct value."""
    uniq, inv = np.unique(np.asarray(values), return_inverse=True)
    derived = np.array([fn(str(u)) if fn else str(u) for u in uniq])
    labels, dinv = np.unique(derived, return_inverse=True)
    return labels, dinv[inv.reshape(-1)]


def _grouped(keys, cols, ops):
    """Rows grouped by ``keys`` (:func:`_key_codes` pairs) in key order:
    (each key's column, {name: per-group count, sum or max}, each row's
    group)."""
    code = np.zeros(len(keys[0][1]), dtype=np.int64)
    for labels, c in keys:
        code = code * len(labels) + c
    groups, inv = np.unique(code, return_inverse=True)
    inv = inv.reshape(-1)
    key_cols, rest = [], groups
    for labels, _ in reversed(keys):
        key_cols.insert(0, labels[rest % len(labels)])
        rest = rest // len(labels)
    out = {}
    for name, op in ops.items():
        if op == "count":
            out[name] = np.bincount(inv, minlength=len(groups))
            continue
        x = cols[name]
        acc = np.zeros(len(groups), dtype=x.dtype) if op == "sum" else \
            np.full(len(groups), np.iinfo(np.int64).min)
        (np.add if op == "sum" else np.maximum).at(acc, inv, x)
        out[name] = acc
    return key_cols, out, inv


def etl_part_reference(part):
    """Path (a)'s rows from numpy and Python's str, each function once
    per distinct value: (names, columns, exact names) for
    :func:`check_sql_rows`."""
    import re
    name = np.asarray(part["p_name"][1])
    mfgr = np.asarray(part["p_mfgr"][1])
    keep = _per_unique(np.char.add(np.char.add(mfgr, " "), name),
                       lambda s: "green" in s.lower()).astype(bool)
    p = {k: np.asarray(v)[keep] for k, (_, v) in part.items()}
    size = p["p_size"].astype(np.int64)

    def lens(values, fn):
        return _per_unique(values, fn).astype(np.int64)

    def hex_len(x):
        return len(format(x if x >= 0 else x + (1 << 64), "X"))

    cols = {
        "container_len": lens(p["p_container"],
                              lambda c: len(("  " + c + "  ").strip(" "))),
        "brand_trim_len": lens(p["p_brand"], lambda b: len(
            (" " + b).lstrip(" ")) + len((b + " ").rstrip(" "))),
        "ee_pos": lens(p["p_name"], lambda n: n.find("ee") + 1),
        "hex_len": np.array([len(format(v, "X").rjust(4, "0")[:4]
                                 .replace("0", "")) for v in range(64)]
                            )[size],
        "hex_signed_len": np.array([hex_len(v - 25) for v in range(64)]
                                   )[size],
        "brand_len": lens(p["p_brand"], lambda b: len(b.replace("#", "-"))),
        "class_len": lens(p["p_container"],
                          lambda c: len(re.sub("[A-E]", "xy", c))),
        "type_len": lens(p["p_type"],
                         lambda t: len(t.replace("BRUSHED", "B"))),
        "pad_len": lens(p["p_container"], lambda c: len(
            (c + "." * 7)[:7].replace(".", ""))),
    }

    def part3(t):
        parts = t.split(" ")
        return parts[2].upper() if len(parts) >= 3 else ""

    keys = [_key_codes(p["p_type"], part3),
            _key_codes(p["p_name"], lambda n: _initcap(n.split(" ")[0]))]
    ops = {n: "sum" for n in ETL_PART_NAMES[2:]}
    ops["parts"], ops["ee_pos"] = "count", "max"
    (material, first), out, _ = _grouped(keys, cols, ops)
    want = {"material": material, "first_word": first, **out}
    return ETL_PART_NAMES, want, set(ETL_PART_NAMES)


def etl_lineitem_reference(li):
    """Path (b)'s rows from numpy: keys, counts and the integer sums
    exact, the float sums and corr/covar (two-pass, centered on each
    group's means) within :func:`check_sql_rows`' 1e-9."""
    k = np.asarray(li["l_orderkey"][1]).astype(np.int64)
    ship = np.asarray(li["l_shipdate"][1]).astype(np.int64)
    q = np.asarray(li["l_quantity"][1], dtype=np.float64)
    tax = np.asarray(li["l_tax"][1], dtype=np.float64)
    price = np.asarray(li["l_extendedprice"][1], dtype=np.float64)
    disc = np.asarray(li["l_discount"][1], dtype=np.float64)
    supp = np.asarray(li["l_suppkey"][1]).astype(np.int64)
    secs = ship * 86400 + k * 7919 % 86400
    months = ship.astype("datetime64[D]").astype("datetime64[M]")
    last = (months + 1).astype("datetime64[D]") - 1
    later = secs * 1_000_000 + 5 * 3_600_000_000 + 17
    later_day = np.floor_divide(later, 86_400_000_000).astype(
        "datetime64[D]")
    day_of_month = (later_day - later_day.astype("datetime64[M]")
                    ).astype(np.int64) + 1
    nk = ~k
    t100 = tax * 100
    arr = np.stack([q, t100, np.full_like(q, 25.0)], axis=1)
    cols = {
        "tod": secs % 86400,
        "fmt_len": np.full(len(k), 10, dtype=np.int64),
        "fmt_day": day_of_month,
        "packed": (supp << 3) | (k & 7),
        "mixed": nk ^ (k.view(np.uint64) >> np.uint64(3)).view(np.int64),
        "high_bits": (nk.view(np.uint64) >> np.uint64(60)).view(np.int64)
        + (nk >> 62),
        "arr_max": arr.max(axis=1), "arr_min": arr.min(axis=1),
        "arr_size": np.full(len(k), 3, dtype=np.int64),
        "has_26": ((q == 26.0) | (t100 == 26.0)).astype(np.int64),
        "median": np.sort(arr, axis=1)[:, 1],
        "pos_25": np.where(q == 25.0, 1, np.where(t100 == 25.0, 2, 3)),
    }
    keys = [_key_codes(last, lambda d: d + " 00:00:00"),
            _key_codes(li["l_returnflag"][1])]
    ops = {"n": "count", **{n: "sum" for n in cols}}
    (ends, fl), out, inv = _grouped(keys, cols, ops)
    g = len(ends)
    n = np.bincount(inv, minlength=g).astype(np.float64)

    def centered(x, y):
        mx = np.bincount(inv, x, g) / n
        my = np.bincount(inv, y, g) / n
        dx, dy = x - mx[inv], y - my[inv]
        return (np.bincount(inv, dx * dy, g), np.bincount(inv, dx * dx, g),
                np.bincount(inv, dy * dy, g))

    sp, sxx, syy = centered(q, price)
    out["corr_qp"] = sp / np.sqrt(sxx * syy)
    out["covp_qt"] = centered(q, tax)[0] / n
    out["covs_dp"] = centered(disc, price)[0] / (n - 1)
    want = {"month_end": ends, "l_returnflag": fl, **out}
    floats = {"arr_max", "arr_min", "median", "corr_qp", "covp_qt",
              "covs_dp"}
    return ETL_LINEITEM_NAMES, want, set(ETL_LINEITEM_NAMES) - floats


def etl_frames(session, part, lineitem, batch_rows: int):
    """part and lineitem cached on the device as batches of
    ``batch_rows`` rows; the ``part_etl`` view (:func:`etl_part_view`)
    registered; (the part view's DataFrame, lineitem's DataFrame)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.dataframe import DataFrame
    from spark_rapids_tpu_torch.exprs import strings as S
    from spark_rapids_tpu_torch.interop import host_batches
    from spark_rapids_tpu_torch.plan.logical import InMemoryScan
    frames = []
    for data in (part, lineitem):
        parts = host_batches(data, batch_rows)
        frames.append(DataFrame(InMemoryScan(parts, parts[0].schema, 1),
                                session).cache())
    view = etl_part_view(frames[0], F, S)
    view.create_or_replace_temp_view("part_etl")
    return view, frames[1]


def etl_queries(session, lineitem_df):
    """{path: query builder} of the two ETL paths."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.exprs import datetime as D
    return {"part": lambda _: session.sql(ETL_PART_SQL),
            "lineitem": lambda _: etl_lineitem_query(lineitem_df, F, D)}


def etl_phase() -> dict:
    """The ETL phase: part at ``PART_SF`` and lineitem at
    ``LINEITEM_SF``, cached as batches of ``reader.batchSizeRows`` rows;
    path (a) through ``session.sql`` and path (b) through the DataFrame
    API, each against its numpy answer, planned wholly on the card in the
    test mode, every stringHash, contains and gatherScatter call of the
    second collect held to its plain version; rows, second-collect ms,
    launches and peak device memory on a line."""
    import torch
    from spark_rapids_tpu_torch.benchmarks import datagen
    from spark_rapids_tpu_torch.config import (
        READER_BATCH_SIZE_ROWS, RapidsConf,
    )
    from spark_rapids_tpu_torch.session import GpuSparkSession
    t0 = time.monotonic()
    part = datagen.gen_part(PART_SF)
    lineitem = datagen.gen_lineitem(LINEITEM_SF)
    refs = {"part": etl_part_reference(part),
            "lineitem": etl_lineitem_reference(lineitem)}
    conf = RapidsConf(SQL_SETTINGS)
    session = GpuSparkSession(conf)
    _, li_df = etl_frames(session, part, lineitem,
                          READER_BATCH_SIZE_ROWS.get(conf))
    print(f"ETL tables: part {len(part['p_partkey'][1])}, lineitem "
          f"{len(lineitem['l_orderkey'][1])} rows, generated, cached and "
          f"answered by numpy in {time.monotonic() - t0:.1f} s", flush=True)
    del part, lineitem
    out = {}
    for path, query in etl_queries(session, li_df).items():
        label = f"ETL {path}"
        out[label] = run_lane(
            query, lambda rows, p=path, lb=label: check_sql_rows(
                rows, refs[p], lb), label, ETL_KERNELS[path], on_gpu=True)
    del session, li_df
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# main paths with the partitioned exchange: the split, the adaptive layer,
# the partitioning API and the DataFrame methods
# ---------------------------------------------------------------------------

#: the SQL phases' settings with the exchanges split and
#: ``spark.sql.shuffle.partitions`` at its default, 8 (the adaptive layer
#: on and the broadcast threshold 10 MiB, their defaults)
SPLIT_SETTINGS = dict(SQL_SETTINGS, **{
    "spark.rapids.sql.tpu.exchange.collapseLocal": False,
    "spark.sql.shuffle.partitions": 8})
SPLIT_TEXTS = ("q1", "q2", "q3", "q4", "q5", "q6", "q7", "q8", "q9", "q10",
               "q11", "q12", "q13", "q14", "q15", "q16", "q17", "q18", "q19",
               "q20", "q21", "q22")
Q1_NAMES = ["l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
            "avg_qty", "avg_price", "avg_disc", "count_order"]
#: the supplier that holds half of lineitem's rows in the skewed join
HOT_SUPPLIER = 7
#: the partitioning API path's columns of lineitem
API_COLUMNS = ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
               "l_extendedprice", "l_returnflag", "l_shipdate", "l_shipmode"]


def split_tables():
    """The SQL phase's tables at TPC-H SF1's counts and their numpy
    answers, for ``--exchange-only``."""
    from spark_rapids_tpu_torch.benchmarks import datagen
    data = {"customer": datagen.gen_customer(Q3_SF),
            "orders": datagen.gen_orders(Q3_SF),
            "lineitem": datagen.gen_lineitem(Q3_SF),
            "supplier": datagen.gen_supplier(SUPPLIER_SF),
            "nation": datagen.gen_nation(), "region": datagen.gen_region(),
            "part": datagen.gen_part(SQL_PART_SF),
            "partsupp": datagen.gen_partsupp(SQL_PART_SF)}
    refs = sql_references(data)
    refs.update(sql_references_more(data))
    refs["q1"] = q1_reference(data["lineitem"])
    refs["q3"] = q3_reference(data["customer"], data["orders"],
                              data["lineitem"])
    return data, refs


def split_ops(session):
    """The per-operator metrics of the exchanges of the last query that
    split (dispatched a pid sort)."""
    return {op: m for op, m in session.last_op_metrics.items()
            if m.get("shuffleSplitDispatches")}


class ExchangeSyncs:
    """Around every split and range sample of the device exchanges, the
    host syncs torch's sync debug mode flags (each synchronizing call: a
    ``.tolist()``, a stream synchronize, a blocking copy) beside the syncs
    the exchange counted itself (``shuffleSyncs``, ``rangeSampleSyncs``):
    ``calls`` holds (what, flagged, counted) a call."""

    def __enter__(self):
        import warnings
        import torch
        from spark_rapids_tpu_torch.parallel.exchange import (
            GpuShuffleExchangeExec as X,
        )
        self.calls = []
        self._saved = (X._split, X._sample_range)

        def wrap(fn, what, metric):
            def run(ex, ctx, *args):
                m = ctx.metric(ex.op_id, metric)
                before = m.value
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    with warnings.catch_warnings(record=True) as caught:
                        warnings.simplefilter("always")
                        out = fn(ex, ctx, *args)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                flagged = sum(1 for w in caught
                              if "synchroniz" in str(w.message))
                self.calls.append((what, flagged, m.value - before))
                return out
            return run

        X._split = wrap(X._split, "split", "shuffleSyncs")
        X._sample_range = wrap(X._sample_range, "range sample",
                               "rangeSampleSyncs")
        return self

    def __exit__(self, *exc):
        from spark_rapids_tpu_torch.parallel.exchange import (
            GpuShuffleExchangeExec as X,
        )
        X._split, X._sample_range = self._saved
        return False


def run_split_texts(session, refs, kept, collapsed_ms):
    """(a) The 22 TPC-H texts with the exchanges split, each through
    :func:`run_checked` with every gatherScatter (concats and split
    pieces), stringHash and contains call of the second collect held to
    its plain version; rows against numpy and the collapsed run's rows;
    one sync per split exchange, three per range sample, and every split
    and sample of both collects taking the syncs it counted, as torch's
    sync debug mode flags them; gatherScatter launched where the plan
    split.  Every text runs before a fault is raised."""
    runs, faults, pieces = {}, [], []
    for name in SPLIT_TEXTS:
        label = f"split {name.upper()}"

        def check(rows, name=name, label=label):
            if name == "q1":
                check_string_rows(rows, Q1_NAMES, refs["q1"], label)
            elif name == "q3":
                check_q3_rows(rows, refs["q3"], label)
            else:
                check_sql_rows(rows, refs[name], label)
            other = kept.get(f"sql {name} host-driven")
            if other is not None:
                check_same_rows(rows, other, f"{label} vs collapsed")

        try:
            with ExchangeSyncs() as flagged:
                rec = run_checked(sql_query(session, name), check, label,
                                  concats=True)
        except Exception as e:  # noqa: BLE001  (named with the others)
            faults.append(f"{label}: {type(e).__name__}: {e}")
            print(f"{label}: FAILED {type(e).__name__}: {e}", flush=True)
            continue
        metrics = dict(session.last_metrics)
        splits = split_ops(session)
        c2 = rec["path"]["collect2"]
        shown = {k: metrics.get(k, 0) for k in (
            "shufflePieces", "shuffleSyncs", "rangeSampleSyncs",
            "coalescedTo", "aqeCoalescedPartitions", "replannedBroadcast",
            "shuffleElided")}
        print(f"{label}: {c2['rows']} rows, collect "
              f"{c2['wall_s'] * 1e3:.1f} ms (collapsed "
              f"{collapsed_ms.get(name, float('nan')):.1f} ms), "
              f"{len(splits)} split exchanges, {shown}, launches "
              f"{c2['launches']}", flush=True)
        syncs = [m.get("shuffleSyncs") for m in splits.values()]
        if any(n != 1 for n in syncs):
            faults.append(f"{label}: shuffleSyncs {syncs}, not 1 per split "
                          "exchange")
        samples = [m["rangeSampleSyncs"] for m in splits.values()
                   if "rangeSampleSyncs" in m]
        if any(n != 3 for n in samples):
            faults.append(f"{label}: rangeSampleSyncs {samples}, not 3 per "
                          "range sample")
        miscounted = [c for c in flagged.calls if c[1] != c[2]]
        print(f"{label}: syncs flagged by torch / counted, both collects: "
              f"{[f'{w} {f}/{c}' for w, f, c in flagged.calls]}",
              flush=True)
        if miscounted or (splits and not flagged.calls):
            faults.append(f"{label}: exchange syncs flagged/counted "
                          f"{flagged.calls}")
        if metrics.get("shufflePieces") and \
                c2["launches"]["gatherScatter"] == 0:
            faults.append(f"{label} split into pieces without gatherScatter")
        pieces.extend(args for _, args in rec.pop("windows"))
        runs[label] = rec
    return runs, faults, pieces


def skew_frames(session, data, batch_rows):
    """lineitem with every other row's l_suppkey set to
    :data:`HOT_SUPPLIER` (a marketplace table whose top seller holds half
    the rows), and supplier, cached; and the join grouped by the
    supplier's nation."""
    from spark_rapids_tpu_torch import functions as F
    li = dict(data["lineitem"])
    dtype, keys = li["l_suppkey"]
    keys = np.array(keys, copy=True)
    keys[::2] = HOT_SUPPLIER
    li["l_suppkey"] = (dtype, keys)
    tables = q3_tables(session, {"lineitem": li,
                                 "supplier": data["supplier"]}, batch_rows)
    lf = tables["lineitem"].select("l_suppkey", "l_extendedprice",
                                   "l_discount", "l_quantity")
    sf = tables["supplier"].select("s_suppkey", "s_nationkey")
    query = (lf.join(sf, lf["l_suppkey"] == sf["s_suppkey"])
             .group_by("s_nationkey")
             .agg(F.sum(lf["l_extendedprice"] * (1 - lf["l_discount"]))
                  .alias("revenue"),
                  F.sum("l_quantity").alias("qty"),
                  F.count("*").alias("n"))
             .order_by("s_nationkey"))
    s = _np(data["supplier"])
    ln = _np(li)
    hit = (keys >= 1) & (keys <= len(s["s_suppkey"]))  # s_suppkey is 1..n
    nation = s["s_nationkey"][keys[hit] - 1]
    n_nat = int(s["s_nationkey"].max()) + 1
    rev = np.bincount(nation, (ln["l_extendedprice"] *
                               (1 - ln["l_discount"]))[hit], n_nat)
    qty = np.bincount(nation, ln["l_quantity"][hit], n_nat)
    cnt = np.bincount(nation, minlength=n_nat)
    has = cnt > 0
    ref = (["s_nationkey", "revenue", "qty", "n"],
           {"s_nationkey": np.arange(n_nat)[has], "revenue": rev[has],
            "qty": qty[has], "n": cnt[has]}, ("s_nationkey", "n"))
    return (lambda _: query), ref


def api_query(df, F):
    """(c) repartition by l_orderkey, the nondeterministic columns, a 10%
    sample, a sort within each partition."""
    return (df.repartition(8, "l_orderkey")
            .with_column("pid", F.spark_partition_id())
            .with_column("mid", F.monotonically_increasing_id())
            .with_column("r", F.rand(7))
            .sample(0.1, 11)
            .sort_within_partitions("l_orderkey"))


def check_api_rows(rows, names, label):
    """pid from the id's high bits, ids unique, rand in [0, 1) and equal
    to the device form run on CPU tensors for its partition and row (each
    partition arrives as one piece, so its base row id is 0)."""
    import torch
    from spark_rapids_tpu_torch.exprs.misc import rand_uniform
    pid = np.array([r[names.index("pid")] for r in rows], dtype=np.int64)
    mid = np.array([r[names.index("mid")] for r in rows], dtype=np.int64)
    rnd = np.array([r[names.index("r")] for r in rows], dtype=np.float64)
    if len(np.unique(mid)) != len(mid):
        raise AssertionError(f"{label}: monotonically_increasing_id repeats")
    if not np.array_equal(mid >> 33, pid):
        raise AssertionError(f"{label}: id high bits != spark_partition_id")
    if not (np.all(rnd >= 0) and np.all(rnd < 1)):
        raise AssertionError(f"{label}: rand outside [0, 1)")
    for p in np.unique(pid):
        at = pid == p
        offset = mid[at] - (p << 33)
        want = rand_uniform(7, int(p), 0, int(offset.max()) + 1,
                            torch.device("cpu")).numpy()[offset]
        if not np.array_equal(rnd[at].view(np.int64), want.view(np.int64)):
            raise AssertionError(f"{label}: rand of partition {p} != the "
                                 "device form on CPU tensors")


def run_api_path(session, host_session, li, batch_rows, tmp):
    """(c) The partitioning API over lineitem: :func:`api_query` collected
    twice (rand equal between the collects), written as parquet and read
    back, the rows (but rand) equal to the port's host engine's; then
    round robin into 16 and coalesce into 2 (each partition's row count
    exact), and a global sort through the range split against numpy."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.dataframe import DataFrame
    from spark_rapids_tpu_torch.interop import host_batches
    from spark_rapids_tpu_torch.plan.logical import InMemoryScan
    table = {k: li[k] for k in API_COLUMNS}
    parts = host_batches(table, batch_rows)
    df = DataFrame(InMemoryScan(parts, parts[0].schema, 1),
                   session).cache()
    names = API_COLUMNS + ["pid", "mid", "r"]
    kept = []

    def check(rows):
        check_api_rows(rows, names, "API path")
        if session.last_metrics.get("shufflePieces") != 8:
            raise AssertionError(f"API path: pieces {session.last_metrics}")
        kept.append(rows)

    rec = run_checked(lambda _: api_query(df, F), check, "API path",
                      concats=True)
    if kept[0] != kept[1]:
        raise AssertionError("API path: the two collects differ")
    out = os.path.join(tmp, "api")
    stats = api_query(df, F).write_parquet(out)
    back = session.read.parquet(out).collect()
    host_df = DataFrame(InMemoryScan(parts, parts[0].schema, 1),
                        host_session)
    t0 = time.monotonic()
    host = api_query(host_df, F).collect()
    host_s = time.monotonic() - t0
    ri = names.index("r")
    strip = [tuple(x for i, x in enumerate(r) if i != ri) for r in back]
    if strip != [tuple(x for i, x in enumerate(r) if i != ri)
                 for r in host]:
        raise AssertionError("API path: the rows read back != the host "
                             "engine's")
    if [r[ri] for r in back] != [r[ri] for r in kept[1]]:
        raise AssertionError("API path: rand read back != collected")
    print(f"API path: {len(back)} rows written ({stats}) and read back == "
          f"the host engine's ({host_s:.1f} s) but rand; ids unique, their "
          "high bits the partition id, rand == the device form on CPU "
          "tensors", flush=True)
    # round robin and coalesce: each partition's rows exact
    ns = [p.num_rows for p in parts]
    for label, frame, n in (("repartition(16)", df.repartition(16), 16),
                            ("coalesce(2)", df.coalesce(2), 2)):
        got = dict(frame.with_column("p", F.spark_partition_id())
                   .group_by("p").agg(F.count("*").alias("n"))
                   .collect())
        want = {p: sum(nb // n + (p < nb % n) for nb in ns)
                for p in range(n)}
        if got != want:
            raise AssertionError(f"{label}: rows per partition {got}, "
                                 f"not {want}")
        print(f"{label}: rows per partition == round robin's {want}",
              flush=True)
    # the global sort through the range split
    price = np.asarray(table["l_extendedprice"][1])
    okey = np.asarray(table["l_orderkey"][1])
    order = np.lexsort((okey, -price))
    t0 = time.monotonic()
    frame = df.order_by(df["l_extendedprice"].desc(), "l_orderkey") \
        .select("l_extendedprice", "l_orderkey")
    got = session.execute(frame.plan)  # numpy columns, no row objects
    ms = (time.monotonic() - t0) * 1e3
    metrics = dict(session.last_metrics)
    if not (np.array_equal(got.columns[0].values, price[order]) and
            np.array_equal(got.columns[1].values, okey[order])):
        raise AssertionError("orderBy through the range split != numpy")
    print(f"orderBy(desc(l_extendedprice), l_orderkey): {len(order)} rows "
          f"in numpy's order, {ms:.1f} ms with the collect, metrics "
          f"{metrics}", flush=True)
    return rec


def run_methods(session, li, batch_rows):
    """(d) The DataFrame methods over lineitem (6,000,000 rows) on the
    split session, each against numpy."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch import types as T
    t = {k: np.asarray(v) for k, (_, v) in li.items()}
    base = q3_tables(session, {"li": {k: li[k] for k in (
        "l_orderkey", "l_returnflag", "l_linestatus", "l_quantity",
        "l_extendedprice", "l_discount")}}, batch_rows)["li"]
    q, disc = t["l_quantity"], t["l_discount"]
    nul = base.with_column("disc_q", F.when(base["l_quantity"] > 25,
                                            base["l_discount"])
                           .otherwise(F.lit(None).cast(T.DOUBLE)))
    t0 = time.monotonic()
    done = []  # (method, seconds since the previous one)
    last = [t0]

    def note(label):
        now = time.monotonic()
        done.append(f"{label} {now - last[0]:.2f} s")
        last[0] = now

    def same(label, got, want):
        if got != want:
            raise AssertionError(f"{label}: {got!r} != numpy's {want!r}")
        note(label)

    keys = list(zip(t["l_returnflag"].tolist(), t["l_linestatus"].tolist()))
    first = {}
    for i, k in enumerate(keys):
        first.setdefault(k, i)
    got = sorted(base.drop_duplicates(["l_returnflag", "l_linestatus"])
                 .collect(), key=lambda r: (r[0], r[1]))
    same("drop_duplicates", got, [
        (str(k[0]), str(k[1]), int(t["l_orderkey"][i]), float(q[i]),
         float(t["l_extendedprice"][i]), float(disc[i]))
        for k, i in sorted(first.items())])
    same("dropna", nul.dropna(subset=["disc_q"]).count(),
         int((q > 25).sum()))
    filled = nul.fillna(0.0, subset=["disc_q"]).agg(
        F.sum("disc_q").alias("s")).collect()[0][0]
    np.testing.assert_allclose(filled, np.where(q > 25, disc, 0.0).sum(),
                               rtol=1e-9, err_msg="fillna")
    note("fillna")
    desc = {r[0]: r[1:] for r in base.describe(
        "l_quantity", "l_extendedprice").collect()}
    for j, c in enumerate(("l_quantity", "l_extendedprice")):
        v = t[c]
        if (desc["count"][j], desc["min"][j], desc["max"][j]) != (
                str(len(v)), str(float(v.min())), str(float(v.max()))):
            raise AssertionError(f"describe {c}: {desc}")
        np.testing.assert_allclose(
            [float(desc["mean"][j]), float(desc["stddev"][j])],
            [v.mean(), v.std(ddof=1)], rtol=1e-9,
            err_msg=f"describe {c}")
    note("describe")
    piv = base.group_by("l_returnflag").pivot("l_linestatus") \
        .sum("l_quantity")
    statuses = sorted(set(t["l_linestatus"].tolist()))
    if piv.columns != ["l_returnflag"] + statuses:
        raise AssertionError(f"pivot columns {piv.columns}")
    for r in piv.collect():
        for s_, v in zip(statuses, r[1:]):
            at = (t["l_returnflag"] == r[0]) & (t["l_linestatus"] == s_)
            want = q[at].sum() if at.any() else None
            if (v is None) != (want is None) or (
                    v is not None and abs(v - want) > 1e-9 * want):
                raise AssertionError(f"pivot {r[0]} {s_}: {v} != {want}")
    note("pivot")
    ct = {r[0]: r[1:] for r in base.crosstab("l_returnflag",
                                             "l_linestatus").collect()}
    for flag_, counts in ct.items():
        want = tuple(int(((t["l_returnflag"] == flag_) &
                          (t["l_linestatus"] == s_)).sum())
                     for s_ in statuses)
        same(f"crosstab {flag_}", tuple(counts), want)
    np.testing.assert_allclose(
        base.approx_quantile("l_quantity", [0.25, 0.5, 0.75]),
        np.percentile(q, [25, 50, 75]), rtol=1e-9,
        err_msg="approx_quantile")
    note("approx_quantile")
    flags, fcounts = np.unique(t["l_returnflag"], return_counts=True)
    same("freq_items", sorted(base.freq_items(["l_returnflag"], 0.3)
                              .collect()[0][0]),
         sorted(str(f) for f, c in zip(flags, fcounts)
                if c > 0.3 * len(q)))

    def row(i):
        return (int(t["l_orderkey"][i]), str(t["l_returnflag"][i]),
                str(t["l_linestatus"][i]), float(q[i]),
                float(t["l_extendedprice"][i]), float(disc[i]))

    same("head", base.head(3), [row(i) for i in range(3)])
    same("take", base.take(5), [row(i) for i in range(5)])
    same("first", base.first(), row(0))
    same("is_empty", base.is_empty(), False)
    same("is_empty (filtered)",
         base.filter(base["l_quantity"] < 0).is_empty(), True)
    wall = time.monotonic() - t0
    print(f"methods: {', '.join(done)} == numpy in {wall:.1f} s",
          flush=True)
    return {"methods": done, "wall_s": wall}


def exchange_phase(data=None, refs=None, kept=None, collapsed_ms=None
                   ) -> dict:
    """The exchange phase (module docstring, item 4): (a) the 22 TPC-H
    texts split, (b) a skewed join, (c) the partitioning API, (d) the
    DataFrame methods, all at ``SPLIT_SETTINGS`` over SF1's counts.
    ``data``/``refs`` are the SQL phase's tables and numpy answers, made
    here when None; ``kept`` the collapsed runs' rows and
    ``collapsed_ms`` their second-collect ms, by text.  Returns the runs
    and the recorded split pieces."""
    import torch
    from spark_rapids_tpu_torch import functions as F  # noqa: F401
    from spark_rapids_tpu_torch.config import (
        READER_BATCH_SIZE_ROWS, RapidsConf,
    )
    from spark_rapids_tpu_torch.session import GpuSparkSession
    t_phase = time.monotonic()
    if data is None:
        data, refs = split_tables()
        print(f"exchange phase tables and numpy answers in "
              f"{time.monotonic() - t_phase:.1f} s", flush=True)
    kept, collapsed_ms = kept or {}, collapsed_ms or {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    conf = RapidsConf(SPLIT_SETTINGS)
    batch_rows = READER_BATCH_SIZE_ROWS.get(conf)
    session = GpuSparkSession(conf)
    sql_tables(session, data, batch_rows)
    t0 = time.monotonic()
    runs, faults, pieces = run_split_texts(session, refs, kept,
                                           collapsed_ms)
    print(f"split texts: {len(runs)} of {len(SPLIT_TEXTS)} in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    if faults:
        raise AssertionError("; ".join(faults))
    del session
    torch.cuda.empty_cache()
    # (b) the skewed join, shuffled (broadcast off)
    skew_session = GpuSparkSession(RapidsConf(dict(
        SPLIT_SETTINGS, **{"spark.sql.autoBroadcastJoinThreshold": -1})))
    query, ref = skew_frames(skew_session, data, batch_rows)
    rec = run_checked(query, lambda rows: check_sql_rows(
        rows, ref, "skewed join"), "skewed join", concats=True)
    metrics = dict(skew_session.last_metrics)
    print(f"skewed join: plan\n"
          f"{skew_session.last_physical_plan.tree_string()}metrics "
          f"{metrics}", flush=True)
    if metrics.get("aqeSkewSplits", 0) < 1 or \
            metrics.get("skewSplitChunks", 0) <= 1:
        raise AssertionError(f"skewed join: no skew split {metrics}")
    rec.pop("windows")
    runs["skewed join"] = rec
    del skew_session, query
    torch.cuda.empty_cache()
    # (c) the partitioning API and (d) the methods
    session = GpuSparkSession(conf)
    host_session = GpuSparkSession(RapidsConf(dict(
        SPLIT_SETTINGS, **{"spark.rapids.sql.enabled": False})))
    li = data["lineitem"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_split_") as tmp:
        rec = run_api_path(session, host_session, li, batch_rows, tmp)
    pieces.extend(args for _, args in rec.pop("windows"))
    runs["API path"] = rec
    methods = run_methods(session, li, batch_rows)
    # the split's piece gather at lineitem's own shape: 6 batches into 8
    # targets, every column
    from spark_rapids_tpu_torch.plan.logical import InMemoryScan
    from spark_rapids_tpu_torch.dataframe import DataFrame
    from spark_rapids_tpu_torch.interop import host_batches
    parts = host_batches(li, batch_rows)
    li_df = DataFrame(InMemoryScan(parts, parts[0].schema, 1),
                      session).cache()
    li_df.agg(F.count("*")).collect()  # fill the cache
    with Recorder("pack_column_windows") as rec_w:
        li_df.repartition(8, "l_orderkey").agg(F.count("*")).collect()
    piece_args = max((args for _, args in rec_w.calls),
                     key=lambda a: a[3])
    check_windows(*piece_args, "lineitem piece")
    piece = _windows_numbers(*piece_args, torch.device("cuda", 0))
    piece["shape"] = (f"lineitem's {len(piece_args[1])} cached batches "
                      f"into 8 targets by l_orderkey: the largest piece, "
                      f"{piece['live_rows']} rows, {piece['buffers']} "
                      "buffers")
    print(f"gatherScatter split-piece shape: {json.dumps(piece)}",
          flush=True)
    wall = time.monotonic() - t_phase
    peak = torch.cuda.max_memory_allocated()
    print(f"exchange phase: wall {wall:.1f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB, card {card_line()}", flush=True)
    del session, host_session, li_df
    torch.cuda.empty_cache()
    return {"runs": runs, "pieces": len(pieces), "piece": piece,
            "methods": methods, "wall_s": wall, "peak_bytes": peak}


def _windows_numbers(columns, starts, counts, out_cap, byte_caps, device,
                     launches: int = 20) -> dict:
    """One split piece (every buffer): the wrapper, the kernel alone (its
    launch table built once, the launch replayed from a CUDA graph), the
    plain version, and the library (one ``torch.cat`` of the windows'
    ``narrow`` views per buffer into a preallocated output; offsets
    concatenated as they are, not rebased), and the host's parts, on the
    host clock: checking the k batches' buffers once an exchange
    (``inputs_ms``, a ``PackInputs``) and building a piece's launch table
    and outputs (``table_ms``).  Bytes: each window read once, each
    output written once, each varlen window's two element bounds read
    once."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_tier
    k = len(starts)
    nbytes = k * 8 * len(byte_caps)
    windows, outs = [], []
    str_caps = iter(byte_caps)
    for parts in columns:
        rows = [(v.narrow(0, s, c), d.narrow(0, s, c) if o is None else None)
                for (d, v, o), s, c in zip(parts, starts, counts)]
        bufs = [([r[0] for r in rows], out_cap)]
        if parts[0][2] is None:
            bufs.append(([r[1] for r in rows], out_cap))
        else:
            ends = [(int(o[s]), int(o[s + c]))
                    for (_, _, o), s, c in zip(parts, starts, counts)]
            bufs.append(([d.narrow(0, a, b - a) for (d, _, _), (a, b) in
                          zip(parts, ends)], next(str_caps)))
            bufs.append(([o.narrow(0, s, c + 1) for (_, _, o), s, c in
                          zip(parts, starts, counts)], out_cap + 1))
        for wins, cap in bufs:
            got = sum(int(w.numel()) for w in wins)
            width = wins[0].element_size()
            nbytes += got * width + cap * width
            windows.append(wins)
            outs.append(torch.empty(got, dtype=wins[0].dtype,
                                    device=device))

    def library():
        for wins, out in zip(windows, outs):
            torch.cat(wins, out=out)

    def call():  # as the split calls it: inputs checked once an exchange
        return cuda_tier.pack_column_windows(None, starts, counts, out_cap,
                                             byte_caps, inputs=inputs)

    inputs = cuda_tier.PackInputs(columns)

    def table():
        return cuda_tier._windows_table(inputs, starts, counts, out_cap,
                                        byte_caps)

    desc, _outs = table()
    table_ms = host_ms(table)
    inputs_ms = host_ms(lambda: cuda_tier.PackInputs(columns))
    torch.cuda.synchronize()
    return {
        "ms": time_ms(call), "table_ms": table_ms, "inputs_ms": inputs_ms,
        "kernel_only_ms": graph_ms(lambda: cuda_tier._run_pack(desc, device),
                                   launches),
        "plain_ms": time_ms(lambda: cuda_tier.pack_column_windows_reference(
            columns, starts, counts, out_cap, byte_caps), reps=10, warmup=2),
        "library_ms": time_ms(library),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
        "buffers": len(windows), "live_rows": sum(counts),
    }


# ---------------------------------------------------------------------------
# memory phase: the spill catalog, the OOM retry and the fault ladder
# ---------------------------------------------------------------------------

#: the out-of-core run's own settings (oocore_run.py main: sf 10, a
#: 256 MiB device budget, Q1 and Q18), over parquet files
MEMORY_SF = 10
MEMORY_BUDGET = 256 << 20
MEMORY_TABLES = ("lineitem", "orders", "customer")
#: the SQL phases' hasNans setting keeps Q18's aggregate (a DOUBLE group
#: key) on the card
MEMORY_EXTRA = {"spark.rapids.sql.hasNans": False}
#: the fault ladder's counters: 0 on every collect of a phase that
#: injects no fault
FAULT_COUNTERS = ("retryCount", "deviceLostCount", "partitionFallbackCount",
                  "faultsInjected")
#: (c)-(e) run Q1 over lineitem at this generator sf (6,000,000 rows)
FAULT_SF = 100
#: (d): spec -> the counters it implies (retryCount, deviceLostCount,
#: partitionFallbackCount, faultsInjected) and the source it runs over
FAULT_SPECS = {
    "dispatch:oom@3": ((1, 0, 0, 1), "plain"),
    "h2d:device_lost@1": ((1, 1, 0, 1), "plain"),
    "d2h:device_lost@1": ((1, 1, 0, 1), "plain"),
    "unspill:oom@1": ((1, 0, 0, 1), "cached-small"),
    "spill:slow=200ms@2": ((0, 0, 0, 1), "cached-small"),
    "dispatch:device_lost@1+": ((2, 3, 1, 3), "plain"),
    "exchange:device_lost@1": ((1, 1, 0, 1), "split"),
    "scan:device_lost@1": ((1, 1, 0, 1), "parquet"),
    "dispatch:slow=2s@2": ((1, 1, 0, 1), "timeout"),
}
#: the timeout's source: lineitem's first batches, so the replay fits
#: inside the 0.5 s deadline
TIMEOUT_BATCHES = 2
#: (d)'s cached source's budget: lineitem's 6,000,000 rows spill
FAULT_SMALL_BUDGET = 64 << 20
_GUARD = {"on": True, "collects": 0}


def install_fault_guard() -> None:
    """Every collect of a phase that injects no fault must leave the fault
    ladder's counters at 0: a failing kernel or device op must fail the
    run, not complete it on the host.  (c)-(e) turn the guard off."""
    from spark_rapids_tpu_torch.session import GpuSparkSession
    execute = GpuSparkSession.execute

    def guarded(self, plan):
        out = execute(self, plan)
        if _GUARD["on"]:
            import torch
            bad = {k: self.last_metrics[k] for k in FAULT_COUNTERS
                   if self.last_metrics.get(k)}
            if bad:
                raise AssertionError(
                    f"a collect with no fault injected engaged the fault "
                    f"ladder: {bad} (its errors are logged above; peak "
                    f"device memory {torch.cuda.max_memory_allocated()})")
            _GUARD["collects"] += 1
        return out

    GpuSparkSession.execute = guarded


def q18_reference(data):
    """Q18's numpy answer (as :func:`sql_references_more` makes it)."""
    c, o, li = _np(data["customer"]), _np(data["orders"]), \
        _np(data["lineitem"])
    n_c, n_o = len(c["c_custkey"]), len(o["o_orderkey"])
    l_ord = _partner(li["l_orderkey"], n_o)
    o_cust = _partner(o["o_custkey"], n_c)
    big_qty = np.bincount(l_ord, weights=li["l_quantity"],
                          minlength=n_o + 1)[:n_o]
    idx = np.nonzero((big_qty > 150) & (o_cust < n_c))[0]
    rows = {"c_name": c["c_name"][o_cust[idx]],
            "c_custkey": c["c_custkey"][o_cust[idx]],
            "o_orderkey": o["o_orderkey"][idx],
            "o_orderdate": o["o_orderdate"][idx],
            "o_totalprice": o["o_totalprice"][idx],
            "total_qty": big_qty[idx]}
    return (list(rows), _ordered(rows, [
        -rows["o_totalprice"], rows["o_orderdate"], rows["o_orderkey"]],
        100), ["c_name", "c_custkey", "o_orderkey", "o_orderdate"])


def table_device_bytes(table) -> int:
    """An upper bound of a generator table's bytes on the card: each
    fixed-width value, a validity byte a row, a string's characters as
    its numpy width plus four offset bytes."""
    total = 0
    for _, values in table.values():
        v = np.asarray(values)
        n = len(v)
        if v.dtype.kind == "U":
            total += n * (v.dtype.itemsize // 4 + 4 + 1)
        else:
            total += n * (v.dtype.itemsize + 1)
    return total


class PrioritySpills:
    """Counts, while installed, the catalog's device -> host spills and
    its unspills by the handle's priority band."""

    def __enter__(self):
        from spark_rapids_tpu_torch.mem import catalog as C
        self.spilled, self.unspilled = {}, {}
        self._begin = C.BufferCatalog._begin_spill_locked
        self._unspill = C.SpillableBatch._unspill
        begin, unspill = self._begin, self._unspill

        def counted_begin(cat, victim):
            task = begin(cat, victim)
            self.spilled[victim.priority] = \
                self.spilled.get(victim.priority, 0) + 1
            return task

        def counted_unspill(h, tier):
            out = unspill(h, tier)
            self.unspilled[h.priority] = self.unspilled.get(h.priority, 0) + 1
            return out

        C.BufferCatalog._begin_spill_locked = counted_begin
        C.SpillableBatch._unspill = counted_unspill
        return self

    def __exit__(self, *exc):
        from spark_rapids_tpu_torch.mem import catalog as C
        C.BufferCatalog._begin_spill_locked = self._begin
        C.SpillableBatch._unspill = self._unspill
        return False


def memory_line(session, label: str, wall_s: float, card: str) -> dict:
    """One step's figures on a line: collect ms, the catalog's spill
    counters and bytes, handles and bytes by tier now, peak device
    memory and the fault counters."""
    import torch
    cat = session.runtime.catalog
    m = session.last_metrics
    rec = {"collect_ms": wall_s * 1e3,
           "spilled_to_host": cat.metrics["spilled_to_host"],
           "spilled_to_disk": cat.metrics["spilled_to_disk"],
           "unspilled": cat.metrics["unspilled"],
           "spill_to_host_bytes": cat.metrics["spill_to_host_bytes"],
           "disk_bytes_written": cat.metrics["spill_to_disk_bytes"],
           "oom_spill_bytes": cat.metrics["oom_spill_bytes"],
           "handles_by_tier": cat.tier_counts(),
           "bytes_by_tier": cat.tier_bytes(),
           "query": {k: v for k, v in m.items()
                     if k in FAULT_COUNTERS or "pill" in k or
                     k in ("unspilled", "oomSpillBytes")},
           "peak_bytes": torch.cuda.max_memory_allocated()}
    print(f"memory [{label}]: {json.dumps(rec)}; card {card}", flush=True)
    return rec


def _collect(query, label: str, check):
    """One collect, timed between device syncs, its rows checked."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_tier
    cuda_tier.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    rows = query(None).collect()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    check(rows)
    return rows, wall


#: the memory phase's data process and the directory it writes into
_MEMORY_DATA = {}


def memory_data(root: str) -> int:
    """``chip_smoke.py --memory-data DIR``: the memory phase's tables
    (SF10's lineitem, orders and customer) made and written as parquet
    under ``DIR``, their numpy answers pickled to ``DIR/_refs.pkl``.  It
    runs in a process of its own, started before the earlier phases, so
    the ~110 s of host work overlaps them."""
    import pickle
    import shutil
    from spark_rapids_tpu_torch.benchmarks import oocore_run
    from spark_rapids_tpu_torch.config import (
        HOST_SPILL_STORAGE_SIZE, RapidsConf,
    )
    t0 = time.monotonic()
    gens = oocore_run._generators()
    per = oocore_run.GEN_PER_TRUE_SF
    data = {name: gens[name](MEMORY_SF * per) for name in MEMORY_TABLES}
    refs = {"q1": q1_reference(data["lineitem"]), "q18": q18_reference(data)}
    device_bytes = sum(table_device_bytes(t) for t in data.values())
    host_store = HOST_SPILL_STORAGE_SIZE.get(RapidsConf())
    to_disk = max(device_bytes - MEMORY_BUDGET - host_store, 0)
    free = shutil.disk_usage(tempfile.gettempdir()).free
    counts = ", ".join(f"{k} {len(next(iter(v.values()))[1])}"
                       for k, v in data.items())
    print(f"memory phase data: {counts} rows, at most {device_bytes} bytes "
          f"on the card, ~{to_disk} bytes expected on disk, {free} bytes "
          f"free in {tempfile.gettempdir()}; generated and answered in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    # the parquet files take at most half the bytes on the card
    need = 2 * to_disk + device_bytes // 2
    if free < need:
        raise AssertionError(
            f"the spill directory {tempfile.gettempdir()} has {free} bytes "
            f"free, under the {need} bytes of twice the disk tier's "
            "expected bytes and the parquet files")
    t0 = time.monotonic()
    for name, table in data.items():
        oocore_run.write_table(table, os.path.join(root, name))
    with open(os.path.join(root, "_refs.pkl"), "wb") as f:
        pickle.dump(refs, f)
    print(f"memory phase data: parquet written in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    return 0


def start_memory_data() -> None:
    """Start the memory phase's data process (:func:`memory_data`)."""
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_oocore_")
    _MEMORY_DATA["tmp"] = tmp
    _MEMORY_DATA["proc"] = subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__), "--memory-data",
         tmp.name])


def wait_memory_data():
    """(parquet root, numpy answers) once the data process has ended;
    fails when it failed."""
    import pickle
    t0 = time.monotonic()
    proc = _MEMORY_DATA.pop("proc")
    rc = proc.wait(timeout=1200)
    if rc != 0:
        raise AssertionError(f"the memory phase's data process exited {rc}")
    root = _MEMORY_DATA["tmp"].name
    with open(os.path.join(root, "_refs.pkl"), "rb") as f:
        refs = pickle.load(f)
    print(f"memory phase: waited {time.monotonic() - t0:.1f} s for its "
          "data", flush=True)
    return root, refs


def stop_memory_data() -> None:
    """Kill the data process if it still runs (a run that failed before
    the memory phase) and remove its directory."""
    proc = _MEMORY_DATA.pop("proc", None)
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()
    tmp = _MEMORY_DATA.pop("tmp", None)
    if tmp is not None:
        tmp.cleanup()


def out_of_core_steps(card: str) -> dict:
    """(a) Q1 and Q18 over SF10's lineitem, orders and customer, from
    parquet cached in one session under 256 MiB, two collects each, rows
    against numpy, every recorded gatherScatter and stringHash call
    against its plain version; (b) Q18 split into 8 partitions under the
    same budget, its shuffle pieces spilled and read back; Q1 at the
    default budget."""
    import torch
    from spark_rapids_tpu_torch.benchmarks import oocore_run
    from spark_rapids_tpu_torch.config import DEVICE_SPILL_BUDGET
    from spark_rapids_tpu_torch.kernels import cuda_tier
    from spark_rapids_tpu_torch.mem.catalog import PRIORITY_SHUFFLE_OUTPUT
    out = {}
    root, refs = wait_memory_data()
    q1_names = ["l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
                "avg_qty", "avg_price", "avg_disc", "count_order"]
    checks = {
        "q1": lambda label: (lambda rows: check_string_rows(
            rows, q1_names, refs["q1"], label)),
        "q18": lambda label: (lambda rows: check_sql_rows(
            rows, refs["q18"], label))}
    kept = {}
    session = oocore_run.session(True, root, MEMORY_BUDGET, MEMORY_EXTRA,
                                 tables=MEMORY_TABLES)
    if session.runtime.catalog.device_budget != MEMORY_BUDGET:
        raise AssertionError("the spill budget did not bind")
    for name in ("q1", "q18"):
        label = f"out of core {name.upper()} (SF{MEMORY_SF}, 256 MiB)"
        check = checks[name](label)

        def keep(rows, check=check, name=name):
            check(rows)
            kept[name] = rows

        t0 = time.monotonic()
        rec = run_checked(sql_query(session, name), keep, label,
                          concats=True)
        _require(rec["path"], label, ("gatherScatter", "stringHash"))
        out[label] = dict(memory_line(
            session, label, rec["path"]["collect2"]["wall_s"], card),
            path=rec["path"], hash_err=rec["hash_err"],
            step_s=time.monotonic() - t0)
        del rec
    for k in ("spilled_to_host", "spilled_to_disk", "unspilled"):
        total = session.runtime.catalog.metrics[k]
        if total <= 0:
            raise AssertionError(f"out of core: {k} is {total}")
    # (b) Q18 split into 8 partitions over the same cache and budget, one
    # collect, every piece's and stringHash call held to its plain version
    session.conf.set("spark.rapids.sql.tpu.exchange.collapseLocal", False)
    session.conf.set("spark.sql.shuffle.partitions", 8)
    label = f"out of core Q18 split into 8 (SF{MEMORY_SF}, 256 MiB)"
    t0 = time.monotonic()
    with PrioritySpills() as bands, \
            Recorder("string_hash_columns") as hashes, \
            Recorder("pack_column_windows") as windows:
        _, wall = _collect(sql_query(session, "q18"), label, lambda rows: (
            checks["q18"](label)(rows),
            check_same_rows(rows, kept["q18"], f"{label} vs (a)")))
        launches = {n: cuda_tier.launch_count(n) for n in cuda_tier.SOURCES}
    for i, (origin, args) in enumerate(windows.calls):
        check_windows(*args, f"{label}, piece {i} ({origin})")
    hash_err = max((check_hashes(args[0], f"{label}, {origin}")
                    for origin, args in hashes.calls), default=0)
    pieces = session.last_metrics.get("shufflePieces", 0)
    _require({"collect1": {"launches": launches},
              "collect2": {"launches": launches}}, label,
             ("gatherScatter", "stringHash"))
    if len(windows.calls) < pieces or not pieces or \
            not bands.spilled.get(PRIORITY_SHUFFLE_OUTPUT) or \
            not bands.unspilled.get(PRIORITY_SHUFFLE_OUTPUT):
        raise AssertionError(f"{label}: launches {launches}, {pieces} "
                             f"pieces, {len(windows.calls)} checked, spills "
                             f"by band {bands.spilled}, unspills "
                             f"{bands.unspilled}")
    print(f"{label}: {len(windows.calls)} pieces and {len(hashes.calls)} "
          "stringHash calls == plain versions on their own inputs",
          flush=True)
    out[label] = dict(memory_line(session, label, wall, card),
                      path={"collect2": {"wall_s": wall,
                                         "launches": launches}},
                      hash_err=hash_err, pieces=pieces,
                      spilled_by_band=bands.spilled,
                      unspilled_by_band=bands.unspilled,
                      step_s=time.monotonic() - t0)
    del windows, hashes
    for name in MEMORY_TABLES:
        session.table(name).unpersist()
    del session
    torch.cuda.empty_cache()
    # Q1 at the default budget: nothing spills, for the cost of spilling
    label = f"Q1 at the default budget (SF{MEMORY_SF})"
    session = oocore_run.session(True, root, None, MEMORY_EXTRA,
                                 tables=("lineitem",))
    query = sql_query(session, "q1")
    _collect(query, label, checks["q1"](label))
    with PrioritySpills() as bands:
        rows, wall = _collect(query, label, checks["q1"](label))
    if session.runtime.catalog.metrics["spilled_to_host"] or bands.spilled:
        raise AssertionError(f"{label} spilled under "
                             f"{DEVICE_SPILL_BUDGET.get(session.conf)} "
                             "bytes")
    out[label] = memory_line(session, label, wall, card)
    session.table("lineitem").unpersist()
    del session
    _MEMORY_DATA.pop("tmp").cleanup()
    torch.cuda.empty_cache()
    return out


def oom_step(li_parts, check, card: str) -> dict:
    """(c) A real allocator OOM: lineitem cached under the default budget;
    the caching allocator's cap lowered (per-process memory fraction)
    until Q1's working set no longer fits beside the cache.  The collect
    must hit torch's OutOfMemoryError, spill the cache and replay on the
    card with the rows right; the cap is put back after each try."""
    import torch
    from spark_rapids_tpu_torch.config import (
        DEVICE_POOL_FRACTION, RapidsConf,
    )
    from spark_rapids_tpu_torch.dataframe import DataFrame
    from spark_rapids_tpu_torch.plan.logical import InMemoryScan
    from spark_rapids_tpu_torch.session import GpuSparkSession
    device = torch.device("cuda", 0)
    session = GpuSparkSession(RapidsConf(SQL_SETTINGS))
    DataFrame(InMemoryScan(li_parts, li_parts[0].schema, 1), session) \
        .cache().create_or_replace_temp_view("lineitem")
    query = sql_query(session, "q1")
    label = "real OOM Q1"
    _collect(query, label, check)  # fills the cache
    torch.cuda.empty_cache()
    # the cap counts the caching allocator's reserved segments
    base = torch.cuda.memory_reserved(device)
    _, wall = _collect(query, label, check)
    work = torch.cuda.max_memory_reserved(device) - base
    cached = session.runtime.catalog.device_bytes_in_use()
    total = torch.cuda.get_device_properties(device).total_memory
    tries = []
    rec = None
    for share in (0.25, 0.35, 0.15, 0.45):
        cap = base + work - int(share * cached)
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(cap / total, device)
        try:
            rows, wall = _collect(query, label, check)
        finally:
            torch.cuda.set_per_process_memory_fraction(
                float(DEVICE_POOL_FRACTION.get(session.conf)), device)
        m = dict(session.last_metrics)
        tries.append({"cap": cap, "retry": m.get("retryCount", 0),
                      "fallback": m.get("partitionFallbackCount", 0),
                      "oom_spill_bytes": m.get("oomSpillBytes", 0),
                      "collect_ms": wall * 1e3})
        print(f"{label}: base {base}, working set {work}, cache {cached}, "
              f"cap {cap}: {tries[-1]}", flush=True)
        if m.get("retryCount", 0) >= 1 and \
                not m.get("partitionFallbackCount"):
            rec = memory_line(session, label, wall, card)
            break
    if rec is None or rec["oom_spill_bytes"] <= 0:
        raise AssertionError(f"{label}: no cap gave an OOM that the spill "
                             f"and a replay on the card answered: {tries}")
    session.table("lineitem").unpersist()
    del session
    torch.cuda.empty_cache()
    return dict(rec, tries=tries, base=base, working_set=work,
                cache_bytes=cached)


def encoded(parts):
    """Host batches with every string column held as bytes and offsets,
    so staging them is a copy (no encoding step a batch)."""
    from spark_rapids_tpu_torch.batch import (
        HostBatch, _string_host_to_buffers, string_column,
    )
    out = []
    for hb in parts:
        cols = []
        for c in hb.columns:
            if c.dtype.is_string and c.offsets is None:
                offsets, raw = _string_host_to_buffers(c.values, c.validity)
                c = string_column(c.dtype, raw, offsets, c.validity)
            cols.append(c)
        out.append(HostBatch(hb.schema, cols))
    return out


def fault_steps(lineitem, li_parts, check, card: str) -> dict:
    """(d) One collect of Q1 a spec, each spec's counters exact, the rows
    right every time (the timeout's over its own first batches)."""
    import torch
    from spark_rapids_tpu_torch.benchmarks import oocore_run
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.dataframe import DataFrame
    from spark_rapids_tpu_torch.plan.logical import InMemoryScan
    from spark_rapids_tpu_torch.session import GpuSparkSession
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_faults_")
    pq_dir = oocore_run.write_table(lineitem, os.path.join(tmp.name, "li"))

    li_parts = encoded(li_parts)
    head = li_parts[:TIMEOUT_BATCHES]
    n_head = sum(hb.num_rows for hb in head)
    head_ref = q1_reference({k: (t, np.asarray(v)[:n_head])
                             for k, (t, v) in lineitem.items()})
    names = ["l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
             "avg_qty", "avg_price", "avg_disc", "count_order"]

    def plain(extra=None, parts=li_parts):
        s = GpuSparkSession(RapidsConf(dict(SQL_SETTINGS, **(extra or {}))))
        DataFrame(InMemoryScan(parts, parts[0].schema, 1), s) \
            .create_or_replace_temp_view("lineitem")
        return s

    def cached_small():
        s = GpuSparkSession(RapidsConf(dict(
            SQL_SETTINGS,
            **{"spark.rapids.memory.tpu.spillBudgetBytes":
               FAULT_SMALL_BUDGET})))
        DataFrame(InMemoryScan(li_parts, li_parts[0].schema, 1), s) \
            .cache().create_or_replace_temp_view("lineitem")
        _collect(sql_query(s, "q1"), "faults: cache fill", check)
        return s

    def parquet():
        s = GpuSparkSession(RapidsConf(SQL_SETTINGS))
        s.read.parquet(pq_dir).create_or_replace_temp_view("lineitem")
        return s

    makers = {
        "plain": plain, "cached-small": cached_small, "parquet": parquet,
        "split": lambda: plain({
            "spark.rapids.sql.tpu.exchange.collapseLocal": False,
            "spark.sql.shuffle.partitions": 8}),
        "timeout": lambda: plain({
            "spark.rapids.sql.tpu.partition.timeoutSec": 0.5}, head)}
    sessions = {}
    out = {}
    for spec, (want, source) in FAULT_SPECS.items():
        if source not in sessions:
            sessions[source] = makers[source]()
        s = sessions[source]
        s.conf.set("spark.rapids.sql.tpu.faults.spec", spec)
        label = f"fault {spec} ({source})"
        chk = check if source != "timeout" else (
            lambda rows: check_string_rows(rows, names, head_ref, label))
        try:
            _, wall = _collect(sql_query(s, "q1"), label, chk)
        finally:
            s.conf.set("spark.rapids.sql.tpu.faults.spec", "")
        got = tuple(s.last_metrics.get(k, 0) for k in FAULT_COUNTERS)
        out[label] = dict(memory_line(s, label, wall, card),
                          counters=dict(zip(FAULT_COUNTERS, got)))
        if got != want:
            raise AssertionError(f"{label}: counters "
                                 f"{dict(zip(FAULT_COUNTERS, got))}, the "
                                 f"spec implies "
                                 f"{dict(zip(FAULT_COUNTERS, want))}")
    for s in sessions.values():
        for name in ("lineitem",):
            s.table(name).unpersist()
    del sessions
    tmp.cleanup()
    torch.cuda.empty_cache()
    return out


def sticky_child() -> int:
    """(e), run as ``chip_smoke.py --sticky-child`` in a process of its
    own: one device exec's per-batch step (the filter's) is swapped here
    for one that first indexes out of bounds on the card, a device-side
    assert that poisons the process's CUDA context.  Q1 over lineitem must
    complete on the host operators with numpy's rows.  Prints its
    figures as a JSON line and leaves with ``os._exit`` (no destructor
    calls into the dead context)."""
    import torch
    from spark_rapids_tpu_torch.benchmarks import datagen
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.dataframe import DataFrame
    from spark_rapids_tpu_torch.interop import host_batches
    from spark_rapids_tpu_torch.ops.gpu_exec import GpuFilterExec
    from spark_rapids_tpu_torch.plan.logical import InMemoryScan
    from spark_rapids_tpu_torch.session import GpuSparkSession
    lineitem = datagen.gen_lineitem(FAULT_SF)
    ref = q1_reference(lineitem)
    parts = host_batches(lineitem, 1 << 20)
    # read-ahead off: no side stream whose events a freed buffer would
    # record into the dead context
    session = GpuSparkSession(RapidsConf(dict(
        SQL_SETTINGS, **{"spark.rapids.sql.tpu.stage.readAheadBatches": 0})))
    DataFrame(InMemoryScan(parts, parts[0].schema, 1), session) \
        .create_or_replace_temp_view("lineitem")
    real = GpuFilterExec._run

    def out_of_bounds(self, batch, *args, **kwargs):
        # the read syncs, so the assert surfaces here as torch's error (a
        # kernel launch that met it later would report it as its own
        # failure, which the ladder never completes on the host)
        x = torch.zeros(4, device=batch.device)
        x[torch.full((1,), 1 << 20, dtype=torch.int64,
                     device=batch.device)].sum().item()
        return real(self, batch, *args, **kwargs)

    GpuFilterExec._run = out_of_bounds
    t0 = time.monotonic()
    rows = session.sql(q1_text()).collect()
    wall = time.monotonic() - t0
    names = ["l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
             "avg_qty", "avg_price", "avg_disc", "count_order"]
    check_string_rows(rows, names, ref, "sticky child Q1")
    from spark_rapids_tpu_torch.benchmarks.oocore_run import _checksum
    print(json.dumps({"sticky_child": {
        "rows": len(rows), "checksum": _checksum(rows), "wall_s": wall,
        "poisoned": session.runtime.poisoned,
        "counters": {k: session.last_metrics.get(k, 0)
                     for k in FAULT_COUNTERS}}}), flush=True)
    sys.stdout.flush()
    os._exit(0)


def q1_checksum(ref):
    """``oocore_run._checksum`` of Q1's numpy answer: the row count and
    the numeric columns' sums in the text's column order."""
    cols = [ref["approx"]["sum_qty"], ref["approx"]["sum_base_price"],
            ref["approx"]["avg_qty"], ref["approx"]["avg_price"],
            ref["approx"]["avg_disc"], ref["exact"]["count_order"]]
    return (len(ref["keys"][0]),
            tuple(round(float(np.sum(c)), 2) for c in cols))


def sticky_step(lineitem, card: str) -> dict:
    """(e) the child's exit code, rows checksum and counters."""
    from spark_rapids_tpu_torch.benchmarks.oocore_run import checksums_agree
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--sticky-child"], capture_output=True,
                          text=True, timeout=300)
    took = time.monotonic() - t0
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith('{"sticky_child"')]
    if proc.returncode != 0 or not lines:
        raise AssertionError(
            f"sticky child: exit {proc.returncode}\n{proc.stdout[-4000:]}\n"
            f"{proc.stderr[-4000:]}")
    got = json.loads(lines[-1])["sticky_child"]
    want = q1_checksum(q1_reference(lineitem))
    counters = got["counters"]
    if not checksums_agree(got["checksum"], want) or not got["poisoned"] or \
            counters["deviceLostCount"] < 1 or \
            counters["partitionFallbackCount"] < 1:
        raise AssertionError(f"sticky child: {got}")
    rec = dict(got, process_s=took, numpy_checksum=want)
    print(f"memory [sticky CUDA error, child process]: {json.dumps(rec)}; "
          f"card {card}", flush=True)
    return rec


def memory_phase(card: str) -> dict:
    """(a)-(e) in turn; the fault guard off for (c) and (d), which
    engage the ladder on purpose."""
    from spark_rapids_tpu_torch.benchmarks import datagen
    from spark_rapids_tpu_torch.interop import host_batches
    t_phase = time.monotonic()
    steps = out_of_core_steps(card)
    lineitem = datagen.gen_lineitem(FAULT_SF)
    ref = q1_reference(lineitem)
    parts = host_batches(lineitem, 1 << 20)
    names = ["l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
             "avg_qty", "avg_price", "avg_disc", "count_order"]

    def check(rows):
        check_string_rows(rows, names, ref, "memory phase Q1")

    _GUARD["on"] = False
    try:
        t0 = time.monotonic()
        steps["real OOM Q1"] = oom_step(parts, check, card)
        print(f"memory phase: real OOM step in {time.monotonic() - t0:.1f} "
              "s", flush=True)
        t0 = time.monotonic()
        steps.update(fault_steps(lineitem, parts, check, card))
        print(f"memory phase: {len(FAULT_SPECS)} injected specs in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
    finally:
        _GUARD["on"] = True
    steps["sticky CUDA error"] = sticky_step(lineitem, card)
    wall = time.monotonic() - t_phase
    print(f"memory phase: {len(steps)} steps in {wall:.1f} s; card {card}",
          flush=True)
    return {"steps": steps, "wall_s": wall}


def q1_text() -> str:
    from spark_rapids_tpu_torch.benchmarks.tpch_like import QUERIES
    return QUERIES["q1"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch.batch import HostBatch
    from spark_rapids_tpu_torch.benchmarks import datagen
    from spark_rapids_tpu_torch.config import (
        READER_BATCH_SIZE_ROWS, RapidsConf,
    )
    from spark_rapids_tpu_torch.dataframe import DataFrame
    from spark_rapids_tpu_torch.interop import host_batches
    from spark_rapids_tpu_torch.kernels import cuda_tier
    from spark_rapids_tpu_torch.plan.logical import InMemoryScan
    from spark_rapids_tpu_torch.session import GpuSparkSession

    if "--memory-data" in sys.argv[1:]:
        # the memory phase's data, in a process of its own
        return memory_data(sys.argv[sys.argv.index("--memory-data") + 1])
    t_start = time.monotonic()
    card = card_line()
    device = torch.device("cuda", 0)
    # the scan lane's parquet files live here, never in the tree
    scan_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_scan_")
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.monotonic()
    built = cuda_tier.build_all()
    print(f"build: {time.monotonic() - t0:.1f} s {built}", flush=True)
    for name in cuda_tier.SOURCES:  # every library built and loadable
        cuda_tier.load(name)
    if "--sticky-child" in sys.argv[1:]:
        # the memory phase's step (e), in a process of its own
        return sticky_child()
    install_fault_guard()
    only = [a for a in sys.argv[1:] if a.endswith("-only")]
    if not only or only == ["--memory-only"]:
        # the memory phase's data is made while the earlier phases run
        start_memory_data()
    if "--memory-only" in sys.argv[1:]:
        # a development run of the memory phase alone; it prints no
        # result line
        memory = memory_phase(card)
        print(f"memory phase: {len(memory['steps'])} steps; wall "
              f"{time.monotonic() - t_start:.1f} s", flush=True)
        return 0
    if "--tpcds-only" in sys.argv[1:]:
        # a development run of the TPC-DS phase alone; it prints no
        # result line
        tpcds = tpcds_phase()
        print(f"TPC-DS phase: {len(tpcds)} texts; wall "
              f"{time.monotonic() - t_start:.1f} s", flush=True)
        return 0
    if "--etl-only" in sys.argv[1:]:
        # a development run of the ETL phase alone; it prints no result
        # line
        etl = etl_phase()
        print(f"ETL phase: {len(etl)} paths; wall "
              f"{time.monotonic() - t_start:.1f} s", flush=True)
        return 0
    if "--exchange-only" in sys.argv[1:]:
        # a development run of the exchange phase alone, after the
        # gatherScatter matrices its piece gather goes through; it prints
        # no result line
        cases = check_columns_matrix(device)
        print(f"kernel phase: gatherScatter (every buffer of a concat, row "
              f"windows) == plain version over {cases} cases", flush=True)
        exchange = exchange_phase()
        print(f"exchange phase: {len(exchange['runs'])} paths; wall "
              f"{time.monotonic() - t_start:.1f} s", flush=True)
        return 0
    if "--lanes-only" in sys.argv[1:]:
        # a development run of the mortgage and TPCxBB phase alone; it
        # prints no result line
        lanes = lanes_phase()
        print(f"lanes phase: {len(lanes)} paths; wall "
              f"{time.monotonic() - t_start:.1f} s", flush=True)
        return 0

    cases = check_pack_matrix(device)
    print(f"kernel phase: gatherScatter == plain version over {cases} "
          "single-buffer cases", flush=True)
    cases = check_columns_matrix(device)
    print(f"kernel phase: gatherScatter (every buffer of a concat) == plain "
          f"version over {cases} cases", flush=True)
    probe_matrix = probe_cases(device)
    for label, args, pair_cap in probe_matrix:
        check_probe(args, pair_cap, label)
    print(f"kernel phase: joinProbe == plain version over "
          f"{len(probe_matrix)} cases", flush=True)
    label, args, pair_cap = probe_matrix[-2]  # 2^20 x 2^22, no overflow
    probe_large = probe_numbers(args, pair_cap, label)
    print(f"joinProbe {label}: {json.dumps(probe_large)}", flush=True)
    del probe_matrix, args

    # ---- main path: the headline query -----------------------------------
    conf = RapidsConf(SETTINGS)
    batch_rows = READER_BATCH_SIZE_ROWS.get(conf)
    data = headline_data(ROWS)
    ref = numpy_reference(data)
    parts = [HostBatch.from_pydict({
        k: (t, v[s:s + batch_rows]) for k, (t, v) in data.items()})
        for s in range(0, ROWS, batch_rows)]
    session = GpuSparkSession(conf)  # CUDA by default
    if session.device.type != "cuda":
        raise AssertionError(f"session resolved to {session.device}")
    df = DataFrame(InMemoryScan(parts, parts[0].schema, 1), session).cache()
    multi = run_query(df, f"{len(parts)} batches", ref)
    _require(multi, "headline", ["gatherScatter"])

    # gatherScatter at the headline's own shape: the merge's concat of
    # its partials, every buffer in one call
    partials = merge_partials(session, device)
    columns, ns, out_cap, byte_caps = batch_columns(partials)
    check_columns(columns, ns, out_cap, byte_caps, "merge partials")
    max_err = 0.0
    for (gd, _, _), (wd, _, _) in zip(
            cuda_tier.pack_columns(columns, ns, out_cap, byte_caps),
            cuda_tier.pack_columns_reference(columns, ns, out_cap,
                                             byte_caps)):
        if gd.is_floating_point():
            max_err = max(max_err, float((gd - wd).abs().max()))
    main_shape = _concat_numbers(columns, ns, out_cap, byte_caps, device)
    main_shape["shape"] = (f"the merge's concat: {len(ns)} partials of "
                           f"capacity {partials[0].capacity}, "
                           f"{main_shape['live_rows']} live rows, "
                           f"{main_shape['buffers']} buffers -> out_cap "
                           f"{out_cap}")
    n_bw = 1 << 20
    bw_arrays = [torch.arange(n_bw, dtype=torch.int64, device=device) + j
                 for j in range(16)]
    bandwidth = _pack_numbers(bw_arrays, [0] * 16, [n_bw] * 16, 16 * n_bw,
                              device)
    bandwidth["shape"] = "16 windows of 2^20 int64"
    print(f"gatherScatter main-path shape: {json.dumps(main_shape)}",
          flush=True)
    print(f"gatherScatter bandwidth shape: {json.dumps(bandwidth)}",
          flush=True)

    # ---- bench.py's own form: one cached batch ---------------------------
    df1 = session.create_dataframe(data).cache()
    single = run_query(df1, "1 batch", ref)
    del df, df1, data, parts, partials, bw_arrays

    # ---- main path: TPC-H Q1 over lineitem -------------------------------
    t0 = time.monotonic()
    lineitem = datagen.gen_lineitem(LINEITEM_SF)
    q1_ref = q1_reference(lineitem)
    li_parts = host_batches(lineitem, batch_rows)
    li_df = DataFrame(InMemoryScan(li_parts, li_parts[0].schema, 1),
                      session).cache()
    print(f"lineitem: {len(lineitem['l_orderkey'][1])} rows in "
          f"{len(li_parts)} batches, generated and referenced in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    q1_names = ["l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
                "avg_qty", "avg_price", "avg_disc", "count_order"]
    kept = {}  # the DataFrame forms' last rows, for their SQL forms

    def check_q1(rows):
        check_string_rows(rows, q1_names, q1_ref, "Q1")
        kept["q1"] = rows

    q1 = run_path(li_df, q1_query, check_q1, "Q1")
    _require(q1, "Q1", ["gatherScatter", "stringHash"])
    # gatherScatter over string buffers: a concat of the cached lineitem
    # batches, every column (the string ones among them)
    li_args = batch_columns([h.get() for h in
                             li_df.plan.holder.partitions[0]])
    check_columns(*li_args, "lineitem batches")
    strings_shape = _concat_numbers(*li_args, device, launches=2)
    strings_shape["shape"] = (
        f"lineitem's {len(li_args[1])} cached batches, "
        f"{strings_shape['live_rows']} rows, {strings_shape['buffers']} "
        f"buffers ({len(li_args[3])} string columns) -> out_cap "
        f"{li_args[2]}")
    print(f"gatherScatter strings shape: {json.dumps(strings_shape)}",
          flush=True)
    del li_args
    del lineitem, li_parts

    # ---- main path: the part query ----------------------------------------
    t0 = time.monotonic()
    part = datagen.gen_part(PART_SF)
    part_ref = part_reference(part)
    p_parts = host_batches(part, batch_rows)
    p_df = DataFrame(InMemoryScan(p_parts, p_parts[0].schema, 1),
                     session).cache()
    print(f"part: {len(part['p_partkey'][1])} rows in {len(p_parts)} "
          f"batches, generated and referenced in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    part_names = ["p_brand", "p_type", "cnt", "avg_price", "min_size",
                  "max_size"]
    part_path = run_path(p_df, part_query, lambda rows: check_string_rows(
        rows, part_names, part_ref, "part"), "part")
    _require(part_path, "part query",
             ["gatherScatter", "stringHash", "strings"])
    del part, p_parts

    # ---- main path: TPC-H Q3, host-driven and fused on a one-device mesh -
    t0 = time.monotonic()
    q3_data = {"customer": datagen.gen_customer(Q3_SF),
               "orders": datagen.gen_orders(Q3_SF),
               "lineitem": datagen.gen_lineitem(Q3_SF)}
    q3_ref = q3_reference(**q3_data)
    t1 = time.monotonic()
    pq_dirs = write_tables(q3_data, scan_tmp.name)
    print(f"Q3 tables written as parquet in {time.monotonic() - t1:.1f} s",
          flush=True)
    print("Q3 tables: " + ", ".join(
        f"{k} {len(next(iter(v.values()))[1])} rows"
        for k, v in q3_data.items()) +
        f", generated and referenced in {time.monotonic() - t0:.1f} s",
        flush=True)
    q3_paths, q3_fallbacks = {}, {}
    for mode, extra in Q3_MODES.items():
        q3_session = GpuSparkSession(RapidsConf(dict(SETTINGS, **extra)))
        tables = q3_tables(q3_session, q3_data, batch_rows)

        def check(rows, m=mode, sess=q3_session):
            check_q3_rows(rows, q3_ref, f"Q3 {m}")
            check_q3_joins(sess, f"Q3 {m}", fused=bool(Q3_MODES[m]))
            kept[f"q3 {m}"] = rows

        with Recorder("probe_join") as recorder:
            q3_paths[mode] = run_path(tables, q3_query, check, f"Q3 {mode}",
                                      (recorder,))
        q3_fallbacks[mode] = q3_session.last_metrics.get(
            "joinOverflowFallback", 0)
        print(f"Q3 {mode}: plan\n{q3_session.last_physical_plan.tree_string()}"
              f"metrics {q3_session.last_metrics}; overflow rerun "
              f"{'fired' if q3_fallbacks[mode] else 'did not fire'}",
              flush=True)
        if mode == "mesh-fused":
            probe_calls = [args for _, args in recorder.calls]
            if len(probe_calls) != 2:
                raise AssertionError(f"Q3 {mode}: {len(probe_calls)} "
                                     "joinProbe calls, not two")
        else:
            segment = cached_column(tables["customer"], "c_mktsegment")
        groups = q3_groups_query(tables).collect()
        check_q3_groups(groups, q3_ref, f"Q3 {mode}")
        check_q3_joins(q3_session, f"Q3 {mode} (all groups)",
                       fused=bool(extra))
        print(f"Q3 {mode}: all {len(groups)} groups before the LIMIT equal "
              "numpy", flush=True)
        del tables
    _require(q3_paths["host-driven"], "Q3 host-driven",
             ["gatherScatter", "stringHash"])
    _require(q3_paths["mesh-fused"], "Q3 mesh-fused",
             ["gatherScatter", "stringHash", "joinProbe"])
    for i in (1, 2):
        n = q3_paths["mesh-fused"][f"collect{i}"]["launches"]["joinProbe"]
        if n < 2:
            raise AssertionError(f"Q3 mesh-fused collect {i} launched "
                                 f"joinProbe {n} times, not twice")
        if q3_paths["host-driven"][f"collect{i}"]["launches"]["joinProbe"]:
            raise AssertionError("Q3 host-driven launched joinProbe")

    # ---- Q3 at a small size: both joins broadcast, fused on the mesh -----
    bc_data = {"customer": datagen.gen_customer(Q3_BROADCAST_SF),
               "orders": datagen.gen_orders(Q3_BROADCAST_SF),
               "lineitem": datagen.gen_lineitem(Q3_BROADCAST_SF)}
    bc_ref = q3_reference(**bc_data)
    bc_session = GpuSparkSession(RapidsConf(dict(
        SETTINGS, **Q3_MODES["mesh-fused"])))
    bc_tables = q3_tables(bc_session, bc_data, batch_rows)

    def check_bc(rows):
        check_q3_rows(rows, bc_ref, "Q3 broadcast mesh-fused")
        check_q3_joins(bc_session, "Q3 broadcast mesh-fused", fused=True)

    bc_path = run_path(bc_tables, q3_query, check_bc,
                       "Q3 broadcast mesh-fused")
    bc_plan = bc_session.last_physical_plan.tree_string()
    print(f"Q3 broadcast mesh-fused: plan\n{bc_plan}metrics "
          f"{bc_session.last_metrics}", flush=True)
    if bc_plan.count("GpuBroadcastHashJoin") != 2:
        raise AssertionError("Q3 at the small size did not plan two "
                             "broadcast joins")
    _require(bc_path, "Q3 broadcast mesh-fused", ["stringHash", "joinProbe"])
    for i in (1, 2):
        n = bc_path[f"collect{i}"]["launches"]["joinProbe"]
        if n < 2:
            raise AssertionError(f"Q3 broadcast mesh-fused collect {i} "
                                 f"launched joinProbe {n} times, not twice")
    groups = q3_groups_query(bc_tables).collect()
    check_q3_groups(groups, bc_ref, "Q3 broadcast mesh-fused")
    check_q3_joins(bc_session, "Q3 broadcast mesh-fused (all groups)",
                   fused=True)
    print(f"Q3 broadcast mesh-fused: all {len(groups)} groups before the "
          "LIMIT equal numpy", flush=True)
    del bc_data, bc_tables

    # ---- main paths: the TPC-H texts through session.sql -----------------
    # TPC-H SF1's counts: Q3's customer, orders and lineitem, with supplier
    # 10,000 rows and nation and region whole; host-driven, and the join
    # queries fused on a one-device mesh too
    t0 = time.monotonic()
    sql_data = dict(q3_data, supplier=datagen.gen_supplier(SUPPLIER_SF),
                    nation=datagen.gen_nation(), region=datagen.gen_region(),
                    part=datagen.gen_part(SQL_PART_SF),
                    partsupp=datagen.gen_partsupp(SQL_PART_SF))
    sql_refs = sql_references(sql_data)
    sql_refs.update(sql_references_more(sql_data))
    sql_refs["q1"] = q1_ref
    print("SQL tables: " + ", ".join(
        f"{k} {len(next(iter(v.values()))[1])} rows"
        for k, v in sql_data.items()) +
        f", numpy answers in {time.monotonic() - t0:.1f} s", flush=True)
    sql_paths, sql_metrics = {}, {}
    sql_hash_err = sql_probe_err = 0
    sql_hash, sql_probe = {}, {}  # timings at the SQL paths' own shapes

    def time_probes(rec, label, names):
        for i, (join, (_, args)) in enumerate(zip(names, rec["probes"],
                                                  strict=True)):
            nums = probe_numbers(args[:-1], args[-1], f"{label}, {join}")
            print(f"joinProbe {label}, {join}: {json.dumps(nums)}",
                  flush=True)
            sql_probe[f"{label}, join {i + 1}"] = nums

    def time_hash(rec, key, origin, label):
        nums = hash_numbers(largest(rec["hashes"], origin), label)
        print(f"stringHash {label}: {json.dumps(nums)}", flush=True)
        sql_hash[key] = nums

    def keep(rec, label, metrics):
        nonlocal sql_hash_err, sql_probe_err
        sql_paths[label], sql_metrics[label] = rec["path"], metrics
        sql_hash_err = max(sql_hash_err, rec["hash_err"])
        sql_probe_err = max(sql_probe_err, rec["probe_err"])

    for mode, extra in Q3_MODES.items():
        sql_session = GpuSparkSession(RapidsConf(dict(SQL_SETTINGS,
                                                      **extra)))
        sql_tables(sql_session, sql_data, batch_rows)
        for name in SQL_KERNELS:
            if name in SQL_MORE or extra and (
                    name not in SQL_JOIN_QUERIES or name == "q5"):
                continue
            label = f"SQL {name.upper()} {mode}"

            def check(rows, name=name, label=label, m=mode):
                if name == "q1":
                    check_string_rows(rows, q1_names, q1_ref, label)
                    check_same_rows(rows, kept["q1"], f"{label} vs Q1")
                elif name == "q3":
                    check_q3_rows(rows, q3_ref, label)
                    check_same_rows(rows, kept[f"q3 {m}"], f"{label} vs Q3")
                else:
                    check_sql_rows(rows, sql_refs[name], label)
                kept[f"sql {name} {m}"] = rows

            rec = run_sql(sql_session, name, check, label)
            path = rec["path"]
            metrics = dict(sql_session.last_metrics)
            print(f"{label}: plan\n"
                  f"{sql_session.last_physical_plan.tree_string()}"
                  f"metrics {metrics}", flush=True)
            need = SQL_KERNELS[name] + (("joinProbe",) if extra else ())
            _require(path, label, need)
            if extra and metrics.get("meshJoinsFused", 0) == 0:
                raise AssertionError(f"{label}: no join ran fused")
            if not extra and path["collect2"]["launches"]["joinProbe"]:
                raise AssertionError(f"{label} launched joinProbe")
            keep(rec, label, metrics)
            # stringHash at shapes only the SQL paths make: Q12's IN over
            # l_shipmode and Q10's group sort by c_name, both on the
            # joined batch; joinProbe at SQL Q3's two whole-table joins
            if label == "SQL Q12 host-driven":
                time_hash(rec, "q12_in", "predicates.py:In.gpu_eval",
                          "Q12's IN over l_shipmode (the joined batch)")
            elif label == "SQL Q10 host-driven":
                time_hash(rec, "q10_sort", "sortkeys.py:string_key_hashes",
                          "Q10's group sort key c_name (the joined batch)")
            elif label == "SQL Q3 mesh-fused":
                time_probes(rec, label, ("customer x orders",
                                         "(customer x orders) x lineitem"))
            del rec
        del sql_session
    # Q12's one join fused with no overflow: at growth 4 its static pair
    # capacity (orders' 2^21 rows times 4) holds lineitem's 6,000,000
    # pairs, where the default 2 overflows and reruns host-driven
    sql_session = GpuSparkSession(RapidsConf(dict(
        SQL_SETTINGS, **Q3_MODES["mesh-fused"],
        **{"spark.rapids.sql.tpu.mesh.spmd.join.growthFactor": 4.0})))
    sql_tables(sql_session, sql_data, batch_rows)
    label = "SQL Q12 mesh-fused (growth 4)"
    rec = run_sql(sql_session, "q12",
                  lambda rows: check_sql_rows(rows, sql_refs["q12"], label),
                  label)
    metrics = dict(sql_session.last_metrics)
    print(f"{label}: metrics {metrics}", flush=True)
    _require(rec["path"], label, SQL_KERNELS["q12"] + ("joinProbe",))
    if metrics != {"meshJoinsFused": 1}:
        raise AssertionError(f"{label}: joins {metrics}, expected one "
                             "fused and no overflow")
    keep(rec, label, metrics)
    time_probes(rec, label, ("orders x lineitem",))
    del sql_session, rec
    torch.cuda.empty_cache()
    # the other fifteen texts, host-driven, at the same counts (part and
    # partsupp at TPC-H SF1's too); every text runs before any failure
    # is raised, so one run names them all
    sql_session = GpuSparkSession(RapidsConf(SQL_SETTINGS))
    sql_tables(sql_session, sql_data, batch_rows)
    runs, faults = run_sql_more(sql_session, sql_refs, kept)
    for label, run in runs.items():
        keep(run[0], label, run[1])
    del runs
    if faults:
        raise AssertionError("; ".join(faults))
    print(f"SQL phase: the fifteen other texts == numpy; nested-loop joins "
          f"in {', '.join(q.upper() for q in SQL_NESTED_LOOP)}", flush=True)
    del sql_session
    torch.cuda.empty_cache()
    # the exchange phase: the same views with the exchanges split
    collapsed_ms = {
        name: sql_paths[f"SQL {name.upper()} host-driven"]["collect2"]
        ["wall_s"] * 1e3 for name in SPLIT_TEXTS
        if f"SQL {name.upper()} host-driven" in sql_paths}
    t0 = time.monotonic()
    exchange = exchange_phase(sql_data, dict(sql_refs, q3=q3_ref), kept,
                              collapsed_ms)
    print(f"exchange phase: {len(exchange['runs'])} paths == numpy or the "
          f"host engine's rows, {exchange['pieces']} split pieces and "
          f"every other gatherScatter, stringHash and contains call == its "
          f"plain version, in {time.monotonic() - t0:.1f} s", flush=True)
    # the fallback phase: operators on the host by the planner's tags
    t0 = time.monotonic()
    fallback = fallback_phase(sql_data, sql_refs, q1_names, q1_ref, p_df,
                              part_names, part_ref, batch_rows)
    print(f"fallback phase: {len(fallback)} paths in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    del q3_data, sql_data
    small = {"customer": datagen.gen_customer(Q5_FUSED_SF),
             "orders": datagen.gen_orders(Q5_FUSED_SF),
             "lineitem": datagen.gen_lineitem(Q5_FUSED_SF),
             "supplier": datagen.gen_supplier(Q5_FUSED_SF),
             "nation": datagen.gen_nation(), "region": datagen.gen_region()}
    small_ref = sql_references(small)["q5"]
    sql_session = GpuSparkSession(RapidsConf(dict(
        SQL_SETTINGS, **Q3_MODES["mesh-fused"])))
    sql_tables(sql_session, small, batch_rows)
    label = f"SQL Q5 mesh-fused (sf {Q5_FUSED_SF})"
    rec = run_sql(sql_session, "q5",
                  lambda rows: check_sql_rows(rows, small_ref, label), label)
    metrics = dict(sql_session.last_metrics)
    print(f"{label}: plan\n{sql_session.last_physical_plan.tree_string()}"
          f"metrics {metrics}", flush=True)
    # one lineitem batch at this size: no concat, so no gatherScatter
    _require(rec["path"], label, ("stringHash", "joinProbe"))
    if metrics.get("meshJoinsFused", 0) == 0:
        raise AssertionError(f"{label}: no join ran fused")
    keep(rec, label, metrics)
    time_probes(rec, label, [f"join {i + 1}"
                             for i in range(len(rec["probes"]))])
    del sql_session, small, rec
    cases = check_cast_edges(device)
    print(f"cast phase: {cases} casts from DOUBLE and FLOAT to the "
          "integral types on the card == Java's rules == the CPU's",
          flush=True)

    # ---- main paths over parquet files: the scan lane --------------------
    t0 = time.monotonic()
    scan_data = headline_data(SCAN_ROWS)
    scan_ref = scan_reference(scan_data)
    scan_dir = write_tables({"store_sales": scan_data},
                            scan_tmp.name)["store_sales"]
    import pyarrow.parquet as pq
    groups = pq.ParquetFile(os.path.join(
        scan_dir, "part-0.parquet")).metadata.num_row_groups
    print(f"scan table: {SCAN_ROWS} rows in {groups} row groups, written "
          f"in {time.monotonic() - t0:.1f} s", flush=True)
    if groups != 4:
        raise AssertionError(f"the scan table has {groups} row groups, "
                             "not 4")
    del scan_data
    scan_paths, scan_rows = {}, {}
    for mode, extra in SCAN_MODES.items():
        scan_session = GpuSparkSession(RapidsConf(dict(SETTINGS, **extra)))
        label = f"scan query, {mode}"

        def check_scan(rows, label=label, mode=mode):
            check_scan_rows(rows, scan_ref, label)
            scan_rows[mode] = sorted(rows)

        path = run_path(scan_session.read.parquet(scan_dir), scan_query,
                        check_scan, label)
        metrics = dict(scan_session.last_metrics)
        print(f"{label}: plan\n"
              f"{scan_session.last_physical_plan.tree_string()}metrics "
              f"{metrics}, per operator {scan_session.last_op_metrics}",
              flush=True)
        for i in (1, 2):
            n = path[f"collect{i}"]["launches"]["gatherScatter"]
            if n != 1:
                raise AssertionError(f"{label} collect {i} launched "
                                     f"gatherScatter {n} times, not once")
        if (metrics.get("rowGroupsRead"), metrics.get("rowGroupsTotal")) \
                != (4, 4):
            raise AssertionError(f"{label}: row groups {metrics}")
        scan_paths[label] = path
        sql_metrics[label] = metrics
        del scan_session
    first = next(iter(SCAN_MODES))
    for mode, rows in scan_rows.items():
        check_same_rows(rows, scan_rows[first], f"scan query, {mode} vs "
                        f"{first}")
    print(f"scan query: the {len(SCAN_MODES)} ways give the same "
          f"{len(scan_rows[first])} rows", flush=True)

    # SQL Q1, Q6 and Q3 over parquet views at TPC-H SF1's counts
    pq_session = GpuSparkSession(RapidsConf(SQL_SETTINGS))
    parquet_views(pq_session, pq_dirs)

    def check_pq(name, label):
        def check(rows):
            if name == "q1":
                check_string_rows(rows, q1_names, q1_ref, label)
                check_same_rows(rows, kept["sql q1 host-driven"],
                                f"{label} vs cached SQL Q1")
            elif name == "q3":
                check_q3_rows(rows, q3_ref, label)
                check_same_rows(rows, kept["sql q3 host-driven"],
                                f"{label} vs cached SQL Q3")
            else:
                check_sql_rows(rows, sql_refs[name], label)
        return check

    for name in ("q1", "q6", "q3"):
        label = f"SQL {name.upper()} over parquet"
        rec = run_sql(pq_session, name, check_pq(name, label), label)
        path = rec["path"]
        metrics = dict(pq_session.last_metrics)
        print(f"{label}: plan\n"
              f"{pq_session.last_physical_plan.tree_string()}metrics "
              f"{metrics}, joins {join_strategies(pq_session)}", flush=True)
        _require(path, label, SQL_KERNELS[name])
        for i in (1, 2):
            launches = path[f"collect{i}"]["launches"]
            if launches["joinProbe"]:
                raise AssertionError(f"{label} launched joinProbe")
            if name == "q1" and (launches["stringHash"],
                                 launches["gatherScatter"]) != (8, 1):
                raise AssertionError(
                    f"{label} collect {i}: stringHash "
                    f"{launches['stringHash']} and gatherScatter "
                    f"{launches['gatherScatter']} launches, not 8 and 1 as "
                    "the cached Q1")
        keep(rec, label, metrics)
        del rec
    del pq_session
    scan_tmp.cleanup()
    torch.cuda.empty_cache()

    # ---- main paths: the TPC-DS texts through session.sql ----------------
    t0 = time.monotonic()
    tpcds = tpcds_phase()
    print(f"TPC-DS phase: {len(tpcds)} texts == the host engine's rows, "
          f"every stringHash and gatherScatter call == its plain version, "
          f"in {time.monotonic() - t0:.1f} s", flush=True)

    # ---- main paths: the mortgage ETL and TPCxBB lanes -------------------
    t0 = time.monotonic()
    lanes = lanes_phase()
    print(f"lanes phase: {len(lanes)} paths == numpy or the host engine's "
          f"rows, every stringHash and gatherScatter call == its plain "
          f"version, in {time.monotonic() - t0:.1f} s", flush=True)

    # ---- main paths: the expression layer on an ETL path ----------------
    t0 = time.monotonic()
    etl = etl_phase()
    print(f"ETL phase: {len(etl)} paths == numpy, planned wholly on the "
          f"GPU, every stringHash, contains and gatherScatter call == its "
          f"plain version, in {time.monotonic() - t0:.1f} s", flush=True)

    # ---- main paths: the spill catalog, the OOM retry, the fault ladder --
    memory = memory_phase(card)
    print(f"memory phase: SF{MEMORY_SF} Q1 and Q18 out of core, the split "
          f"Q18's pieces spilled and read back, a real OOM retried, "
          f"{len(FAULT_SPECS)} injected specs recovered, the sticky CUDA "
          f"error completed on the host, in {memory['wall_s']:.1f} s; "
          f"{_GUARD['collects']} collects of the other phases with every "
          f"fault counter at 0", flush=True)

    # ---- string kernels: matrix and timings at the main paths' shapes ----
    p_type = cached_column(p_df, "p_type")
    p_brand = cached_column(p_df, "p_brand")
    p_name = cached_column(p_df, "p_name")
    flag = cached_column(li_df, "l_returnflag")
    status = cached_column(li_df, "l_linestatus")
    cases = check_string_matrix(device, [
        ("p_type batch", p_type), ("p_name batch", p_name),
        ("l_returnflag batch", flag), ("c_mktsegment batch", segment)])
    print(f"kernel phase: stringHash and contains == plain versions over "
          f"{cases} cases", flush=True)
    # stringHash at each launch shape of the paths: Q1's two keys and the
    # part query's two keys in one launch, Q3's c_mktsegment alone; and
    # one column of l_returnflag and of p_type, as the earlier design ran
    hash_q1 = hash_numbers([flag, status],
                           "Q1's keys l_returnflag and l_linestatus")
    hash_part = hash_numbers([p_brand, p_type],
                             "the part query's keys p_brand and p_type")
    hash_q3 = hash_numbers([segment], "Q3's c_mktsegment (customer batch)")
    hash_flag = hash_numbers([flag], "l_returnflag batch")
    hash_type = hash_numbers([p_type], "p_type batch")
    contains_main = contains_numbers(*p_name, b"green", "p_name batch")
    h_err = max(hash_q1["max_abs_err"], hash_part["max_abs_err"],
                sql_hash_err, max(r["hash_err"] for r in tpcds.values()),
                max(r["hash_err"] for r in lanes.values()),
                max(r["hash_err"] for r in etl.values()))
    c_err = int((cuda_tier.rows_with_match(*p_name, b"green") !=
                 cuda_tier.rows_with_match_reference(*p_name, b"green"))
                .sum())
    for label, nums in (("stringHash Q1's two keys", hash_q1),
                        ("stringHash the part query's two keys", hash_part),
                        ("stringHash Q3's c_mktsegment", hash_q3),
                        ("stringHash l_returnflag", hash_flag),
                        ("stringHash p_type", hash_type),
                        ("contains p_name", contains_main)):
        print(f"{label}: {json.dumps(nums)}", flush=True)

    # ---- joinProbe at Q3's two join shapes -------------------------------
    probe_err = sql_probe_err
    probe_shapes = []
    for label, (args, pair_cap) in zip(
            ("Q3 customer x orders", "Q3 (customer x orders) x lineitem"),
            ((c[:-1], c[-1]) for c in probe_calls)):
        probe_err = max(probe_err, check_probe(args, pair_cap, label))
        nums = probe_numbers(args, pair_cap, label)
        print(f"joinProbe {label}: {json.dumps(nums)}", flush=True)
        probe_shapes.append(nums)
    del probe_calls

    paths = {"headline": multi["collect2"]["launches"],
             "Q1": q1["collect2"]["launches"],
             "part": part_path["collect2"]["launches"],
             "Q3 host-driven": q3_paths["host-driven"]["collect2"]["launches"],
             "Q3 mesh-fused": q3_paths["mesh-fused"]["collect2"]["launches"],
             "Q3 broadcast mesh-fused": bc_path["collect2"]["launches"]}
    paths.update({label: p["collect2"]["launches"]
                  for label, p in sql_paths.items()})
    paths.update({label: p["collect2"]["launches"]
                  for label, p in scan_paths.items()})
    paths.update({f"fallback ({k})": f["path"]["collect2"]["launches"]
                  for k, f in fallback.items()})
    paths.update({label: r["path"]["collect2"]["launches"]
                  for label, r in tpcds.items()})
    paths.update({label: r["path"]["collect2"]["launches"]
                  for label, r in lanes.items()})
    paths.update({label: r["path"]["collect2"]["launches"]
                  for label, r in etl.items()})
    paths.update({label: r["path"]["collect2"]["launches"]
                  for label, r in exchange["runs"].items()})
    paths.update({label: r["path"]["collect2"]["launches"]
                  for label, r in memory["steps"].items() if "path" in r})
    print(f"test mode: {len(ON_GPU_CHECKED)} earlier paths plan wholly on "
          f"the GPU with spark.rapids.sql.test.enabled", flush=True)

    def by_path(name):
        return {p: launches[name] for p, launches in paths.items()}

    def entry(name, nums, err, launches, **extra):
        return dict({
            "name": name, "route": "cuda",
            "source": ("spark_rapids_tpu_torch/csrc/" +
                       cuda_tier.SOURCES[name]),
            "replaces": REPLACES[name], "launches": launches,
            "launches_by_path": by_path(name), "max_abs_err": float(err),
            "ms": nums["ms"], "kernel_only_ms": nums["kernel_only_ms"],
            "plain_ms": nums["plain_ms"], "bound_ms": nums["bound_ms"],
            "bound_by": "bytes", "library_ms": nums["library_ms"],
            "shape": nums["shape"]}, **extra)

    kernels = [
        entry("gatherScatter", main_shape, max_err,
              paths["headline"]["gatherScatter"], bandwidth=bandwidth,
              strings=strings_shape, split_piece=exchange["piece"]),
        entry("stringHash", hash_q1, h_err,
              sum(launches["stringHash"] for launches in paths.values()),
              part_keys=hash_part, q3_segment=hash_q3,
              l_returnflag=hash_flag, p_type=hash_type, **sql_hash),
        entry("strings", contains_main, c_err,
              paths["part"]["strings"]),
        entry("joinProbe", probe_shapes[1], probe_err,
              paths["Q3 mesh-fused"]["joinProbe"],
              first_join=probe_shapes[0], large=probe_large,
              sql=sql_probe),
    ]
    summary = {"main_path": {"multi_batch": multi, "one_batch": single,
                             "q1": q1, "part": part_path, "q3": q3_paths,
                             "q3_broadcast_mesh_fused": bc_path,
                             "sql": sql_paths, "scan": scan_paths,
                             "fallback": fallback,
                             "tpcds": {label: {"path": r["path"],
                                               "host_ms": r["host_ms"]}
                                       for label, r in tpcds.items()},
                             "lanes": {label: {
                                 "path": r["path"],
                                 "peak_bytes": r["peak_bytes"],
                                 "host_ms": r.get("host_ms")}
                                 for label, r in lanes.items()},
                             "etl": {label: {
                                 "path": r["path"],
                                 "peak_bytes": r["peak_bytes"]}
                                 for label, r in etl.items()},
                             "exchange": {
                                 "paths": {label: r["path"] for label, r
                                           in exchange["runs"].items()},
                                 "methods": exchange["methods"],
                                 "wall_s": exchange["wall_s"],
                                 "peak_bytes": exchange["peak_bytes"]},
                             "memory": memory},
               "test_mode_paths": ON_GPU_CHECKED,
               "q3_overflow_reruns": q3_fallbacks,
               "sql_metrics": sql_metrics, "card": card}
    print(f"summary: {json.dumps(summary)}", flush=True)
    print(f"wall: {time.monotonic() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        stop_memory_data()
    sys.exit(rc)
