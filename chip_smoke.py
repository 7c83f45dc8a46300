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
   tails, k = 200 with six string columns (grouped packs);
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
   each query must launch every kernel of its path;
5. timings at the main paths' own shapes (gatherScatter: the headline
   merge's concat of its partials, every buffer, and a concat of the cached
   lineitem batches with its string columns; stringHash: Q1's two keys
   and the part query's two keys in one launch each and Q3's c_mktsegment,
   each first held equal to its plain version, then an l_returnflag batch
   and a p_type batch alone; contains: a p_name batch; for both, each
   launch's device time by ``torch.profiler`` with its inputs in L2 and
   with L2 flushed; joinProbe: the inputs Q3's two joins
   handed it, and each of its launches by ``torch.profiler``),
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
import subprocess
import sys
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


def check_columns(columns, ns, out_cap, byte_caps, label) -> None:
    """The multi-buffer pack against its plain version: every buffer
    equal bit for bit (torch.equal of the bytes), zero tails and rebuilt
    offsets included."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_tier
    got = cuda_tier.pack_columns(columns, ns, out_cap, byte_caps)
    want = cuda_tier.pack_columns_reference(columns, ns, out_cap, byte_caps)
    torch.cuda.synchronize()
    for ci, (g, w) in enumerate(zip(got, want)):  # bit for bit
        for name, gb, wb in zip(("data", "validity", "offsets"), g, w):
            if (gb is None) != (wb is None) or (
                    gb is not None and (gb.dtype != wb.dtype or not
                                        torch.equal(gb.view(torch.uint8),
                                                    wb.view(torch.uint8)))):
                raise AssertionError(f"gatherScatter (all buffers) != plain "
                                     f"version: {label} column {ci} {name}")


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
    the mean over ``reps`` calls under ``torch.profiler``.  With ``cold``
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
    raise RuntimeError("torch.profiler recorded no device time in 3 tries")


def string_kernel_numbers(call, plain, nbytes: int) -> dict:
    """``kernel_numbers`` and the launch's device ms by ``torch.profiler``
    with the inputs in L2 (back to back) and with L2 flushed."""
    out = kernel_numbers(call, plain, nbytes)
    out["device_ms"] = sum(launch_ms(call).values())
    out["device_cold_ms"] = sum(launch_ms(call, cold=True).values())
    return out


def hash_numbers(columns, label: str) -> dict:
    """stringHash at a main-path shape: every (data, offsets) column of
    ``columns`` in one string_hash_columns call, as a sort makes it, its
    outputs first held equal (torch.equal) to the per-column plain
    versions.  Bytes: per column the live bytes and the cap+1 offsets read
    once, the function's two u32 hashes per row written once (8 bytes);
    ``bound_ms_int64_words`` counts the 16 bytes a row of the two int64
    words the port writes."""
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
        err = max(err, int((g[0] - w[0]).abs().max()),
                  int((g[1] - w[1]).abs().max()))
    del got, want
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


def run_path(df, query, check, label: str) -> dict:
    """Two collects of one query, launch counts zeroed just before each
    and read just after; rows checked after each."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_tier
    out = {}
    for i in range(2):
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
    return out


def _require(path: dict, label: str, names) -> None:
    for i in (1, 2):
        launches = path[f"collect{i}"]["launches"]
        for name in names:
            if launches[name] == 0:
                raise AssertionError(f"{label} collect {i} never launched "
                                     f"{name}")


def cached_column(df, name: str):
    """(data, offsets) of a string column of the first cached batch."""
    batch = df.plan.holder.partitions[0][0]
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


class ProbeRecorder:
    """Wraps ``cuda_tier.probe_join`` while installed, keeping the inputs
    of each call (the main path's own shapes for the timings); the calls
    go through to the kernel unchanged."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from spark_rapids_tpu_torch.kernels import cuda_tier
        self._real = cuda_tier.probe_join

        def record(*args):
            self.calls.append(args)
            return self._real(*args)

        cuda_tier.probe_join = record
        return self

    def __exit__(self, *exc):
        from spark_rapids_tpu_torch.kernels import cuda_tier
        cuda_tier.probe_join = self._real
        return False


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

    card = card_line()
    device = torch.device("cuda", 0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.monotonic()
    built = cuda_tier.build_all()
    print(f"build: {time.monotonic() - t0:.1f} s {built}", flush=True)
    for name in cuda_tier.SOURCES:  # every library built and loadable
        cuda_tier.load(name)

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
    q1 = run_path(li_df, q1_query, lambda rows: check_string_rows(
        rows, q1_names, q1_ref, "Q1"), "Q1")
    _require(q1, "Q1", ["gatherScatter", "stringHash"])
    # gatherScatter over string buffers: a concat of the cached lineitem
    # batches, every column (the string ones among them)
    li_args = batch_columns(li_df.plan.holder.partitions[0])
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

        with ProbeRecorder() as recorder:
            q3_paths[mode] = run_path(tables, q3_query, check, f"Q3 {mode}")
        q3_fallbacks[mode] = q3_session.last_metrics.get(
            "joinOverflowFallback", 0)
        print(f"Q3 {mode}: plan\n{q3_session.last_physical_plan.tree_string()}"
              f"metrics {q3_session.last_metrics}; overflow rerun "
              f"{'fired' if q3_fallbacks[mode] else 'did not fire'}",
              flush=True)
        if mode == "mesh-fused":
            probe_calls = recorder.calls[-2:]  # the second collect's joins
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
    del q3_data

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
    h_err = max(hash_q1["max_abs_err"], hash_part["max_abs_err"])
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
    probe_err = 0
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
              strings=strings_shape),
        entry("stringHash", hash_q1, h_err,
              sum(paths[p]["stringHash"] for p in (
                  "Q1", "part", "Q3 host-driven", "Q3 mesh-fused",
                  "Q3 broadcast mesh-fused")),
              part_keys=hash_part, q3_segment=hash_q3,
              l_returnflag=hash_flag, p_type=hash_type),
        entry("strings", contains_main, c_err,
              paths["part"]["strings"]),
        entry("joinProbe", probe_shapes[1], probe_err,
              paths["Q3 mesh-fused"]["joinProbe"],
              first_join=probe_shapes[0], large=probe_large),
    ]
    summary = {"main_path": {"multi_batch": multi, "one_batch": single,
                             "q1": q1, "part": part_path, "q3": q3_paths,
                             "q3_broadcast_mesh_fused": bc_path},
               "q3_overflow_reruns": q3_fallbacks, "card": card}
    print(f"summary: {json.dumps(summary)}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
