#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spark_rapids_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every hand-written kernel from ``spark_rapids_tpu_torch/csrc`` with
   nvcc (into ``build/kernels``);
3. kernel phase: every kernel against its plain PyTorch version on the card
   (``torch.equal`` on the raw output) over a case matrix, then timed with
   CUDA events (median of 30 after warm-up): the wrapper call as the main
   path makes it, and the kernel alone replayed from a CUDA graph;
4. main path: bench.py's headline query (filter, project, group by two keys
   with sum/count/avg/min/max, order by) over 16,777,216 rows cached as 16
   batches of ``reader.batchSizeRows`` rows, collected twice, checked
   against an independent numpy group-by; then the one-batch cached form
   bench.py itself runs.  The launch counts are zeroed just before each
   collect and read just after: the multi-batch query must launch every
   kernel of its path.

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
REPLACES = "spark_rapids_tpu/kernels/pallas_tier.py:232"
SOURCE = "spark_rapids_tpu_torch/csrc/pack_segments.cu"
SETTINGS = {"spark.rapids.sql.variableFloatAgg.enabled": True,
            "spark.sql.shuffle.partitions": 1}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
    for k in (1, 2, 16, 200):  # 200 > one launch's inputs: grouped packs
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

    # the kernel alone, without the wrapper's host work: one captured
    # launch replayed from a CUDA graph
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cuda_tier.pack_segments(arrays, lo_t, hi_t, out_cap)
    return {
        "ms": time_ms(lambda: cuda_tier.pack_segments(arrays, lo_t, hi_t,
                                                      out_cap)),
        "kernel_only_ms": time_ms(graph.replay),
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch.batch import HostBatch
    from spark_rapids_tpu_torch.config import (
        READER_BATCH_SIZE_ROWS, RapidsConf,
    )
    from spark_rapids_tpu_torch.dataframe import DataFrame
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

    cases = check_pack_matrix(device)
    print(f"kernel phase: gatherScatter == plain version over {cases} "
          "cases", flush=True)

    # ---- main path -------------------------------------------------------
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
    launches = multi["collect2"]["launches"]
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"main path never launched {name}")

    # the kernel at the main path's own shapes: the merge's partials
    partials = merge_partials(session, device)
    ns = [int(p.num_rows) for p in partials]
    out_cap = max(8, 1 << (sum(ns) - 1).bit_length())
    max_err = 0.0
    for ci in range(len(partials[0].columns)):
        for buf in ("data", "validity"):
            arrays = [getattr(p.columns[ci], buf) for p in partials]
            got = cuda_tier.pack_segments(arrays, [0] * len(ns), ns, out_cap)
            want = cuda_tier.pack_segments_reference(arrays, [0] * len(ns),
                                                     ns, out_cap)
            if not torch.equal(got, want):
                raise AssertionError(f"gatherScatter != plain version on "
                                     f"merge column {ci} {buf}")
            if got.is_floating_point():
                max_err = max(max_err, float((got - want).abs().max()))
    sum_col = partials[0].schema.index_of("__buf_0_0")  # f64 sum_rev
    main_shape = _pack_numbers([p.columns[sum_col].data for p in partials],
                               [0] * len(ns), ns, out_cap, device)
    main_shape["shape"] = (f"{len(ns)} partials of capacity "
                           f"{partials[0].capacity}, {sum(ns)} live f64 "
                           f"rows -> out_cap {out_cap}")
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

    kernels = [{
        "name": "gatherScatter", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches["gatherScatter"],
        "max_abs_err": max_err, "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": "bytes",
        "library_ms": main_shape["library_ms"],
        "shape": main_shape["shape"], "bandwidth": bandwidth,
    }]
    summary = {"main_path": {"multi_batch": multi, "one_batch": single},
               "card": card}
    print(f"summary: {json.dumps(summary)}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
