#!/usr/bin/env python3
"""A/B of this tree's stringHash and strings (contains) kernels against an
earlier tree's, in one process on one GPU.

    git archive <commit> | tar -x -C build/parent      # the earlier tree
    python3 ab_kernels.py --parent build/parent [--out build/ab.json]

The earlier tree's ``spark_rapids_tpu_torch/csrc/string_hash.cu`` and
``contains.cu`` are built with this tree's nvcc flags into
``build/kernels_parent`` and called through their own C interfaces
(``srt_string_hash``: one column a launch; ``srt_contains``).  This tree's
kernels go through ``cuda_tier``.  Both trees' sources are also compiled
with ``-Xptxas -v`` and the compiler's register and shared-memory report
is printed.  Inputs: the first cached batch (2^20 rows) of chip_smoke.py's
lineitem (6,000,000 rows) and part (2,000,000 rows) tables, and its
customer table (150,000 rows, one batch):

* stringHash on ``l_returnflag``, on ``p_type``, on Q1's two keys
  ``l_returnflag`` and ``l_linestatus`` and on the part query's two keys
  ``p_brand`` and ``p_type`` (two launches of the earlier kernel, one of
  this tree's), and on Q3's ``c_mktsegment``;
* contains on ``p_name`` with the needle ``green``.

The stringHash bound counts the function's two u32 hashes a row (8 bytes);
``bound_ms_int64_words`` the two int64 words a row both trees write.

For each shape the two designs' outputs must be equal (torch.equal, bit for
bit), then in turns earlier, this, this, earlier: the launches alone per
call (20 calls captured in one CUDA graph; median of CUDA-event timings,
ms) and their device time by ``torch.profiler``, with the inputs in L2 and
with L2 flushed before each call; this tree's wrapper call too.
Last, the host cost of the string wrappers' steps (microseconds a call,
``time.perf_counter`` over many calls).  Prints one JSON line with the
card's name and power limit; needs a CUDA device.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

SOURCES = ("string_hash", "contains")


def build(tree: Path, out_dir: Path) -> tuple:
    """The tree's two string kernel libraries built with ``-Xptxas -v``
    (one nvcc each, started together); returns (paths, ptxas report)."""
    from spark_rapids_tpu_torch.kernels import cuda_tier
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        src = tree / "spark_rapids_tpu_torch" / "csrc" / f"{name}.cu"
        lib = out_dir / f"lib_{name}.so"
        procs[name] = (subprocess.Popen(
            [cuda_tier._nvcc(), *cuda_tier.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    paths, report = {}, {}
    for name, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {tree}'s {name}.cu:\n{text}")
        paths[name] = lib
        report[name] = [line.strip() for line in text.splitlines()
                        if "registers" in line or "Compiling entry" in line
                        or "spill" in line]
    return paths, report


def load_parent(paths: dict) -> dict:
    libs = {name: ctypes.CDLL(str(p)) for name, p in paths.items()}
    h = libs["string_hash"].srt_string_hash
    h.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                  ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
                  ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p]
    h.restype = ctypes.c_int
    c = libs["contains"].srt_contains
    c.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                  ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p]
    c.restype = ctypes.c_int
    return libs


def _stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def parent_hash(lib, columns) -> list:
    """The earlier stringHash: one launch per column."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_tier
    out = []
    for data, offsets in columns:
        cap = int(offsets.numel()) - 1
        h1 = torch.empty(cap, dtype=torch.int64, device=data.device)
        h2 = torch.empty(cap, dtype=torch.int64, device=data.device)
        err = lib.srt_string_hash(
            data.data_ptr(), data.numel(), offsets.data_ptr(), cap,
            cuda_tier.HASH_BASES[0], cuda_tier.HASH_BASES[1],
            cuda_tier.HASH_GOLDEN, h1.data_ptr(), h2.data_ptr(), _stream())
        if err:
            raise RuntimeError(f"earlier stringHash failed: CUDA error {err}")
        out.append((h1, h2))
    return out


def parent_contains(lib, data, offsets, needle_dev) -> object:
    import torch
    cap = int(offsets.numel()) - 1
    out = torch.empty(cap, dtype=torch.bool, device=data.device)
    err = lib.srt_contains(data.data_ptr(), data.numel(), offsets.data_ptr(),
                           cap, needle_dev.data_ptr(), needle_dev.numel(),
                           out.data_ptr(), _stream())
    if err:
        raise RuntimeError(f"earlier contains failed: CUDA error {err}")
    return out


def flat(outputs):
    if isinstance(outputs, (list, tuple)):
        return [t for o in outputs for t in flat(o)]
    return [outputs]


def compare(label, earlier, this) -> None:
    """The two designs' outputs equal bit for bit, dtypes and shapes too."""
    import torch
    for a, b in zip(flat(earlier), flat(this), strict=True):
        if a.dtype != b.dtype or a.shape != b.shape or \
                not torch.equal(a, b):
            raise AssertionError(f"{label}: the two designs' outputs differ")


def ab(label, earlier, this, nbytes: int) -> dict:
    """Turns earlier, this, this, earlier: the launches alone per call
    (``chip_smoke.graph_ms``) and their device ms by ``torch.profiler``
    with the inputs in L2 and with L2 flushed; this tree's wrapper call;
    the bytes bound."""
    import chip_smoke as C
    compare(label, earlier(), this())
    turns = {"earlier": [], "this": []}
    for who in ("earlier", "this", "this", "earlier"):
        call = earlier if who == "earlier" else this
        turns[who].append({
            "ms": C.graph_ms(call),
            "device_ms": sum(C.launch_ms(call, reps=10).values()),
            "device_cold_ms": sum(C.launch_ms(call, reps=10,
                                              cold=True).values())})
    out = {"shape": label, "bytes": nbytes,
           "bound_ms": nbytes / C.HBM_BYTES_PER_S * 1e3,
           "earlier": turns["earlier"], "this": turns["this"],
           "this_wrapper_ms": C.time_ms(this),
           "earlier_launch_ms": C.launch_ms(earlier, reps=10),
           "this_launch_ms": C.launch_ms(this, reps=10)}
    print(f"{label}: {json.dumps(out)}", flush=True)
    return out


def host_us(fn, n: int = 500) -> float:
    """Host microseconds of one ``fn()`` (mean over ``n``, after a sync)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / n * 1e6


def wrapper_costs(flag, p_name) -> dict:
    """Host microseconds of each step the string wrappers take."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_tier
    data, offsets = p_name
    device = data.device
    cap = int(offsets.numel()) - 1
    by_device = {(b"green", device): 1}
    by_index = {(b"green", device.index): 1}
    lib = cuda_tier.load("strings")
    needle = cuda_tier._device_needle(b"green", device)
    out = torch.empty(cap, dtype=torch.bool, device=device)
    stream = torch.cuda.current_stream().cuda_stream
    return {
        "current_stream().cuda_stream": host_us(
            lambda: torch.cuda.current_stream(device).cuda_stream),
        "_cuda_getCurrentRawStream": host_us(
            lambda: torch._C._cuda_getCurrentRawStream(device.index)),
        "current_device()": host_us(torch.cuda.current_device),
        "empty(cap, bool)": host_us(
            lambda: torch.empty(cap, dtype=torch.bool, device=device)),
        "empty(2 cap, int64)": host_us(
            lambda: torch.empty(2 * cap, dtype=torch.int64, device=device)),
        "needle lookup by torch.device": host_us(
            lambda: by_device.get((b"green", device))),
        "needle lookup by index": host_us(
            lambda: by_index.get((b"green", device.index))),
        "_check_string_column": host_us(
            lambda: cuda_tier._check_string_column("f", data, offsets,
                                                   device)),
        "ctypes srt_contains alone": host_us(
            lambda: lib.srt_contains(
                data.data_ptr(), data.shape[0], offsets.data_ptr(), cap,
                needle.data_ptr(), 5, out.data_ptr(), stream)),
        "rows_with_match": host_us(
            lambda: cuda_tier.rows_with_match(data, offsets, b"green")),
        "string_hash_rows": host_us(
            lambda: cuda_tier.string_hash_rows(*flag)),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path,
                    help="an earlier tree (holding spark_rapids_tpu_torch/"
                         "csrc)")
    ap.add_argument("--out", default="build/ab.json")
    args = ap.parse_args()

    import chip_smoke as C
    from spark_rapids_tpu_torch.batch import host_to_device
    from spark_rapids_tpu_torch.benchmarks import datagen
    from spark_rapids_tpu_torch.config import READER_BATCH_SIZE_ROWS
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.interop import host_batches
    from spark_rapids_tpu_torch.kernels import cuda_tier

    cuda_tier.build_all()
    build_dir = cuda_tier.BUILD_DIR.parent
    parent_paths, parent_ptxas = build(args.parent,
                                       build_dir / "kernels_parent")
    _, this_ptxas = build(Path(__file__).resolve().parent,
                          build_dir / "kernels_ptxas")
    libs = load_parent(parent_paths)
    device = torch.device("cuda", 0)
    results = {"card": C.card_line(),
               "ptxas": {"earlier": parent_ptxas, "this": this_ptxas},
               "stringHash": [], "strings": []}
    print(f"ptxas: {json.dumps(results['ptxas'])}", flush=True)

    rows = READER_BATCH_SIZE_ROWS.get(RapidsConf(C.SETTINGS))

    def first_batch(data):
        head = {k: (t, v[:rows]) for k, (t, v) in data.items()}
        return host_to_device(host_batches(head, rows)[0], device)

    lineitem = first_batch(datagen.gen_lineitem(C.LINEITEM_SF))
    part = first_batch(datagen.gen_part(C.PART_SF))
    customer = first_batch(datagen.gen_customer(C.Q3_SF))

    def column(batch, name):
        col = batch.column(name)
        return col.data, col.offsets

    flag = column(lineitem, "l_returnflag")
    status = column(lineitem, "l_linestatus")
    p_type = column(part, "p_type")
    p_brand = column(part, "p_brand")
    p_name = column(part, "p_name")
    segment = column(customer, "c_mktsegment")

    def hash_bytes(cols, word_bytes):
        return sum(int(o[-1]) + 4 * o.numel() + word_bytes * (o.numel() - 1)
                   for _, o in cols)

    for label, cols in (("l_returnflag batch", [flag]),
                        ("p_type batch", [p_type]),
                        ("Q1's keys l_returnflag and l_linestatus",
                         [flag, status]),
                        ("the part query's keys p_brand and p_type",
                         [p_brand, p_type]),
                        ("Q3's c_mktsegment (customer batch)", [segment])):
        nums = ab(label, lambda c=cols: parent_hash(libs["string_hash"], c),
                  lambda c=cols: cuda_tier.string_hash_columns(c),
                  hash_bytes(cols, 8))
        nums["bytes_int64_words"] = hash_bytes(cols, 16)
        nums["bound_ms_int64_words"] = (nums["bytes_int64_words"] /
                                        C.HBM_BYTES_PER_S * 1e3)
        results["stringHash"].append(nums)

    needle = cuda_tier._device_needle(b"green", device)
    data, offsets = p_name
    results["strings"].append(ab(
        "p_name batch, needle 'green'",
        lambda: parent_contains(libs["contains"], data, offsets, needle),
        lambda: cuda_tier.rows_with_match(data, offsets, b"green"),
        int(offsets[-1]) + 4 * offsets.numel() + 5 + offsets.numel() - 1))

    results["wrapper_us"] = wrapper_costs(flag, p_name)
    print(f"wrapper host us: {json.dumps(results['wrapper_us'])}",
          flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
