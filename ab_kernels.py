#!/usr/bin/env python3
"""A/B of this tree's gatherScatter and joinProbe kernels against an earlier
tree's, in one process on one GPU.

    git archive <commit> | tar -x -C build/parent      # the earlier tree
    python3 ab_kernels.py --parent build/parent [--out build/ab.json]

The earlier tree's ``spark_rapids_tpu_torch/csrc/pack_segments.cu`` and
``probe_join.cu`` are built with this tree's nvcc flags into
``build/kernels_parent`` and called through their own C interface, the one
of the four-launch joinProbe and the one-buffer gatherScatter (a concat was
one launch per buffer, plus torch ops that rebuilt string offsets from the
packed lengths).  This tree's kernels go through ``cuda_tier``.  Inputs:

* joinProbe: the two joins of TPC-H Q3 fused on a one-device mesh at SF1's
  row counts (recorded from one collect, as chip_smoke.py does), and
  chip_smoke.py's 2^20 probe rows against 2^22 build rows;
* gatherScatter: the headline merge's concat of its 16 partials (every
  buffer) and a concat of lineitem's six cached batches at 6,000,000 rows.

For each shape the two designs' outputs must be equal (torch.equal, bit for
bit), then in turns earlier, this, this, earlier: the launches alone replayed
from a CUDA graph (median of CUDA-event timings, ms) and each launch's device
time by ``torch.profiler``.  Prints one JSON line with the card's name and
power limit; needs a CUDA device.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path


def build_parent(parent: Path) -> dict:
    """The earlier tree's two kernel libraries, built and loaded."""
    from spark_rapids_tpu_torch.kernels import cuda_tier
    out_dir = cuda_tier.BUILD_DIR.parent / "kernels_parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    procs = {}
    for name in ("pack_segments", "probe_join"):
        src = parent / "spark_rapids_tpu_torch" / "csrc" / f"{name}.cu"
        lib = out_dir / f"lib_{name}.so"
        procs[name] = (subprocess.Popen(
            [cuda_tier._nvcc(), *cuda_tier.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib)
    for name, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the earlier {name}.cu:\n"
                               f"{text}")
        libs[name] = ctypes.CDLL(str(lib))
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    pack = libs["pack_segments"]
    pack.srt_pack_segments.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ptrs,
        ctypes.POINTER(ctypes.c_longlong), ptrs, ptrs, ctypes.c_int,
        ctypes.c_void_p]
    pack.srt_pack_segments.restype = ctypes.c_int
    pack.srt_max_inputs.restype = ctypes.c_int
    probe = libs["probe_join"]
    probe.srt_probe_join.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] +
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] +
        [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong] +
        [ctypes.c_void_p] * 9)
    probe.srt_probe_join.restype = ctypes.c_int
    return libs


def _stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def parent_probe(lib, args, pair_cap: int):
    """The earlier joinProbe: four launches, scratch allocated here."""
    import torch
    l_h1, l_mask, r_sorted, perm, a_words, a_valid, b_words, b_valid = args
    dev = l_h1.device
    l_cap, r_cap = int(l_h1.numel()), int(r_sorted.numel())
    n_tiles = -(-l_cap // 1024)
    lo = torch.empty(l_cap, dtype=torch.int32, device=dev)
    cum = torch.empty(l_cap, dtype=torch.int32, device=dev)
    tile_sums = torch.empty(n_tiles, dtype=torch.int64, device=dev)
    tile_offsets = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    probe_row = torch.empty(pair_cap, dtype=torch.int32, device=dev)
    build_row = torch.empty(pair_cap, dtype=torch.int32, device=dev)
    match = torch.empty(pair_cap, dtype=torch.bool, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    err = lib.srt_probe_join(
        l_h1.data_ptr(), l_mask.data_ptr(), l_cap, r_sorted.data_ptr(),
        perm.data_ptr(), r_cap, a_words.data_ptr(), a_valid.data_ptr(),
        b_words.data_ptr(), b_valid.data_ptr(), int(a_words.shape[0]),
        pair_cap, lo.data_ptr(), cum.data_ptr(), tile_sums.data_ptr(),
        tile_offsets.data_ptr(), probe_row.data_ptr(), build_row.data_ptr(),
        match.data_ptr(), total.data_ptr(), _stream())
    if err:
        raise RuntimeError(f"earlier joinProbe failed: CUDA error {err}")
    return probe_row, build_row, match, total


def _parent_pack_one(lib, arrays, his, out_cap, dtype):
    """One earlier gatherScatter launch: windows [0, his[j]) (device int32
    scalars), k <= the earlier limit."""
    import torch
    out = torch.empty(out_cap, dtype=dtype, device=arrays[0].device)
    k = len(arrays)
    void_k = ctypes.c_void_p * k
    err = lib.srt_pack_segments(
        out.data_ptr(), out_cap, out.element_size(),
        void_k(*[a.data_ptr() for a in arrays]),
        (ctypes.c_longlong * k)(*[int(a.numel()) for a in arrays]),
        void_k(*([None] * k)), void_k(*[h.data_ptr() for h in his]), k,
        _stream())
    if err:
        raise RuntimeError(f"earlier gatherScatter failed: CUDA error {err}")
    return out


def parent_concat(lib, columns, num_rows, out_cap, byte_caps):
    """The earlier tree's concat: one launch per buffer; a string column's
    lengths are packed, cumsummed and concatenated into offsets, and its
    byte ends read by one index_select per part."""
    import torch
    out = []
    str_i = 0
    for parts in columns:
        validity = _parent_pack_one(lib, [v for _, v, _ in parts], num_rows,
                                    out_cap, torch.bool)
        if parts[0][2] is None:
            data = _parent_pack_one(lib, [d for d, _, _ in parts], num_rows,
                                    out_cap, parts[0][0].dtype)
            out.append((data, validity, None))
            continue
        offs = [o for _, _, o in parts]
        lens = _parent_pack_one(lib, [o[1:] - o[:-1] for o in offs],
                                num_rows, out_cap, torch.int32)
        offsets = torch.cat([
            torch.zeros(1, dtype=torch.int32, device=lens.device),
            torch.cumsum(lens, 0, dtype=torch.int32)])
        ends = [o.index_select(0, n.reshape(1).long()).reshape(())
                for o, n in zip(offs, num_rows)]
        data = _parent_pack_one(lib, [d for d, _, _ in parts], ends,
                                byte_caps[str_i], torch.uint8)
        str_i += 1
        out.append((data, validity, offsets))
    return out


def graph_ms(call) -> float:
    import torch
    import chip_smoke as C
    call()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call()
    return C.time_ms(graph.replay)


def compare(label, earlier, this) -> None:
    """The two designs' outputs equal bit for bit, dtypes and shapes too."""
    import torch
    for a, b in zip(earlier, this):
        if (a is None) != (b is None) or (a is not None and (
                a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                    a.reshape(-1).view(torch.uint8),
                    b.reshape(-1).view(torch.uint8)))):
            raise AssertionError(f"{label}: the two designs' outputs differ")


def ab(label, earlier, this) -> dict:
    """Turns earlier, this, this, earlier; per-launch device ms of each."""
    import chip_smoke as C
    times = {"earlier": [], "this": []}
    for who in ("earlier", "this", "this", "earlier"):
        times[who].append(graph_ms(earlier if who == "earlier" else this))
    out = {"shape": label,
           "earlier_ms": times["earlier"], "this_ms": times["this"],
           "earlier_launch_ms": C.launch_ms(earlier, reps=10),
           "this_launch_ms": C.launch_ms(this, reps=10)}
    print(f"{label}: {json.dumps(out)}", flush=True)
    return out


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
    from spark_rapids_tpu_torch.benchmarks import datagen
    from spark_rapids_tpu_torch.config import (
        READER_BATCH_SIZE_ROWS, RapidsConf,
    )
    from spark_rapids_tpu_torch.dataframe import DataFrame
    from spark_rapids_tpu_torch.interop import host_batches
    from spark_rapids_tpu_torch.kernels import cuda_tier
    from spark_rapids_tpu_torch.plan.logical import InMemoryScan
    from spark_rapids_tpu_torch.session import GpuSparkSession

    cuda_tier.build_all()
    libs = build_parent(args.parent)
    device = torch.device("cuda", 0)
    results = {"card": C.card_line(), "joinProbe": [], "gatherScatter": []}

    # ---- joinProbe: Q3's two fused joins, then 2^20 x 2^22 ---------------
    conf = RapidsConf(dict(C.SETTINGS, **C.Q3_MODES["mesh-fused"]))
    batch_rows = READER_BATCH_SIZE_ROWS.get(conf)
    session = GpuSparkSession(conf)
    tables = C.q3_tables(session, {
        "customer": datagen.gen_customer(C.Q3_SF),
        "orders": datagen.gen_orders(C.Q3_SF),
        "lineitem": datagen.gen_lineitem(C.Q3_SF)}, batch_rows)
    with C.ProbeRecorder() as recorder:
        C.q3_query(tables).collect()
    shapes = [("Q3 customer x orders", *recorder.calls[-2]),
              ("Q3 (customer x orders) x lineitem", *recorder.calls[-1])]
    lineitem_batches = tables["lineitem"].plan.holder.partitions[0]
    del recorder
    large = C.probe_cases(device)[-2]
    shapes.append((large[0], *large[1], large[2]))
    for label, *call in shapes:
        probe_args, pair_cap = tuple(call[:-1]), call[-1]
        compare(label, parent_probe(libs["probe_join"], probe_args,
                                    pair_cap),
                cuda_tier.probe_join(*probe_args, pair_cap))
        entry = ab(label,
                   lambda: parent_probe(libs["probe_join"], probe_args,
                                        pair_cap),
                   lambda: cuda_tier.probe_join(*probe_args, pair_cap))
        entry["bound_ms"] = (C.probe_bytes(probe_args, pair_cap)
                             / C.HBM_BYTES_PER_S * 1e3)
        results["joinProbe"].append(entry)
    del shapes, tables, large

    # ---- gatherScatter: the headline merge's concat, lineitem's batches --
    data = C.headline_data(C.ROWS)
    parts = host_batches(data, batch_rows)
    session = GpuSparkSession(RapidsConf(C.SETTINGS))
    df = DataFrame(InMemoryScan(parts, parts[0].schema, 1),
                   session).cache()
    C.headline_query(df).collect()
    concats = [("the headline merge's concat of 16 partials",
                C.batch_columns(C.merge_partials(session, device))),
               ("lineitem's 6 cached batches",
                C.batch_columns(lineitem_batches))]
    for label, (columns, ns, out_cap, byte_caps) in concats:
        compare(label,
                [t for col in parent_concat(libs["pack_segments"], columns,
                                            ns, out_cap, byte_caps)
                 for t in col],
                [t for col in cuda_tier.pack_columns(columns, ns, out_cap,
                                                     byte_caps)
                 for t in col])
        entry = ab(label,
                   lambda: parent_concat(libs["pack_segments"], columns, ns,
                                         out_cap, byte_caps),
                   lambda: cuda_tier.pack_columns(columns, ns, out_cap,
                                                  byte_caps))
        results["gatherScatter"].append(entry)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
