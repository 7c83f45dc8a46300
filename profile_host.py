#!/usr/bin/env python3
"""The host engine's key coding, timed with each of its fast paths on and
off: the grouping (``ops/cpu_exec.py:group_ids``) the host aggregate runs
over the fallback phase's keys, on this machine's CPU.

    python3 profile_host.py [--repeat 5]

Keys, as ``chip_smoke.py``'s fallback phase hands them to the host
aggregate (string columns as bytes and offsets, the form a
``DeviceToHostExec`` gives): Q1's ``l_returnflag, l_linestatus`` over
6,000,000 lineitem rows; the part query's ``p_brand, p_type`` over
2,000,000 part rows; Q10's ``c_custkey, c_name, c_acctbal`` over
150,000 customer rows.  Variants: as the engine runs; without the
presence table of ``_dense`` (every integer key coded by ``np.unique``);
without the narrow radix sort of ``_small_sort`` (an int64 stable sort);
without both.  Prints one JSON line: per key set and variant the median
ms of ``--repeat`` runs, every variant's groups checked equal.  Needs no
GPU and imports nothing of JAX.
"""

import argparse
import json
import statistics
import time

import numpy as np


def _key_sets():
    from spark_rapids_tpu_torch.batch import (
        HostColumn, _string_host_to_buffers,
    )
    from spark_rapids_tpu_torch.benchmarks import datagen

    def column(data, name):
        dtype, values = data[name]
        values = np.asarray(values)
        validity = np.ones(len(values), dtype=np.bool_)
        if dtype.is_string:
            offsets, raw = _string_host_to_buffers(values, validity)
            return HostColumn(dtype, raw, validity, offsets)
        return HostColumn(dtype, values.astype(dtype.np_dtype), validity)

    lineitem = datagen.gen_lineitem(100)
    part = datagen.gen_part(1000)
    customer = datagen.gen_customer(100)
    return {
        "q1": [column(lineitem, n) for n in ("l_returnflag",
                                             "l_linestatus")],
        "part": [column(part, n) for n in ("p_brand", "p_type")],
        "q10": [column(customer, n) for n in ("c_custkey", "c_name",
                                              "c_acctbal")],
    }


def main() -> int:
    from spark_rapids_tpu_torch.ops import cpu_exec
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args()
    t0 = time.monotonic()
    sets = _key_sets()
    made_s = time.monotonic() - t0
    dense_span, small_sort = cpu_exec._DENSE_SPAN, cpu_exec._small_sort

    def wide_sort(codes, span):
        return np.argsort(codes, kind="stable")

    variants = {"as is": (dense_span, small_sort),
                "no presence table": (0, small_sort),
                "no narrow sort": (dense_span, wide_sort),
                "neither": (0, wide_sort)}
    out = {"tables_s": made_s, "ms": {}}
    try:
        for name, cols in sets.items():
            n = len(cols[0])
            want = None
            row = out["ms"][name] = {"rows": n}
            for variant, (span, sort) in variants.items():
                cpu_exec._DENSE_SPAN, cpu_exec._small_sort = span, sort
                times = []
                for _ in range(args.repeat):
                    t = time.perf_counter()
                    gid, first, _ = cpu_exec.group_ids(cols, n)
                    times.append((time.perf_counter() - t) * 1e3)
                if want is None:
                    want = (gid, first)
                    row["groups"] = len(first)
                elif not (np.array_equal(gid, want[0]) and
                          np.array_equal(first, want[1])):
                    raise AssertionError(f"{name}: {variant} groups differ")
                row[variant] = statistics.median(times)
    finally:
        cpu_exec._DENSE_SPAN, cpu_exec._small_sort = dense_span, small_sort
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
