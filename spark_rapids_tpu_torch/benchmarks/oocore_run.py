"""Out-of-core run: TPC-H Q1 and Q18 from parquet under a device spill
budget far below the cached tables (port of
``spark_rapids_tpu/benchmarks/oocore_run.py``, with the parts of its
``sf1_run.py`` it needs: ``generate_dataset`` and ``_checksum``).

    python -m spark_rapids_tpu_torch.benchmarks.oocore_run \\
        [--sf 10] [--budget-mb 256] [--queries q1,q18] [--out FILE] \\
        [--data DIR] [--sync-spill]

The tables are the port's generators (``benchmarks/datagen.py``) at true
TPC-H row counts (SF10 lineitem = 60,000,000 rows), written as parquet
with pyarrow, four files a table.  The device session caches every table
under ``spark.rapids.memory.tpu.spillBudgetBytes`` set far below the
working set, so the spill catalog must page the cached batches device ->
host (-> disk, past ``spark.rapids.memory.host.spillStorageSize``) for
the queries to complete; each answer is checked against the port's host
engine (``spark.rapids.sql.enabled=false``) over the same files.

The port's runtime is one per session (the JAX package's is one per
process, which its run resets around itself), so the budget binds to the
session made here whatever ran before.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

#: the generators' own ``sf`` counts lineitem rows in 60,000s; true TPC-H
#: SF1 has 6,000,000
GEN_PER_TRUE_SF = 100

TABLES = ("lineitem", "orders", "customer", "supplier", "nation", "part",
          "partsupp", "region")


def _generators():
    from spark_rapids_tpu_torch.benchmarks import datagen
    return {
        "lineitem": datagen.gen_lineitem,
        "orders": datagen.gen_orders,
        "customer": datagen.gen_customer,
        "supplier": datagen.gen_supplier,
        "nation": lambda _sf: datagen.gen_nation(),
        "part": datagen.gen_part,
        "partsupp": datagen.gen_partsupp,
        "region": lambda _sf: datagen.gen_region(),
    }


def write_table(data, directory: str, num_files: int = 4) -> str:
    """A generator's table ``{name: (type, values)}`` as ``num_files``
    parquet files of consecutive rows in ``directory`` (emptied first);
    returns ``directory``."""
    import numpy as np
    from spark_rapids_tpu_torch.benchmarks.datagen import write_parquet
    os.makedirs(directory, exist_ok=True)
    for f in os.listdir(directory):
        os.unlink(os.path.join(directory, f))
    n = len(next(iter(data.values()))[1])
    bounds = np.linspace(0, n, num_files + 1).astype(np.int64)
    for i in range(num_files):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        if hi > lo or i == 0:
            write_parquet({k: (t, np.asarray(v)[lo:hi])
                           for k, (t, v) in data.items()},
                          os.path.join(directory, f"part-{i:05d}.parquet"))
    return directory


def generate_dataset(true_sf: float, root: str = None, num_files: int = 4,
                     tables=TABLES) -> str:
    """Write the TPC-H-like tables as parquet (``num_files`` files a
    table, one directory each) under ``root`` (default: a directory in
    the temporary directory named by the scale) once; returns ``root``.
    A marker records the scale and the tables, so another scale writes
    again."""
    root = root or os.path.join(tempfile.gettempdir(),
                                f"rapids_torch_tpch_sf{true_sf:g}")
    marker = os.path.join(root, "_COMPLETE")
    stamp = json.dumps({"gen_sf": true_sf * GEN_PER_TRUE_SF,
                        "tables": list(tables), "files": num_files})
    if os.path.exists(marker) and open(marker).read() == stamp:
        return root
    gens = _generators()
    for name in tables:
        write_table(gens[name](true_sf * GEN_PER_TRUE_SF),
                    os.path.join(root, name), num_files)
    with open(marker, "w") as f:
        f.write(stamp)
    return root


def _checksum(rows):
    """(row count, rounded numeric sums): the agreement proxy for large
    results (the JAX package's ``sf1_run._checksum``)."""
    if not rows:
        return (0, ())
    sums = []
    for j in range(len(rows[0])):
        v = [r[j] for r in rows if r[j] is not None]
        if v and isinstance(v[0], (int, float)) and \
                not isinstance(v[0], bool):
            sums.append(round(float(sum(v)), 2))
    return (len(rows), tuple(sums))


def checksums_agree(a, b) -> bool:
    """Equal row counts and numeric sums within float-aggregation
    tolerance (``1e-4`` relative)."""
    return a[0] == b[0] and len(a[1]) == len(b[1]) and all(
        abs(x - y) <= 1e-4 * max(1.0, abs(x), abs(y))
        for x, y in zip(a[1], b[1]))


def session(gpu: bool, root: str, budget_bytes: int = None,
            extra_conf=None, device=None, tables=TABLES):
    """A session over the parquet tables: the device one with every table
    cached under ``budget_bytes`` and its joins' inputs pruned to the
    columns read above them, the host one uncached."""
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.session import GpuSparkSession
    conf = {
        "spark.rapids.sql.enabled": gpu,
        "spark.sql.shuffle.partitions": 4,
        "spark.rapids.sql.variableFloatAgg.enabled": True,
    }
    if gpu:
        # a join carries only the columns read above it: Q18 at SF10
        # otherwise joins lineitem's, orders' and customer's every column
        # (~500 bytes a row over 60,000,000 rows) and passes the card
        conf["spark.rapids.sql.tpu.columnPruning.enabled"] = True
        if budget_bytes is not None:
            conf["spark.rapids.memory.tpu.spillBudgetBytes"] = budget_bytes
        conf.update(extra_conf or {})
    s = GpuSparkSession(RapidsConf(conf), device=device)
    for name in tables:
        df = s.read.parquet(os.path.join(root, name))
        if gpu:
            # at these scales the cache cannot fit the budget: the
            # catalog must keep the query alive by spilling
            df = df.cache()
        df.create_or_replace_temp_view(name)
    return s


#: the fault ladder's counters in ``session.last_metrics``: any of them
#: above 0 means the device session replayed work or completed it on the
#: host, so its time and answer are not the card's alone
FAULT_COUNTERS = ("retryCount", "deviceLostCount", "partitionFallbackCount",
                  "faultsInjected")


def run(sf: float, budget_bytes: int, queries, out_path: str = None,
        extra_conf=None, device=None, root: str = None,
        tables=TABLES) -> dict:
    """Each query on the budgeted device session and on the host engine;
    per query: seconds, rows, agreement, the fault ladder's counters and
    the catalog's cumulative spill counters.  Raises, after every query
    ran, unless every answer agrees, no query engaged the fault ladder
    and something spilled.  ``extra_conf`` overlays the device session's
    conf (e.g. ``spark.rapids.sql.tpu.spill.async.enabled=false``)."""
    from spark_rapids_tpu_torch.benchmarks.tpch_like import QUERIES
    root = generate_dataset(sf, root, tables=tables)
    dev = session(True, root, budget_bytes, extra_conf, device, tables)
    assert dev.runtime.catalog.device_budget == budget_bytes
    cpu = session(False, root, device="cpu", tables=tables)
    results = {}
    for qname in queries:
        sql = QUERIES[qname]
        t0 = time.monotonic()
        d_rows = dev.sql(sql).collect()
        d_s = time.monotonic() - t0
        faults = {k: dev.last_metrics.get(k, 0) for k in FAULT_COUNTERS}
        mem = dict(dev.runtime.catalog.metrics)
        t0 = time.monotonic()
        c_rows = cpu.sql(sql).collect()
        c_s = time.monotonic() - t0
        dc, cc = _checksum(d_rows), _checksum(c_rows)
        results[qname] = {
            "gpu_s": d_s, "cpu_s": c_s, "rows": dc[0],
            "agree": checksums_agree(dc, cc), "faults": faults,
            "spilled_to_host": mem.get("spilled_to_host", 0),
            "spilled_to_disk": mem.get("spilled_to_disk", 0),
            "unspilled": mem.get("unspilled", 0),
        }
        print(f"{qname}: gpu {d_s:.3f}s cpu {c_s:.3f}s rows={dc[0]} "
              f"agree={results[qname]['agree']} faults={faults} "
              f"spills={mem}", flush=True)
        if out_path:
            _write(sf, budget_bytes, results, out_path)
    total = sum(r["spilled_to_host"] + r["spilled_to_disk"]
                for r in results.values())
    assert total > 0, (f"a budget of {budget_bytes} bytes never forced a "
                       f"spill: not an out-of-core run: {results}")
    assert all(r["agree"] for r in results.values()), results
    laddered = {q: r["faults"] for q, r in results.items()
                if any(r["faults"].values())}
    assert not laddered, (
        "the fault ladder replayed or completed on the host (the device "
        f"time and answer are not the card's alone): {laddered}")
    return results


def _write(sf, budget_bytes, results, out_path):
    lines = [
        f"# Out-of-core run: TPC-H SF{sf:g}, {budget_bytes} byte device "
        "budget",
        "",
        f"lineitem = {int(sf * 6_000_000):,} rows.  Checksums against the "
        "host engine over the same files.",
        "",
        "| query | gpu s | cpu s | rows | agree | retries/device lost/"
        "host partitions/injected | spilled host/disk | unspilled |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for q, r in sorted(results.items()):
        lines.append(
            f"| {q} | {r['gpu_s']} | {r['cpu_s']} | {r['rows']} | "
            f"{'yes' if r['agree'] else 'NO'} | "
            f"{'/'.join(str(r['faults'][k]) for k in FAULT_COUNTERS)} | "
            f"{r['spilled_to_host']}/{r['spilled_to_disk']} | "
            f"{r['unspilled']} |")
    lines.append("")
    with open(out_path, "w") as f:
        f.write("\n".join(lines))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--budget-mb", type=int, default=256)
    ap.add_argument("--queries", default="q1,q18")
    ap.add_argument("--out", default=None,
                    help="also write the results as a markdown table")
    ap.add_argument("--data", default=None,
                    help="parquet directory (default: in the temporary "
                         "directory, by scale)")
    ap.add_argument("--sync-spill", action="store_true",
                    help="turn the asynchronous spill writers off")
    a = ap.parse_args(argv)
    extra = {"spark.rapids.sql.tpu.spill.async.enabled": False} \
        if a.sync_spill else None
    res = run(a.sf, a.budget_mb << 20, a.queries.split(","), a.out,
              extra_conf=extra, root=a.data)
    print(json.dumps({"sf": a.sf, "budget_mb": a.budget_mb,
                      "results": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
