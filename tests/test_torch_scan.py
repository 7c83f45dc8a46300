"""PyTorch port, the scan lane: ``session.read`` over parquet, csv and orc,
Hive partition directories, row-group pushdown, late materialization, the
v1 and v2 scans and the read-ahead staging, held against the JAX
package's ``TpuSparkSession`` on the CPU.

Both packages read the same small files, written once per module with
pyarrow into a temporary directory from numpy draws of fixed seeds.  The
JAX side runs with ``spark.rapids.sql.tpu.scan.dictEncoding.enabled`` off:
by default it keeps dictionary strings as codes on the device, where the
port always stages the bytes.  Where a test compares a scan's own output
(partition pruning, pushdown, late materialization), both packages' scan
execs are planned by their planners and driven alone, which holds the
rows each scan hands on and its metrics (``rowGroupsRead``,
``rowGroupsTotal``, ``scanChunksSkipped``) without compiling a JAX
program; the port's whole query is then held to the JAX scan's rows
filtered by the same predicate in numpy.  Rows of a plain scan are exact;
float sums and averages are within 1e-9 relative (the slot aggregate's
float sums recombine limb rows with a per-chunk scale that XLA on the CPU
fuses into an FMA under jit, where torch rounds first).
"""

import math
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.orc as orc
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.batch import host_to_device as jax_h2d
from spark_rapids_tpu.benchmarks import tpch_like as JQ
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.io.arrow_convert import \
    arrow_to_host_batch as jax_arrow_to_host
from spark_rapids_tpu.plan.overrides import TpuOverrides
from spark_rapids_tpu.plan.physical import ExecContext as JaxCtx
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch import functions as PF
from spark_rapids_tpu_torch.batch import host_to_device
from spark_rapids_tpu_torch.benchmarks import datagen as PD
from spark_rapids_tpu_torch.benchmarks import tpch_like as PQ
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.io.arrow_convert import arrow_to_host_batch
from spark_rapids_tpu_torch.plan.overrides import GpuOverrides
from spark_rapids_tpu_torch.plan.physical import (
    ExecContext, HostToDeviceExec,
)
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from torch_port_util import assert_device_bits, plan_shape

SETTINGS = {"spark.rapids.sql.variableFloatAgg.enabled": True,
            "spark.sql.shuffle.partitions": 1,
            "spark.rapids.sql.hasNans": False}
JAX_ONLY = {"spark.rapids.sql.tpu.scan.dictEncoding.enabled": False}
V2 = "spark.rapids.sql.tpu.scan.v2.enabled"
DEPTH = "spark.rapids.sql.tpu.scan.readAhead.depth"
STAGE = "spark.rapids.sql.tpu.stage.readAheadBatches"
SLAB = "spark.rapids.sql.tpu.scan.pageChunk.minBytes"
PUSHDOWN = "spark.rapids.sql.scan.pushdown.enabled"
REL = 1e-9
SF = 0.02
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["green", "", "héllo", "中文", "\U0001f642x", "navy",
         "a\x00b"]


def _jax(**extra):
    return TpuSparkSession(JaxConf(dict(SETTINGS, **JAX_ONLY, **extra)))


def _port(**extra):
    return GpuSparkSession(RapidsConf(dict(SETTINGS, **extra)),
                           device="cpu")


def _with_nulls(rng, values, frac=0.15):
    mask = rng.rand(len(values)) < frac
    return pa.array([None if m else v for v, m in
                     zip(np.asarray(values).tolist(), mask)])


def _mixed_table(rng, n):
    """Every column type the scan converts, with NULLs in each nullable
    one: ints, doubles, strings (non-ASCII, empty, an interior NUL), a
    dictionary-encoded string column, DATE, TIMESTAMP and BOOLEAN."""
    words = np.array(WORDS)[rng.randint(0, len(WORDS), n)]
    return pa.table({
        "i": pa.array(_with_nulls(rng, rng.randint(-99, 99, n)), pa.int32()),
        "l": pa.array(rng.randint(-10**12, 10**12, n), pa.int64()),
        "d": pa.array(_with_nulls(rng, rng.rand(n).round(3)), pa.float64()),
        "s": pa.array(_with_nulls(rng, words), pa.string()),
        "ds": pa.array(_with_nulls(rng, np.array(["AIR", "MAIL", "SHIP"])[
            rng.randint(0, 3, n)]), pa.string()).dictionary_encode(),
        "dt": pa.array(_with_nulls(rng, rng.randint(8000, 11000, n)),
                       pa.int32()).cast(pa.date32()),
        "ts": pa.array(_with_nulls(rng, rng.randint(0, 2**40, n)),
                       pa.int64()).cast(pa.timestamp("us", tz="UTC")),
        "b": pa.array(_with_nulls(rng, rng.rand(n) < 0.5), pa.bool_()),
    })


def _bench_data(rows):
    """bench.py:make_data at ``rows`` rows (seed 42)."""
    rng = np.random.RandomState(42)
    return {
        "ss_item_sk": (PD.T.INT, rng.randint(0, 2000, rows)),
        "ss_promo_sk": (PD.T.INT, rng.randint(0, 3, rows)),
        "ss_quantity": (PD.T.INT, rng.randint(1, 101, rows)),
        "ss_sales_price": (PD.T.DOUBLE, (rng.rand(rows) * 200).round(2)),
        "ss_ext_discount_amt": (PD.T.DOUBLE,
                                (rng.rand(rows) * 100).round(2)),
    }


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("scan")
    rng = np.random.RandomState(5)
    out = {}
    mixed = _mixed_table(rng, 3000)
    out["parquet"] = str(root / "mixed.parquet")
    pq.write_table(mixed, out["parquet"], row_group_size=1000)
    plain = mixed.drop_columns(["ds"])
    out["orc"] = str(root / "mixed.orc")
    orc.write_table(plain, out["orc"])
    out["csv"] = str(root / "mixed.csv")
    pacsv.write_csv(plain.select(["i", "l", "d", "s"]), out["csv"])
    # Hive layout p=<int>/q=<str>: two keys, eight files
    for p in range(4):
        for q in ("x", "y"):
            d = root / "hive" / f"p={p}" / f"q={q}"
            d.mkdir(parents=True)
            n = 50 + 10 * p
            pq.write_table(pa.table({
                "k": pa.array(rng.randint(0, 100, n), pa.int64()),
                "name": pa.array(np.array(WORDS)[rng.randint(0, 7, n)]),
            }), str(d / "part-0.parquet"))
    out["hive"] = str(root / "hive")
    # a column sorted across 4 row groups, and a DATE column beside it
    n = 8000
    out["sorted"] = str(root / "sorted.parquet")
    pq.write_table(pa.table({
        "k": pa.array(np.arange(n), pa.int64()),
        "dt": pa.array(8000 + np.arange(n) // 4, pa.int32()).cast(
            pa.date32()),
        "v": pa.array(rng.rand(n).round(4)),
    }), out["sorted"], row_group_size=2000)
    # late materialization: each chunk's min/max brackets the needle, so
    # only the exact probe can skip (8 chunks, the needle in one)
    tag = (rng.randint(-500, 500, 4000) * 2).astype(np.int64)
    tag[2 * 500 + 11] = 501
    out["needle"] = str(root / "needle.parquet")
    pq.write_table(pa.table({
        "tag": pa.array(tag), "v": pa.array(rng.rand(4000).round(4)),
        "s": pa.array(np.array([f"s{i % 7}" for i in range(4000)]))}),
        out["needle"], row_group_size=500)
    # bench.py's scan input: 4 row groups
    out["bench"] = str(root / "bench")
    os.makedirs(out["bench"])
    PD.write_parquet(_bench_data(20_000),
                     os.path.join(out["bench"], "part-0.parquet"),
                     row_group_size=5_000)
    # TPC-H tables (the port's generators give the JAX package's arrays)
    out["tpch"] = {}
    for name, gen in (("lineitem", PD.gen_lineitem),
                      ("orders", PD.gen_orders),
                      ("customer", PD.gen_customer)):
        d = root / "tpch" / name
        d.mkdir(parents=True)
        out["tpch"][name] = PD.write_parquet(
            gen(SF), str(d / "part-0.parquet"))
    return out


def _sorted_rows(rows):
    return sorted(rows, key=lambda r: tuple((v is None, str(v)) for v in r))


def assert_rows_match(got, want, label):
    """Same rows in the same order; ints and strings exact, floats within
    ``REL`` relative."""
    assert len(got) == len(want), label
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), (label, i)
        for gv, wv in zip(g, w):
            if isinstance(wv, float):
                assert isinstance(gv, float) and math.isclose(
                    gv, wv, rel_tol=REL, abs_tol=0.0), (label, i, gv, wv)
            else:
                assert gv == wv, (label, i, gv, wv)


def _find(op, name):
    if type(op).__name__ == name:
        return op
    for c in op.children:
        hit = _find(c, name)
        if hit is not None:
            return hit
    return None


def _jax_scan(session, df):
    """The JAX package's scan exec of ``df``'s plan, driven alone: its
    host rows (all partitions, in order) and its metrics."""
    phys = TpuOverrides(session.conf).apply(df.plan)
    scan = _find(phys, "FileScanV2Exec") or _find(phys, "CpuFileScanExec")
    ctx = JaxCtx(session.conf)
    batches = [hb for part in scan.partitions(ctx) for hb in part]
    rows = [r for hb in batches for r in zip(*hb.to_pydict().values())]
    return rows, batches, {n: m.value for n, m in
                           ctx.metrics.get(scan.op_id, {}).items()}


def _port_scan(session, df):
    phys = GpuOverrides(session.conf).apply(df.plan)
    scan = _find(phys, "FileScanV2Exec") or _find(phys, "CpuFileScanExec")
    ctx = ExecContext(session.conf, session.device)
    batches = [hb for part in scan.partitions(ctx) for hb in part]
    rows = [r for hb in batches for r in zip(*hb.to_pydict().values())]
    return rows, scan, ctx.summed_metrics()


def _first_staged(session, df):
    """The first batch the port's HostToDeviceExec stages above the scan
    (through the read-ahead worker at the default depth).  A plan of the
    scan alone stays on the host, as the JAX package's does, so the
    staging exec is put above it here."""
    phys = GpuOverrides(session.conf).apply(df.plan)
    h2d = _find(phys, "HostToDeviceExec") or HostToDeviceExec(phys)
    part = h2d.partitions(ExecContext(session.conf, session.device))[0]
    first = next(part)
    part.close()
    return first


# -- formats ---------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_format_rows_and_first_batch_bits_match_jax(files, fmt):
    """Every row equal, and the first staged batch's device buffers equal
    the JAX package's staging of its first scanned batch, bit for bit."""
    js, ps = _jax(), _port()
    jdf = getattr(js.read, fmt)(files[fmt])
    pdf = getattr(ps.read, fmt)(files[fmt])
    assert pdf.columns == jdf.columns
    assert pdf.collect() == jdf.collect()
    _, jbatches, _ = _jax_scan(js, jdf)
    assert_device_bits(jax_h2d(jbatches[0]), _first_staged(ps, pdf))


@pytest.mark.parametrize("case", ["sliced", "null-owns-bytes", "large"])
def test_arrow_strings_stage_as_jax(case):
    """A string array handed over as offsets and bytes: a sliced array's
    offsets are rebased, a NULL slot's bytes dropped, int64 offsets taken
    to int32; the device bytes equal the JAX package's."""
    values = ["ab", None, "hé", "", "xyz", None, "q"]
    if case == "sliced":
        arr = pa.array(values).slice(2, 4)
    elif case == "large":
        arr = pa.array(values, pa.large_string())
    else:  # offsets give the NULL rows 2 and 3 bytes
        arr = pa.StringArray.from_buffers(
            3, pa.py_buffer(np.array([0, 2, 5, 6], np.int32).tobytes()),
            pa.py_buffer(b"abcdef"),
            pa.py_buffer(np.packbits([1, 0, 1], bitorder="little")
                         .tobytes()), 1)
    tb = pa.table({"s": arr})
    jb, pb = jax_arrow_to_host(tb), arrow_to_host_batch(tb)
    assert pb.columns[0].offsets is not None
    assert pb.to_pydict() == jb.to_pydict()
    assert_device_bits(jax_h2d(jb), host_to_device(pb, "cpu"))


# -- partitions, pushdown, late materialization ----------------------------


def test_hive_partitions_prune_as_jax(files):
    """``p=<int>/q=<str>`` directories become a LONG and a STRING column;
    a pushed ``p >= 2`` prunes the files of p 0 and 1 in both packages."""
    js, ps = _jax(), _port()
    jdf, pdf = js.read.parquet(files["hive"]), ps.read.parquet(files["hive"])
    assert pdf.columns == jdf.columns == ["k", "name", "p", "q"]
    assert [str(f.dtype) for f in pdf.schema.fields] == \
        [str(f.dtype) for f in jdf.schema.fields]
    jrows, _, jm = _jax_scan(js, jdf.filter(jdf["p"] >= 2))
    prows, scan, pm = _port_scan(ps, pdf.filter(pdf["p"] >= 2))
    assert prows == jrows and len(scan.paths) == 4
    assert {r[2] for r in prows} == {2, 3}
    assert pm["rowGroupsRead"] == jm["rowGroupsRead"] == 4
    got = pdf.filter(pdf["p"] >= 2).collect()
    assert _sorted_rows(got) == _sorted_rows(jrows)


@pytest.mark.parametrize("column, cut, read", [
    ("k", 1500, 1),      # sorted int column: one row group of four
    ("dt", 8766, 4),     # DATE statistic against an int: incomparable
], ids=["int", "date"])
def test_row_group_pushdown_matches_jax(files, column, cut, read):
    js, ps = _jax(), _port()
    jdf = js.read.parquet(files["sorted"])
    pdf = ps.read.parquet(files["sorted"])
    jrows, _, jm = _jax_scan(js, jdf.filter(jdf[column] < cut))
    prows, _, pm = _port_scan(ps, pdf.filter(pdf[column] < cut))
    assert prows == jrows
    assert (pm["rowGroupsRead"], pm["rowGroupsTotal"]) == \
        (jm["rowGroupsRead"], jm["rowGroupsTotal"]) == (read, 4)
    got = pdf.filter(pdf[column] < cut).collect()
    idx = pdf.columns.index(column)
    assert got == [r for r in jrows if r[idx] < cut]


def test_late_materialization_skips_as_jax(files):
    js, ps = _jax(), _port()
    jdf = js.read.parquet(files["needle"])
    pdf = ps.read.parquet(files["needle"])
    jrows, _, jm = _jax_scan(js, jdf.filter(jdf["tag"] == 501))
    prows, _, pm = _port_scan(ps, pdf.filter(pdf["tag"] == 501))
    assert prows == jrows
    assert pm["scanChunksSkipped"] == jm["scanChunksSkipped"] == 7
    assert pm["rowGroupsRead"] == jm["rowGroupsRead"] == 8
    got = pdf.filter(pdf["tag"] == 501).collect()
    assert got == [r for r in jrows if r[0] == 501] and len(got) == 1


# -- bench.py's scan query ---------------------------------------------------


def scan_query(df, F):
    """bench.py:time_scan_engine's query, in either package's API."""
    return (df
            .filter((df["ss_quantity"] < 25) &
                    (df["ss_ext_discount_amt"] > 10.0))
            .with_column("revenue",
                         df["ss_sales_price"] * df["ss_ext_discount_amt"])
            .group_by("ss_item_sk")
            .agg(F.sum("revenue").alias("sum_rev"),
                 F.count("revenue").alias("cnt")))


@pytest.fixture(scope="module")
def jax_scan_rows(files):
    return _sorted_rows(scan_query(_jax().read.parquet(files["bench"]),
                                   JF).collect())


@pytest.mark.parametrize("conf", [
    {V2: False, STAGE: 0}, {V2: False, STAGE: 2},
    {V2: True, DEPTH: 1, STAGE: 0}, {V2: True, DEPTH: 1, STAGE: 2},
    {V2: True, DEPTH: 4, STAGE: 0}, {V2: True, DEPTH: 4, STAGE: 2},
    {V2: True, DEPTH: 4, STAGE: 2, SLAB: 1024, PUSHDOWN: False},
], ids=["v1-sync", "v1-ra2", "v2-d1-sync", "v2-d1-ra2", "v2-d4-sync",
        "v2-d4-ra2", "v2-slabs"])
def test_scan_query_matches_jax(files, jax_scan_rows, conf):
    """bench.py's scan query over 4 row groups: the v1 and v2 scans, scan
    read-ahead depths 1 and 4, staging read-ahead 0 and 2, and row groups
    decoded as column slabs (pushdown off: slabs are not planned under a
    pushed predicate), all equal the JAX package's rows; v2 reports its
    depth and decode metrics."""
    ps = _port(**conf)
    got = scan_query(ps.read.parquet(files["bench"]), PF).collect()
    assert_rows_match(_sorted_rows(got), jax_scan_rows, str(conf))
    m = ps.last_metrics
    assert (m["rowGroupsRead"], m["rowGroupsTotal"]) == (4, 4)
    if conf[V2]:
        assert m["readaheadDepthEffective"] == conf[DEPTH]
        assert m["scanBytesDecoded"] > 0 and m["scanDecodeWallNs"] > 0
    else:
        assert "scanDecodeWallNs" not in m


def test_readahead_worker_error_fails_query(tmp_path, files):
    """A file that fails to decode in the read-ahead worker fails the
    query on the consumer's side instead of ending the partition."""
    bad = tmp_path / "bad"
    bad.mkdir()
    src = os.path.join(files["bench"], "part-0.parquet")
    data = open(src, "rb").read()
    (bad / "part-0.parquet").write_bytes(data)
    (bad / "part-1.parquet").write_bytes(data[:4] + b"\0" * 4096 +
                                         data[-(len(data) // 2):])
    for v2 in (True, False):
        ps = _port(**{V2: v2})
        with pytest.raises((pa.ArrowException, OSError)):
            scan_query(ps.read.parquet(str(bad)), PF).collect()


def test_metric_adds_from_many_threads():
    """A per-operator metric takes adds from several threads (the decode
    pool, the staging worker) without losing one."""
    ctx = ExecContext(RapidsConf(), "cpu")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            ctx.metric("op", "n").add(1) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert ctx.op_metrics["op"]["n"].value == 16 * 2000


def test_limit_stops_readahead_worker(files):
    ps = _port(**{DEPTH: 1, "spark.sql.shuffle.partitions": 1})
    got = ps.read.parquet(files["bench"]).limit(7).collect()
    assert len(got) == 7
    assert not [t for t in threading.enumerate()
                if t.name == "stage-readahead" and t.is_alive()]


# -- plans and TPC-H over parquet views --------------------------------------


def _views(session, files):
    for name, path in files["tpch"].items():
        session.read.parquet(os.path.dirname(path)) \
            .create_or_replace_temp_view(name)
    return session


@pytest.mark.parametrize("query", ["scan", "q1", "q6"])
def test_plan_matches_jax(files, query):
    """bench.py's scan query and SQL Q1 and Q6 over parquet views plan,
    exec by exec, as the JAX package plans them (map fusion off there,
    so filters stay execs of their own as in the port)."""
    js, ps = _jax(), _port()
    if query == "scan":
        jdf = scan_query(js.read.parquet(files["bench"]), JF)
        pdf = scan_query(ps.read.parquet(files["bench"]), PF)
    else:
        jdf = _views(js, files).sql(JQ.QUERIES[query])
        pdf = _views(ps, files).sql(PQ.QUERIES[query])
    want = plan_shape(TpuOverrides(JaxConf(dict(
        SETTINGS, **JAX_ONLY,
        **{"spark.rapids.sql.fusion.enabled": False}))).apply(jdf.plan))
    assert plan_shape(GpuOverrides(ps.conf).apply(pdf.plan)) == want
    assert "FileScanV2" in str(want)


@pytest.fixture(scope="module")
def jax_tpch(files):
    js = _views(_jax(), files)
    return {q: js.sql(JQ.QUERIES[q]).collect() for q in ("q1", "q3", "q6")}


@pytest.mark.parametrize("query", ["q1", "q3", "q6"])
def test_tpch_over_parquet_matches_jax(files, jax_tpch, query):
    ps = _views(_port(), files)
    assert_rows_match(ps.sql(PQ.QUERIES[query]).collect(), jax_tpch[query],
                      query)


def test_scan_runs_without_jax(files):
    """``session.read.parquet`` and bench.py's scan query in a process that
    never imports jax or the JAX package."""
    code = textwrap.dedent(f"""
        import sys
        from spark_rapids_tpu_torch import functions as F
        from spark_rapids_tpu_torch.config import RapidsConf
        from spark_rapids_tpu_torch.session import GpuSparkSession
        s = GpuSparkSession(RapidsConf(
            {{"spark.rapids.sql.variableFloatAgg.enabled": True}}),
            device="cpu")
        df = s.read.parquet({files["bench"]!r})
        rows = (df.filter(df["ss_quantity"] < 25).group_by("ss_item_sk")
                .agg(F.count("ss_quantity").alias("c")).collect())
        print(len(rows) > 0, s.last_metrics["rowGroupsRead"],
              "jax" in sys.modules,
              any(m.split(".")[0] == "spark_rapids_tpu" for m in sys.modules))
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "4", "False", "False"]
