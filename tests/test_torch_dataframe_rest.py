"""PyTorch port, the rest of the DataFrame API, ``Sample``, the
nondeterministic expressions and the file writer, against the JAX package
on the CPU.

* every method of the slice (``head``, ``first``, ``take``, ``is_empty``,
  ``dtypes``, ``print_schema``, ``to_pydict``, ``show``, ``to_pandas``,
  ``with_column_renamed``, ``describe``, ``fillna``, ``dropna``,
  ``drop_duplicates``, ``crosstab``, ``approx_quantile``, ``freq_items``,
  ``count``, ``unpersist``, ``GroupedData.pivot`` and the grouped
  ``sum``/``avg``/``min``/``max``/``count``) gives the JAX host engine's
  result on the same input, the port on its device path (CPU tensors),
  with the exchanges collapsed and split;
* ``sample`` gives the JAX package's rows at one, two and three input
  partitions and after a split; ``sort_within_partitions``,
  ``repartition`` and ``coalesce`` the JAX host engine's;
* ``rand``'s device form gives ``jax.random``'s bits through the JAX
  ``Rand.tpu_eval`` with the same context; its host form the JAX twin's;
  ``monotonically_increasing_id`` and ``spark_partition_id`` agree with
  the JAX package at one partition and one batch (where the JAX context
  is right), and are unique and real over several batches and
  partitions (the difference of design logged in ROADMAP.md);
* ``sample_by`` gives the JAX package's rows at one partition and one
  batch, and elsewhere the filter replayed on the port's own ``rand``;
* the writer: parquet, csv and orc, the save modes and ``partition_by``,
  the JAX writer's files and stats, read back through ``session.read``.

Exact throughout, but ``describe``'s and ``approx_quantile``'s floats
are compared as the JAX host engine prints them (the same operations in
the same order).
"""

import os

import jax.numpy as jnp
import numpy as np
import pyarrow.csv as pacsv
import pyarrow.orc as paorc
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.exprs import misc as JM
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import HostBatch
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exprs import misc as PM
from spark_rapids_tpu_torch.exprs.base import CpuEvalCtx, GpuEvalCtx
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

SPLIT = {"spark.rapids.sql.tpu.exchange.collapseLocal": False,
         "spark.sql.shuffle.partitions": 3}
HOST = {"spark.rapids.sql.enabled": False}


def _data(types, rows=40):
    rng = np.random.RandomState(5)
    return {
        "k": (types.INT, [None if i % 9 == 4 else int(x) for i, x in
                          enumerate(rng.randint(0, 5, rows))]),
        "s": (types.STRING, [None if i % 7 == 3 else "abcde"[i % 4]
                             for i in range(rows)]),
        "x": (types.DOUBLE, [None if i % 6 == 1 else
                             (float("nan") if i % 11 == 5 else float(x))
                             for i, x in enumerate(rng.randint(-50, 50,
                                                               rows) / 4)]),
        "n": (types.LONG, list(range(rows))),
    }


def _frame(session, types, host_batch, logical, dataframe, parts):
    """The data as four batches of ten rows dealt over ``parts``
    partitions."""
    data = _data(types)
    batches = [host_batch.from_pydict({k: (t, v[i:i + 10])
                                       for k, (t, v) in data.items()})
               for i in range(0, 40, 10)]
    return dataframe(logical.InMemoryScan(batches, batches[0].schema,
                                          parts), session)


def _jax(settings=None, parts=2):
    from spark_rapids_tpu.batch import HostBatch as JHostBatch
    from spark_rapids_tpu.dataframe import DataFrame as JDataFrame
    from spark_rapids_tpu.plan import logical as JL
    s = TpuSparkSession(JaxConf(dict(HOST, **(settings or {}))))
    return s, _frame(s, JT, JHostBatch, JL, JDataFrame, parts)


def _port(settings=None, parts=2):
    from spark_rapids_tpu_torch.dataframe import DataFrame
    from spark_rapids_tpu_torch.plan import logical as L
    s = GpuSparkSession(RapidsConf(dict(settings or {})), device="cpu")
    return s, _frame(s, T, HostBatch, L, DataFrame, parts)


def _srt(rows):
    return sorted(rows, key=repr)


#: each method case: df, functions -> a comparable result
METHODS = {
    "head": lambda d, F: d.head(3),
    "head1": lambda d, F: d.head(),
    "first": lambda d, F: d.first(),
    "take": lambda d, F: d.take(4),
    "is_empty": lambda d, F: (d.is_empty(),
                              d.filter(d["n"] < 0).is_empty()),
    "dtypes": lambda d, F: d.dtypes,
    "to_pydict": lambda d, F: repr(d.to_pydict()),
    "count": lambda d, F: d.count(),
    "with_column_renamed": lambda d, F: (
        d.with_column_renamed("k", "kk").columns,
        d.with_column_renamed("k", "kk").collect()),
    "describe": lambda d, F: d.describe().collect(),
    "describe_cols": lambda d, F: d.describe("x", "s").collect(),
    "fillna_scalar": lambda d, F: d.fillna(0).collect(),
    "fillna_float": lambda d, F: d.fillna(2.5).collect(),
    "fillna_string": lambda d, F: d.fillna("zz").collect(),
    "fillna_dict": lambda d, F: d.fillna({"k": 9, "x": 1.0}).collect(),
    "dropna": lambda d, F: d.dropna().collect(),
    "dropna_all": lambda d, F: d.dropna(how="all",
                                        subset=["k", "x"]).collect(),
    "dropna_thresh": lambda d, F: d.dropna(thresh=3).collect(),
    "drop_duplicates": lambda d, F: _srt(d.drop_duplicates(["s"])
                                         .collect()),
    "drop_duplicates_all": lambda d, F: _srt(
        d.select("k", "s").drop_duplicates().collect()),
    "crosstab": lambda d, F: (d.crosstab("k", "s").columns,
                              _srt(d.crosstab("k", "s").collect())),
    "approx_quantile": lambda d, F: d.approx_quantile(
        "n", [0.1, 0.5, 0.75]),
    "freq_items": lambda d, F: d.freq_items(["s", "k"], 0.2).collect(),
    "pivot": lambda d, F: _srt(d.group_by("k").pivot("s").sum("n")
                               .collect()),
    "pivot_values": lambda d, F: _srt(
        d.group_by("k").pivot("s", ["a", "b"])
        .agg(F.count("*"), F.max("n").alias("mx")).collect()),
    "grouped": lambda d, F: [_srt(g.collect()) for g in (
        d.group_by("s").sum("n", "k"), d.group_by("s").avg("n"),
        d.group_by("s").min("k", "n"), d.group_by("s").max("n"),
        d.group_by("s").count())],
}


@pytest.mark.parametrize("split", [False, True], ids=["collapsed", "split"])
@pytest.mark.parametrize("method", list(METHODS))
def test_method_matches_jax(method, split):
    settings = SPLIT if split else {}
    _, jdf = _jax(settings)
    _, pdf = _port(settings)
    want = METHODS[method](jdf, JF)
    assert repr(METHODS[method](pdf, F)) == repr(want)


def test_printed_methods_match_jax(capsys):
    _, jdf = _jax()
    _, pdf = _port()
    jdf.show(5)
    jdf.print_schema()
    want = capsys.readouterr().out
    pdf.show(5)
    pdf.print_schema()
    assert capsys.readouterr().out == want


def test_to_pandas_and_unpersist():
    _, jdf = _jax()
    _, pdf = _port()
    assert pdf.to_pandas().equals(jdf.to_pandas())
    cached = pdf.cache()
    first = cached.collect()
    assert cached.plan.holder.is_materialized
    assert cached.unpersist() is cached
    assert not cached.plan.holder.is_materialized
    assert repr(cached.collect()) == repr(first) == repr(jdf.collect())


# -- the partitioning API and Sample -------------------------------------------


@pytest.mark.parametrize("parts", [1, 2, 3])
@pytest.mark.parametrize("split", [False, True], ids=["collapsed", "split"])
def test_sample_matches_jax(parts, split):
    settings = SPLIT if split else {}
    _, jdf = _jax(settings, parts)
    _, pdf = _port(settings, parts)
    for q in (lambda d: d.sample(0.5, 3),
              lambda d: d.repartition(4, "s").sample(0.3, 7)):
        assert repr(q(pdf).collect()) == repr(q(jdf).collect())


@pytest.mark.parametrize("query", ["repartition", "roundrobin", "coalesce",
                                   "sort_within_partitions"])
def test_partitioning_api_matches_jax_host(query):
    """The partitions' rows in order, the JAX host engine's; the device
    (CPU tensors) and the port's host engine agree, partition ids
    included.  (The JAX device path sorts a split's partitions as one:
    its whole-stage pipeline joins a stage source's partitions.)"""
    def q(d, F):
        if query == "repartition":
            return d.repartition(3, "s", "k")
        if query == "roundrobin":
            return d.repartition(4)
        if query == "coalesce":
            return d.coalesce(2)
        return d.repartition(2, "s").sort_within_partitions("x", "n")

    _, jdf = _jax(SPLIT)
    _, pdf = _port(SPLIT)
    _, hdf = _port(dict(SPLIT, **HOST))
    want = q(jdf, JF).collect()
    assert repr(q(pdf, F).collect()) == repr(want)
    ids = q(pdf, F).with_column("p", F.spark_partition_id()).collect()
    assert repr(ids) == repr(q(hdf, F).with_column(
        "p", F.spark_partition_id()).collect())
    n_parts = {"repartition": 3, "roundrobin": 4, "coalesce": 2}.get(
        query, 2)
    assert {r[-1] for r in ids} == set(range(n_parts))


# -- the nondeterministic expressions -----------------------------------------


class _JaxCtx:
    def __init__(self, capacity, partition_index, base_row_id):
        self.capacity = capacity
        self.partition_index = partition_index
        self.base_row_id = jnp.asarray(base_row_id, jnp.int64)


@pytest.mark.parametrize("seed,part,base", [
    (42, 0, 0), (7, 3, 123_456), (-5, 1, 2 ** 33 + 17), (11, 7, 5_000_000)])
def test_rand_matches_jax_bits(seed, part, base):
    cap = 100
    want = np.asarray(JM.Rand(seed).tpu_eval(_JaxCtx(cap, part, base)).data)
    batch = HostBatch.from_pydict({"n": (T.LONG, list(range(cap)))})
    from spark_rapids_tpu_torch.batch import host_to_device
    db = host_to_device(batch, "cpu", capacity=cap)
    got = PM.Rand(seed).gpu_eval(GpuEvalCtx(
        db, part, torch.tensor(base, dtype=torch.int64))).data.numpy()
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    jctx = type("C", (), {"num_rows": cap, "partition_index": part,
                          "base_row_id": base})()
    np.testing.assert_array_equal(
        PM.Rand(seed).cpu_eval(CpuEvalCtx(batch, part, base)).values,
        JM.Rand(seed).cpu_eval(jctx).values)
    for cls in ("MonotonicallyIncreasingID", "SparkPartitionID"):
        jv = getattr(JM, cls)().tpu_eval(_JaxCtx(cap, part, base))
        pv = getattr(PM, cls)().gpu_eval(GpuEvalCtx(
            db, part, torch.tensor(base, dtype=torch.int64)))
        np.testing.assert_array_equal(pv.data.numpy(), np.asarray(jv.data))


def _ids(d, F):
    return d.with_column("p", F.spark_partition_id()) \
        .with_column("m", F.monotonically_increasing_id()) \
        .with_column("r", F.rand(9))


def test_ids_and_rand_match_jax_at_one_batch():
    """One partition, one batch: the JAX context's defaults are right, and
    the two packages' device paths agree on every column."""
    js = TpuSparkSession(JaxConf({}))
    jdf = js.create_dataframe(_data(JT), num_partitions=1)
    ps = GpuSparkSession(RapidsConf({}), device="cpu")
    pdf = ps.create_dataframe(_data(T), num_partitions=1)
    assert repr(_ids(pdf, F).collect()) == repr(_ids(jdf, JF).collect())


def test_ids_unique_over_batches_and_partitions():
    """Three partitions, split again into four: every id unique, its high
    bits the partition id, each partition's ids consecutive from its
    ordinal << 33; rand differs between partitions and batches.  The JAX
    package gives every batch partition 0 and row 0 (its duplicates are
    the difference of design)."""
    for settings, parts in (({}, 3), (SPLIT, 3)):
        _, pdf = _port(settings, parts)
        frame = _ids(pdf.repartition(4, "n") if settings else pdf, F)
        rows = frame.collect()
        p = np.array([r[-3] for r in rows])
        m = np.array([r[-2] for r in rows])
        assert len(set(m.tolist())) == len(m) == 40
        np.testing.assert_array_equal(m >> 33, p)
        for q in np.unique(p):
            np.testing.assert_array_equal(
                np.sort(m[p == q]) - (int(q) << 33),
                np.arange((p == q).sum()))
        assert len(set(r[-1] for r in rows)) == len(rows)
        assert len(np.unique(p)) == (4 if settings else 3)


def test_sample_by_matches_jax_and_replays_rand():
    fractions = {"a": 0.5, "b": 1.0, None: 0.3}
    js = TpuSparkSession(JaxConf({}))
    jdf = js.create_dataframe(_data(JT), num_partitions=1)
    ps = GpuSparkSession(RapidsConf({}), device="cpu")
    pdf = ps.create_dataframe(_data(T), num_partitions=1)
    assert repr(pdf.sample_by("s", fractions, 5).collect()) == \
        repr(jdf.sample_by("s", fractions, 5).collect())
    for settings in ({}, SPLIT):
        _, pdf = _port(settings, parts=3)
        got = pdf.sample_by("s", fractions, 5).collect()
        replay = [r[:-1] for r in pdf.with_column("__r", F.rand(5))
                  .collect()
                  if r[-1] < {**fractions}.get(r[1], 0.0)]
        assert repr(got) == repr(replay)
        assert 0 < len(got) < 40


# -- the writer -----------------------------------------------------------------


def _write(df, fmt, path, mode="error", partition_by=None):
    if fmt == "parquet":
        return df.write_parquet(path, mode, partition_by=partition_by)
    return getattr(df, f"write_{fmt}")(path, mode)


def _read_table(fmt, path):
    if fmt == "parquet":
        return pq.read_table(path)
    if fmt == "orc":
        return paorc.read_table(path)
    return pacsv.read_csv(path)


@pytest.mark.parametrize("fmt", ["parquet", "csv", "orc"])
def test_writer_round_trip(tmp_path, fmt):
    """One file a partition with the JAX writer's names, tables and
    stats; the save modes; read back through ``session.read``."""
    js, jdf = _jax(parts=2)
    ps, pdf = _port(parts=2)
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    want, got = _write(jdf, fmt, jout), _write(pdf, fmt, pout)
    assert got == want and got["num_files"] == 2  # one a partition
    files = sorted(os.listdir(pout))
    assert files == sorted(os.listdir(jout))
    for f in files:
        if f != "_SUCCESS":  # NaN in the data: compared by repr
            a = _read_table(fmt, os.path.join(pout, f))
            b = _read_table(fmt, os.path.join(jout, f))
            assert a.schema == b.schema
            assert repr(a.to_pylist()) == repr(b.to_pylist())
    if fmt != "csv":  # csv infers its types: compared as tables above
        back = getattr(ps.read, fmt)(pout).collect()
        assert repr(back) == repr(pdf.collect())
    with pytest.raises(FileExistsError):
        _write(pdf, fmt, pout)
    assert _write(pdf, fmt, pout, "ignore") == \
        {"num_files": 0, "num_rows": 0, "num_bytes": 0, "partitions": 0}
    assert _write(pdf.limit(5), fmt, pout, "overwrite")["num_rows"] == 5
    assert _write(jdf.limit(5), fmt, jout, "overwrite")["num_rows"] == 5


def test_writer_partition_by(tmp_path):
    js, jdf = _jax(parts=2)
    ps, pdf = _port(dict(SPLIT), parts=2)
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    q = (lambda d: d.select("k", "s", "n").repartition(2, "s"))
    want = q(jdf).write_parquet(jout, partition_by=["s"])
    got = q(pdf).write_parquet(pout, partition_by=["s"])
    assert got == want
    assert sorted(os.listdir(pout)) == sorted(os.listdir(jout))
    back = ps.read.parquet(pout).collect()
    assert _srt(back) == _srt(js.read.parquet(jout).collect())
    assert len(back) == 40
