"""PyTorch port: the string kernels' plain versions, the string gather and
the LIKE query against the JAX package.

* ``string_hash_rows`` (what a CPU tensor takes, and what the stringHash
  kernel is held to on the card) against the JAX package's XLA
  formulation (``exprs/strings.py`` ``string_hash2``) and its Pallas
  kernel in interpret mode, bit for bit;
* ``rows_with_match`` (the strings kernel's plain version) against
  ``_rows_with_match`` and the interpret-mode Pallas scan;
* the part query (``LIKE '%green%'`` / ``contains``, two string group
  keys) through both packages, rows equal in the same order.

Every comparison is exact: these functions hash, match or move bytes.
The edge cases are the ones ``chip_smoke.py`` runs the kernels over on the
card: capacities around the Pallas block of 512 rows, an all-empty column,
a 64 KiB row, multi-byte UTF-8, NULL rows, rows past ``num_rows`` and
garbage bytes past ``offsets[-1]``; needles of 1, 5, 16 and 70 bytes,
matches at a row's first and last byte, needles that would span a row
boundary and a match that ends exactly at ``offsets[-1]``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.benchmarks import datagen as JD
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.dataframe import DataFrame as JaxDataFrame
from spark_rapids_tpu.exprs import strings as JS
from spark_rapids_tpu.exprs.base import DevVal as JaxDevVal
from spark_rapids_tpu.kernels import pallas_strings as JPS
from spark_rapids_tpu.kernels import pallas_tier as JPT
from spark_rapids_tpu.plan.logical import InMemoryScan as JaxScan
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch import functions as PF
from spark_rapids_tpu_torch.benchmarks import datagen as PD
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.dataframe import DataFrame
from spark_rapids_tpu_torch.interop import host_batches
from spark_rapids_tpu_torch.kernels import cuda_tier
from spark_rapids_tpu_torch.plan.logical import InMemoryScan
from spark_rapids_tpu_torch.session import GpuSparkSession

WORDS = ["a", "green", "é", "中文", "🙂x", "greengreen", "lemon navy",
         "Brand#13", "g", "n", "ee"]


def string_column(seed, cap, num_rows, long_row=0, empty=False):
    """(data u8, offsets int32[cap+1]) of a string column as the device
    holds it: rows of 0-30 bytes (multi-byte UTF-8 among them, some empty
    as NULL rows are), offsets constant past ``num_rows``, random garbage
    past ``offsets[-1]`` up to a power-of-two byte capacity.  ``long_row``
    makes row 1 that many bytes."""
    rng = np.random.RandomState(seed)
    rows = []
    for r in range(num_rows):
        if empty or rng.rand() < 0.15:
            rows.append(b"")
        elif r == 1 and long_row:
            rows.append(bytes(rng.randint(32, 127, long_row, dtype=np.uint8)))
        else:
            n = rng.randint(1, 5)
            rows.append(" ".join(rng.choice(WORDS, n)).encode()[:30])
    lens = np.array([len(b) for b in rows] + [0] * (cap - num_rows))
    offsets = np.zeros(cap + 1, dtype=np.int32)
    np.cumsum(lens, out=offsets[1:])
    total = int(offsets[-1])
    nbytes = max(16, 1 << max(total + 7, 1).bit_length())
    data = rng.randint(0, 256, nbytes).astype(np.uint8)  # garbage
    data[:total] = np.frombuffer(b"".join(rows), dtype=np.uint8)
    return data, offsets


HASH_CASES = {
    "cap1-all-empty": dict(cap=1, num_rows=1, empty=True),
    "cap511": dict(cap=511, num_rows=500),
    "cap512": dict(cap=512, num_rows=512),
    "cap513": dict(cap=513, num_rows=300),
    "row-64KiB": dict(cap=16, num_rows=9, long_row=1 << 16),
}


@pytest.mark.parametrize("case", list(HASH_CASES))
def test_string_hash_matches_xla_and_pallas(case):
    data, offsets = string_column(len(case), **HASH_CASES[case])
    cap = len(offsets) - 1
    h1, h2 = cuda_tier.string_hash_rows(torch.from_numpy(data),
                                        torch.from_numpy(offsets))
    assert h1.dtype == h2.dtype == torch.int64 and h1.shape == (cap,)
    jv = JaxDevVal(JT.STRING, jnp.asarray(data), jnp.ones(cap, jnp.bool_),
                   jnp.asarray(offsets))
    # the XLA formulation (default conf), as one compiled program
    wants = [jax.jit(JS.string_hash2)(jv)]
    if case != "row-64KiB":  # the interpreter's row loop would take long
        wants.append(JPT.string_hash_rows(
            jnp.asarray(data), jnp.asarray(offsets), cap, JS._HASH_BASES,
            interpret=True))
    for want in wants:
        for got, w in zip((h1, h2), want):
            w = np.asarray(jax.device_get(w))
            assert w.dtype == np.uint32
            np.testing.assert_array_equal(got.numpy(), w.astype(np.int64))
    # rows past num_rows and empty rows hash to 0
    empty = offsets[1:] == offsets[:-1]
    assert not h1.numpy()[empty].any() and not h2.numpy()[empty].any()


def test_string_hash_columns_match_xla_and_pallas():
    """Several columns of different capacities (an all-empty one, the
    64 KiB row) in one call: each equals the JAX package's string_hash2,
    and the small one its Pallas kernel in interpret mode."""
    names = ["cap1-all-empty", "cap511", "row-64KiB", "cap513"]
    cols = [string_column(len(n), **HASH_CASES[n]) for n in names]
    got = cuda_tier.string_hash_columns(
        [(torch.from_numpy(d), torch.from_numpy(o)) for d, o in cols])
    assert len(got) == len(cols)
    for (data, offsets), (h1, h2) in zip(cols, got):
        cap = len(offsets) - 1
        jv = JaxDevVal(JT.STRING, jnp.asarray(data), jnp.ones(cap, jnp.bool_),
                       jnp.asarray(offsets))
        wants = [jax.jit(JS.string_hash2)(jv)]
        if cap == 1:
            wants.append(JPT.string_hash_rows(
                jnp.asarray(data), jnp.asarray(offsets), cap, JS._HASH_BASES,
                interpret=True))
        for want in wants:
            for g, w in zip((h1, h2), want):
                np.testing.assert_array_equal(
                    g.numpy(), np.asarray(jax.device_get(w)).astype(np.int64))
    assert cuda_tier.string_hash_columns([]) == []


def test_hash_literal_matches_row_hash():
    data = np.frombuffer("green 中文".encode(), dtype=np.uint8).copy()
    offsets = np.array([0, len(data)], dtype=np.int32)
    h1, h2 = cuda_tier.string_hash_rows(torch.from_numpy(data),
                                        torch.from_numpy(offsets))
    from spark_rapids_tpu_torch.exprs.strings import hash_literal2
    assert hash_literal2("green 中文") == (int(h1[0]), int(h2[0])) == \
        JS.hash_literal2("green 中文")

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)


def _needle_column():
    """Rows built around the needle edge cases, garbage past the end."""
    rows = [b"green", b"xgreen", b"greenx", b"gre", b"en", b"",
            b"abcdeabcde", b"abcd", b"eabcd", b"g" * 16, b"g" * 15,
            b"q" * 70, b"q" * 69, b"zzgreen"]
    offsets = np.zeros(len(rows) + 1, dtype=np.int32)
    np.cumsum([len(r) for r in rows], out=offsets[1:])
    data = np.frombuffer(b"".join(rows) + b"een" + b"q" * 80,
                         dtype=np.uint8).copy()  # garbage past the end
    return data, offsets


# needles of 1, 5, 16 and 70 bytes; "green" matches at a row's first and
# last byte, "gre"+"en" and "abcd"+"e" would span row boundaries, and the
# last row's "green" ends exactly at offsets[-1] before garbage that
# would extend it
NEEDLES = [b"g", b"green", b"g" * 16, b"q" * 70]
MORE_NEEDLES = [b"greene", b"eabcd", b"deab", "é".encode(), b"een"]


def test_rows_with_match_by_row():
    """Every needle against Python's own ``in`` on each row."""
    data, offsets = _needle_column()
    cap = len(offsets) - 1
    rows = [data[offsets[i]:offsets[i + 1]].tobytes() for i in range(cap)]
    for needle in NEEDLES + MORE_NEEDLES:
        got = cuda_tier.rows_with_match(torch.from_numpy(data),
                                        torch.from_numpy(offsets), needle)
        assert got.dtype == torch.bool and got.shape == (cap,)
        np.testing.assert_array_equal(got.numpy(),
                                      [needle in r for r in rows])


@pytest.mark.parametrize("needle", NEEDLES, ids=lambda n: f"len{len(n)}")
def test_rows_with_match_matches_xla_and_pallas(needle):
    data, offsets = _needle_column()
    cap = len(offsets) - 1
    got = cuda_tier.rows_with_match(torch.from_numpy(data),
                                    torch.from_numpy(offsets), needle)
    validity = jnp.ones(cap, jnp.bool_)
    jv = JaxDevVal(JT.STRING, jnp.asarray(data), validity,
                   jnp.asarray(offsets))
    xla = jax.jit(lambda v: JS._rows_with_match(v, needle))(jv)
    for want in (xla,
                 JPS.rows_with_match(jnp.asarray(data), jnp.asarray(offsets),
                                     validity, cap, needle, interpret=True)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax.device_get(want)))


def test_rows_with_match_on_random_column():
    """Past num_rows, garbage past the end, multi-byte needles."""
    data, offsets = string_column(7, 513, 400)
    td, to = torch.from_numpy(data), torch.from_numpy(offsets)
    jv = JaxDevVal(JT.STRING, jnp.asarray(data), jnp.ones(513, jnp.bool_),
                   jnp.asarray(offsets))
    for needle in (b"green", "中".encode(), b"n g", b""):
        want = np.asarray(jax.device_get(
            jax.jit(lambda v: JS._rows_with_match(v, needle))(jv)))
        np.testing.assert_array_equal(
            cuda_tier.rows_with_match(td, to, needle).numpy(), want)


def test_string_wrappers_reject_what_they_cannot_take():
    data, offsets = torch.zeros(16, dtype=torch.uint8), \
        torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_tier.string_hash_rows(data.to(torch.int32), offsets)
    with pytest.raises(ValueError):
        cuda_tier.string_hash_rows(data, offsets.to(torch.int64))
    with pytest.raises(ValueError):
        cuda_tier.rows_with_match(data.reshape(4, 4), offsets, b"a")
    with pytest.raises(ValueError):  # every column is checked
        cuda_tier.string_hash_columns([(data, offsets),
                                       (data, offsets.to(torch.int64))])


# ---------------------------------------------------------------------------
# the LIKE '%green%' query through both packages
# ---------------------------------------------------------------------------

SETTINGS = {"spark.rapids.sql.variableFloatAgg.enabled": True,
            "spark.sql.shuffle.partitions": 1}
BATCH_ROWS = 2048
PART_SF = 2  # 4,000 rows: 2 batches


def part_query(df, F, predicate="like"):
    """Q9's part predicate (``p_name LIKE '%green%'``) with Q16's part
    grouping (``p_brand``, ``p_type``)."""
    cond = df["p_name"].like("%green%") if predicate == "like" else \
        df["p_name"].contains("green")
    return (df
            .filter(cond)
            .group_by("p_brand", "p_type")
            .agg(F.count("*").alias("cnt"),
                 F.avg("p_retailprice").alias("avg_price"),
                 F.min("p_size").alias("min_size"),
                 F.max("p_size").alias("max_size"))
            .order_by("p_brand", "p_type"))


@pytest.fixture(scope="module")
def part_jax():
    """The JAX package's rows, once for this file (its compile is most of
    the file's time)."""
    data = JD.gen_part(PART_SF)
    parts = [JaxHostBatch.from_pydict({
        k: (t, np.asarray(v)[s:s + BATCH_ROWS]) for k, (t, v) in data.items()})
        for s in range(0, len(data["p_partkey"][1]), BATCH_ROWS)]
    sess = TpuSparkSession(JaxConf(SETTINGS))
    df = JaxDataFrame(JaxScan(parts, parts[0].schema, 1), sess).cache()
    return part_query(df, JF).collect()


@pytest.mark.parametrize("predicate", ["like", "contains"])
def test_part_query_matches_jax(part_jax, predicate):
    """``LIKE '%green%'`` plans as a contains test; ``Column.contains``
    takes the same route.  Both give the JAX package's rows in its order,
    float averages bit for bit (sort path on both sides)."""
    parts = host_batches(PD.gen_part(PART_SF), BATCH_ROWS)
    assert len(parts) == 2  # the merge concatenates string partials
    sess = GpuSparkSession(RapidsConf(SETTINGS), device="cpu")
    df = DataFrame(InMemoryScan(parts, parts[0].schema, 1), sess).cache()
    cuda_tier.reset_launch_counts()
    assert part_query(df, PF, predicate).collect() == part_jax
    assert all(cuda_tier.launch_count(n) == 0 for n in cuda_tier.SOURCES)
    assert len(part_jax) > 500
    assert [r[:2] for r in part_jax] == sorted(r[:2] for r in part_jax)


class HashCalls:
    """Counts the stringHash wrapper's calls (and the columns of each)
    while it is active: every row hash of the port goes through
    ``cuda_tier.string_hash_columns``, which makes one launch a call on a
    card."""

    def __init__(self, monkeypatch):
        self.columns = []
        real = cuda_tier.string_hash_columns

        def counted(columns):
            columns = list(columns)
            self.columns.append(len(columns))
            return real(columns)

        monkeypatch.setattr(cuda_tier, "string_hash_columns", counted)


def test_hashing_calls_per_collect(monkeypatch):
    """One hashing call per sort, for all its string keys: Q1 over six
    cached batches makes 8 (six update sorts, the merge, the ORDER BY; the
    group sort's equality test reuses the sort's hashes), the part query
    over two batches 4.  Each call hashes both string keys."""
    calls = HashCalls(monkeypatch)
    sess = GpuSparkSession(RapidsConf(SETTINGS), device="cpu")
    lineitem = host_batches(PD.gen_lineitem(0.2), BATCH_ROWS)
    part = host_batches(PD.gen_part(PART_SF), BATCH_ROWS)
    assert (len(lineitem), len(part)) == (6, 2)
    for parts, query, want in ((lineitem, q1_query, 8),
                               (part, part_query, 4)):
        df = DataFrame(InMemoryScan(parts, parts[0].schema, 1),
                       sess).cache()
        query(df, PF).collect()  # the first collect fills the cache
        calls.columns.clear()
        assert len(query(df, PF).collect()) > 0
        assert calls.columns == [2] * want


def q1_query(df, F):
    """TPC-H Q1 (benchmarks/tpch_like.py Q1)."""
    return (df
            .filter(df["l_shipdate"] <= 10471)
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.sum("l_quantity").alias("sum_qty"),
                 F.count("*").alias("count_order"))
            .order_by("l_returnflag", "l_linestatus"))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(HASH_CASES))
def test_string_kernels_match_plain_versions_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    data, offsets = string_column(len(case), **HASH_CASES[case])
    td, to = torch.from_numpy(data).cuda(), torch.from_numpy(offsets).cuda()
    got = cuda_tier.string_hash_rows(td, to)
    want = cuda_tier.string_hash_rows_reference(td, to)
    for needle in NEEDLES + MORE_NEEDLES:
        assert torch.equal(cuda_tier.rows_with_match(td, to, needle),
                           cuda_tier.rows_with_match_reference(td, to,
                                                               needle))
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_string_hash_columns_match_plain_versions_on_card():
    """Every column in one launch, against the per-column plain version:
    capacities 1, 511 and 16 (the 64 KiB row), an all-empty column and a
    view whose data_ptr() is 3 bytes past a 16-byte boundary."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cols = []
    for name in ("cap1-all-empty", "cap511", "row-64KiB", "cap513"):
        data, offsets = string_column(len(name), **HASH_CASES[name])
        cols.append((torch.from_numpy(data).cuda(),
                     torch.from_numpy(offsets).cuda()))
    data, offsets = cols[-1]
    buf = torch.zeros(data.numel() + 16, dtype=torch.uint8, device="cuda")
    at = (3 - buf.data_ptr()) % 16
    buf[at:at + data.numel()].copy_(data)
    cols.append((buf[at:at + data.numel()], offsets))
    before = cuda_tier.launch_count("stringHash")
    got = cuda_tier.string_hash_columns(cols)
    assert cuda_tier.launch_count("stringHash") - before == 1
    want = cuda_tier.string_hash_columns_reference(cols)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
