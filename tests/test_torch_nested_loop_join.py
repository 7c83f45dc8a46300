"""PyTorch port, residual join conditions and nested-loop joins
(``kernels/join.py``: ``_filter_pairs``, ``hash_join(..., condition)``,
``cross_join``, ``nested_loop_join``, ``nested_loop_join_streamed``;
``kernels/layout.py:row_slices``; ``ops/gpu_exec.py``'s
``GpuNestedLoopJoinExec``) against the JAX package.

The same numpy batches go through both packages' functions, and the
outputs must be equal buffer for buffer, dead lanes included: every join
type, with conditions that read one side and both sides, NULLs in the
condition's columns (a NULL condition drops the pair, so an outer row
whose every match fails comes out NULL-padded).  No float is computed, so
there is no tolerance.  Then the exec through the DataFrame API at a
small ``spark.rapids.sql.nestedLoopJoin.pairCapacity``: several
``nljChunks``, and the rows of one chunk, for every join type.
"""

import numpy as np
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.batch import host_to_device as jax_to_device
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.exprs import base as JB
from spark_rapids_tpu.exprs import predicates as JP
from spark_rapids_tpu.exprs.base import DevVal as JaxDevVal
from spark_rapids_tpu.kernels import join as JJ
from spark_rapids_tpu.kernels import layout as JL
from spark_rapids_tpu.session import TpuSparkSession

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import host_to_device
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exprs import base as PB
from spark_rapids_tpu_torch.exprs import predicates as PP
from spark_rapids_tpu_torch.exprs.base import DevVal
from spark_rapids_tpu_torch.kernels import join as PJ
from spark_rapids_tpu_torch.kernels import layout as PL
from spark_rapids_tpu_torch.session import GpuSparkSession

from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    assert_device_bits, one_torch_thread, port_host_batch,
)
from test_torch_join import PAIR_NAMES, _assert_same, _pick

HOWS = ["inner", "left", "right", "full", "left_semi", "left_anti"]
STRS = ["", "x", "AIR", "été", "p" * 70]
PAIR_CAPACITY = "spark.rapids.sql.nestedLoopJoin.pairCapacity"


def _tables(seed: int, n_left: int, n_right: int, types=JT):
    """(left pydict, right pydict) in one package's ``types``: a join key
    with NULLs and duplicates, an INT and a STRING column with NULLs on
    each side."""
    rng = np.random.RandomState(seed)
    keys = list(range(6))
    left = {"k": (types.LONG, _pick(rng, keys, n_left, 0.1)),
            "a": (types.INT, _pick(rng, list(range(-3, 7)), n_left, 0.2)),
            "s": (types.STRING, _pick(rng, STRS, n_left, 0.2))}
    right = {"k2": (types.LONG, _pick(rng, keys, n_right, 0.1)),
             "b": (types.INT, _pick(rng, list(range(-3, 7)), n_right, 0.2)),
             "t": (types.STRING, _pick(rng, STRS, n_right, 0.2))}
    return left, right


def _condition(name, B, P):
    """One condition built from either package's expression modules."""
    c, lit = B.ColumnRef, B.Literal
    if name == "none":
        return None
    if name == "left-only":
        return P.GreaterThan(c("a"), lit(1))
    if name == "right-only":
        return P.NotEquals(c("t"), lit("x"))
    if name == "both":
        return P.LessThan(c("a"), c("b"))
    if name == "both-strings":
        return P.Or(P.Equals(c("s"), c("t")),
                    P.GreaterThanOrEqual(c("b"), c("a")))
    raise KeyError(name)


CONDITIONS = ["left-only", "right-only", "both", "both-strings"]


def _batches(left, right, lcap, rcap):
    """((jax left, jax right), (port left, port right)) device batches."""
    out = []
    for data, cap in ((left, lcap), (right, rcap)):
        jb = JaxHostBatch.from_pydict(data)
        out.append((jax_to_device(jb, capacity=cap),
                    host_to_device(port_host_batch(jb), "cpu",
                                   capacity=cap)))
    (jl, pl), (jr, pr) = out
    return (jl, jr), (pl, pr)


def _schemas(jl, jr, pl, pr, how):
    """Both packages' output schemas of a join of these batches."""
    if how in ("left_semi", "left_anti"):
        return jl.schema, pl.schema
    return (JT.Schema(list(jl.schema.fields) + list(jr.schema.fields)),
            T.Schema(list(pl.schema.fields) + list(pr.schema.fields)))


def _conditions(name, pl, pr):
    """The JAX condition by name, as its exec hands it over, and the
    port's resolved against the paired schema, as its exec hands it."""
    pcond = _condition(name, PB, PP)
    if pcond is not None:
        pcond = PB.resolve(pcond, T.Schema(list(pl.schema.fields) +
                                           list(pr.schema.fields)))
    return _condition(name, JB, JP), pcond


def _keys(batch, name, dev_val):
    return [dev_val.from_column(batch.column(name))]


@pytest.mark.parametrize("cond", CONDITIONS)
def test_filter_pairs_matches_jax(cond):
    left, right = _tables(1, 40, 24)
    (jl, jr), (pl, pr) = _batches(left, right, 64, 32)
    jcond, pcond = _conditions(cond, pl, pr)
    jpairs = JJ.join_pairs(_keys(jl, "k", JaxDevVal), jl.num_rows,
                           _keys(jr, "k2", JaxDevVal), jr.num_rows)
    ppairs = PJ.join_pairs(_keys(pl, "k", DevVal), pl.num_rows,
                           _keys(pr, "k2", DevVal), pr.num_rows)
    want = JJ._filter_pairs(jl, jr, *jpairs[:3], jcond)
    got = PJ._filter_pairs(pl, pr, *ppairs[:3], pcond)
    _assert_same(want, got, PAIR_NAMES)
    # the condition dropped some pairs and kept some
    assert 0 < int(got[2]) < int(ppairs[2])


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("cond", CONDITIONS)
def test_hash_join_with_condition_matches_jax(how, cond):
    left, right = _tables(2, 40, 24)
    (jl, jr), (pl, pr) = _batches(left, right, 64, 32)
    jcond, pcond = _conditions(cond, pl, pr)
    jsch, psch = _schemas(jl, jr, pl, pr, how)
    want = JJ.hash_join(jl, _keys(jl, "k", JaxDevVal), jr,
                        _keys(jr, "k2", JaxDevVal), how, jsch,
                        condition=jcond)
    got = PJ.hash_join(pl, _keys(pl, "k", DevVal), pr,
                       _keys(pr, "k2", DevVal), how, psch, condition=pcond)
    assert_device_bits(want, got)


@pytest.mark.parametrize("how", HOWS + ["cross"])
@pytest.mark.parametrize("cond", ["none"] + CONDITIONS)
def test_nested_loop_join_matches_jax(how, cond):
    left, right = _tables(3, 14, 9)
    (jl, jr), (pl, pr) = _batches(left, right, 16, 16)
    jcond, pcond = _conditions(cond, pl, pr)
    jsch, psch = _schemas(jl, jr, pl, pr, how)
    want = JJ.nested_loop_join(jl, jr, how, jcond, jsch)
    got = PJ.nested_loop_join(pl, pr, how, pcond, psch)
    assert_device_bits(want, got)


@pytest.mark.parametrize("sizes", [(0, 5), (6, 0), (0, 0)],
                         ids=["empty-left", "empty-right", "both-empty"])
@pytest.mark.parametrize("how", ["inner", "left", "full", "left_anti"])
def test_nested_loop_join_empty_side_matches_jax(sizes, how):
    left, right = _tables(4, *sizes)
    (jl, jr), (pl, pr) = _batches(left, right, 8, 8)
    jcond, pcond = _conditions("both", pl, pr)
    jsch, psch = _schemas(jl, jr, pl, pr, how)
    assert_device_bits(JJ.nested_loop_join(jl, jr, how, jcond, jsch),
                       PJ.nested_loop_join(pl, pr, how, pcond, psch))


def test_cross_join_matches_jax():
    left, right = _tables(5, 7, 5)
    (jl, jr), (pl, pr) = _batches(left, right, 8, 8)
    jsch, psch = _schemas(jl, jr, pl, pr, "cross")
    got = PJ.cross_join(pl, pr, psch)
    assert_device_bits(JJ.cross_join(jl, jr, jsch), got)
    assert int(got.num_rows) == 35


def test_row_slices_match_jax():
    left, _ = _tables(6, 37, 1)
    (jl, _), (pl, _) = _batches(left, left, 64, 64)
    want = list(JL.row_slices(jl, 37, 8))
    got = list(PL.row_slices(pl, 37, 8))
    assert len(got) == len(want) == 5
    for w, g in zip(want, got):
        assert_device_bits(w, g)


@pytest.mark.parametrize("how", ["right", "full"])
@pytest.mark.parametrize("cond", ["none", "both", "both-strings"])
def test_nested_loop_join_streamed_matches_jax(how, cond):
    """Left slices of 4 rows against the whole right side, then the right
    rows no slice matched."""
    left, right = _tables(7, 14, 9)
    (jl, jr), (pl, pr) = _batches(left, right, 16, 16)
    jcond, pcond = _conditions(cond, pl, pr)
    jsch, psch = _schemas(jl, jr, pl, pr, how)
    jempty = jax_to_device(JaxHostBatch.from_pydict(
        {k: (t, []) for k, (t, _) in left.items()}))
    pempty = host_to_device(port_host_batch(JaxHostBatch.from_pydict(
        {k: (t, []) for k, (t, _) in left.items()})), "cpu")
    want = list(JJ.nested_loop_join_streamed(
        JL.row_slices(jl, 14, 4), jempty, jr, how, jcond, jsch))
    got = list(PJ.nested_loop_join_streamed(
        PL.row_slices(pl, 14, 4), pempty, pr, how, pcond, psch))
    assert len(got) == len(want) == 5
    for w, g in zip(want, got):
        assert_device_bits(w, g)


# -- the exec ----------------------------------------------------------------


def _join_df(sess, how, types, seed=8):
    left, right = _tables(seed, 30, 11, types)
    ldf = sess.create_dataframe(left, num_partitions=2)
    rdf = sess.create_dataframe(right)
    if how == "cross":
        return ldf.cross_join(rdf)
    # no equality between the sides: a nested-loop join
    return ldf.join(rdf, on=(ldf["a"] < rdf["b"]) | (ldf["s"] == rdf["t"]),
                    how=how)


def _sorted(rows):
    return sorted(rows, key=repr)


@pytest.fixture(scope="module")
def jax_exec_rows():
    sess = TpuSparkSession(JaxConf({}))
    return {how: _sorted(_join_df(sess, how, JT).collect())
            for how in HOWS + ["cross"]}


@pytest.mark.parametrize("how", HOWS + ["cross"])
def test_nested_loop_join_exec_chunked_matches_one_chunk(jax_exec_rows,
                                                         how):
    """At 64 pair slots the 15-row left batches (30 rows in 2 partitions)
    against 11 right rows go in slices of 5 rows; the right and full
    joins slice the whole left side.  The rows equal those of one chunk
    and the JAX package's."""
    whole = GpuSparkSession(RapidsConf({}), device="cpu")
    one = _sorted(_join_df(whole, how, T).collect())
    assert "nljChunks" not in whole.last_metrics
    assert "NestedLoopJoin" in whole.last_physical_plan.tree_string()
    sliced = GpuSparkSession(RapidsConf({PAIR_CAPACITY: 64}), device="cpu")
    rows = _sorted(_join_df(sliced, how, T).collect())
    chunks = sliced.last_metrics["nljChunks"]
    assert chunks == 6, chunks
    assert rows == one
    assert rows == jax_exec_rows[how]


@pytest.mark.parametrize("keyed", [True, False], ids=["hash", "nested-loop"])
def test_unported_condition_is_refused(keyed):
    """A condition expression the device path cannot run (a string
    ordering) puts the join on the host, with or without keys: its explain
    line names the expression, the plan holds the host join, and the rows
    equal the JAX package's at the same settings, which places the join
    on its host too (same rows in the same order)."""
    def join(sess, types):
        left, right = _tables(9, 6, 4, types)
        ldf, rdf = sess.create_dataframe(left), sess.create_dataframe(right)
        cond = ldf["s"] < rdf["t"]
        if keyed:
            cond = (ldf["k"] == rdf["k2"]) & cond
        return ldf.join(rdf, on=cond, how="left")

    sess = GpuSparkSession(RapidsConf({}), device="cpu")
    got = join(sess, T).collect()
    assert "!Join cannot run on GPU because expression LessThan: string " \
        "comparisons are not ported yet" in sess.last_explain
    exe = "CpuHashJoin" if keyed else "CpuNestedLoopJoin"
    assert exe in sess.last_physical_plan.tree_string()
    assert got == join(TpuSparkSession(JaxConf({})), JT).collect()
    assert len(got) >= 6
