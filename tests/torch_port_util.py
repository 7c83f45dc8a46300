"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
the same numpy inputs go through the JAX package and through the port."""

import jax
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.batch import _string_host_to_buffers

from spark_rapids_tpu_torch.interop import host_batch_from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port's CPU ops on one thread in the importing test module.
    The suite's workers share the machine's cores; torch's intra-op
    threads, one per core in every worker, then spin-wait against each
    other and a query's small ops take seconds instead of milliseconds."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_host_batch(jb: JaxHostBatch):
    """The port's HostBatch over the numpy arrays of a JAX HostBatch."""
    fields = [(f.name, f.dtype.name) for f in jb.schema.fields]
    cols = []
    for c in jb.columns:
        if c.dtype.is_string:
            offsets, data = _string_host_to_buffers(c.values, c.validity)
            cols.append((data, c.validity, offsets))
        else:
            cols.append((c.values, c.validity))
    return host_batch_from_numpy(fields, cols)


def assert_device_bits(jax_batch, port_batch):
    """Raw device buffers equal: same dtypes, same bytes, dead lanes too."""
    assert int(jax.device_get(jax_batch.num_rows)) == \
        int(port_batch.num_rows)
    assert jax_batch.capacity == port_batch.capacity
    for jc, pc in zip(jax_batch.columns, port_batch.columns):
        for field in ("data", "validity", "offsets"):
            jv, pv = getattr(jc, field), getattr(pc, field)
            assert (jv is None) == (pv is None), field
            if jv is not None:
                jn, pn = np.asarray(jax.device_get(jv)), pv.cpu().numpy()
                assert jn.dtype == pn.dtype, field
                np.testing.assert_array_equal(jn, pn, err_msg=field)


def headline_data(rng: np.random.RandomState, rows: int):
    """One batch of bench.py's headline table (bench.py:make_data)."""
    return {
        "ss_item_sk": (JT.INT, rng.randint(0, 2000, rows)),
        "ss_promo_sk": (JT.INT, rng.randint(0, 3, rows)),
        "ss_quantity": (JT.INT, rng.randint(1, 101, rows)),
        "ss_sales_price": (JT.DOUBLE, (rng.rand(rows) * 200).round(2)),
        "ss_ext_discount_amt": (JT.DOUBLE, (rng.rand(rows) * 100).round(2)),
    }


def headline_query(df, F):
    """bench.py:build_query after cache(), in either package's API."""
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


def plan_shape(op):
    """A physical plan as nested (exec, children) tokens, either
    package's: the class name without its package prefix, plus what tells
    two execs of one class apart (host execs keep their ``Cpu`` prefix;
    the transitions are ``HostToDevice``/``DeviceToHost``; an exchange
    names its partitioning, a window exec its functions, an expand its
    number of projections)."""
    name = type(op).__name__
    tok = name.replace("Tpu", "").replace("Gpu", "").replace("Exec", "")
    if tok.endswith("ShuffleExchange"):
        tok += "/" + type(op.partitioning).__name__
    if "HashJoin" in tok:
        tok += f"/{op.how}/{getattr(op, 'broadcast_side', '')}"
    if tok.endswith("NestedLoopJoin"):
        tok += f"/{op.how}"
    if tok == "HashAggregate":
        tok += "/" + op.mode
    if tok.endswith("Window"):
        tok += "/" + ",".join(type(w.function).__name__
                              for w in op.window_exprs)
    if tok.endswith("Expand"):
        tok += f"/{len(op.projections)}"
    return (tok, tuple(plan_shape(c) for c in op.children))


#: the host execs either package's test mode allows
#: (``spark.rapids.sql.test.enabled``): scans, transitions, host exchanges
TEST_MODE_HOST = ("HostToDeviceExec", "CpuInMemoryScanExec",
                  "CpuFileScanExec", "FileScanV2Exec", "DeviceToHostExec",
                  "CpuShuffleExchangeExec")


def host_execs(op):
    """The class names of the host execs in either package's physical
    plan that the test mode would refuse, in plan order (pre-order)."""
    on_device = getattr(op, "is_gpu", False) or getattr(op, "is_tpu", False)
    name = type(op).__name__
    out = [] if on_device or name in TEST_MODE_HOST else [name]
    for c in op.children:
        out.extend(host_execs(c))
    return out
