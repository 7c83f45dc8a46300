"""PyTorch port, the time and formatting expressions
(``exprs/datetime.py``), the bitwise ones (``exprs/bitwise.py``) and the
array functions with float normalization (``exprs/misc.py``) against the
JAX package on the same inputs.

Each expression runs four ways, as in ``test_torch_string_builders.py``:
both packages' device forms (the JAX package's on jax's CPU backend, the
port's on CPU tensors) and both host twins.  Integers, strings, masks and
offsets are held bit for bit; floats are held equal where valid, NaN to
NaN (``assert_array_equal``), which also takes -0.0 for 0.0: the minimum
of -0.0 and 0.0 is either one in both packages' segment reductions.
Inputs: dates before 1970 and leap days, negative seconds and
microseconds, shift counts past the width and negative, INT64_MIN, NaN,
-0.0 and infinities in arrays, empty and NULL arrays, rows past
``num_rows``.
"""

import datetime as _dt
import math

import jax
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import HostBatch as JaxHostBatch
from spark_rapids_tpu.batch import host_to_device as jax_h2d
from spark_rapids_tpu.config import RapidsConf as JaxConf
from spark_rapids_tpu.exprs import base as JB
from spark_rapids_tpu.exprs import bitwise as JBW
from spark_rapids_tpu.exprs import datetime as JD
from spark_rapids_tpu.exprs import misc as JM
from spark_rapids_tpu.kernels import layout as JL
from spark_rapids_tpu.plan.overrides import ExprMeta as JaxExprMeta

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import HostBatch
from spark_rapids_tpu_torch.batch import host_to_device
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exprs import base as PB
from spark_rapids_tpu_torch.exprs import bitwise as PBW
from spark_rapids_tpu_torch.exprs import datetime as PD
from spark_rapids_tpu_torch.exprs import misc as PM
from spark_rapids_tpu_torch.kernels import layout as PL
from spark_rapids_tpu_torch.plan.overrides import ExprMeta

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

EPOCH = _dt.date(1970, 1, 1)
DATES = ["1970-01-01", "1969-12-31", "2000-02-29", "1900-02-28",
         "1600-03-01", "2024-02-29", "2023-12-31", "1999-01-31",
         "2100-02-28", "1583-10-15", "9999-12-31", "0001-01-01"]
NAN = float("nan")
INF = float("inf")


def _days(s):
    return (_dt.date.fromisoformat(s) - EPOCH).days


def _table():
    rng = np.random.RandomState(7)
    n = 48
    days = [_days(d) for d in DATES] + \
        [int(x) for x in rng.randint(-150_000, 60_000, n - len(DATES))]
    days[5] = None
    micros = [None if d is None else d * 86_400_000_000 + int(x)
              for d, x in zip(days, rng.randint(0, 86_400_000_000, n))]
    micros[1] = -1  # one microsecond before the epoch
    secs = [None if m is None else m // 1_000_000 for m in micros]
    i = [int(x) for x in rng.randint(-2 ** 31, 2 ** 31, n)]
    i[:6] = [0, -1, 1, 2 ** 31 - 1, -2 ** 31, None]
    j = [int(x) for x in rng.randint(-2 ** 31, 2 ** 31, n)]
    lng = [int(x) for x in rng.randint(-2 ** 63, 2 ** 63 - 1, n,
                                       dtype=np.int64)]
    lng[:4] = [-(2 ** 63), 2 ** 63 - 1, -1, 0]
    k = [int(x) for x in rng.randint(-70, 140, n)]
    k[:8] = [0, 1, 31, 32, 63, 64, -1, None]
    strs = DATES[:6] + ["2023-02-29", "bad", "2024-1-05", None,
                        "2024-13-01", ""] + \
        [(EPOCH + _dt.timedelta(days=int(x))).isoformat()
         for x in rng.randint(-100_000, 40_000, n - 12)]
    d = [float(x) for x in rng.randn(n)]
    d[:6] = [0.0, -0.0, NAN, INF, -INF, None]
    arrs = [[1.5, NAN, -0.0], [], None, [0.0, -0.0], [NAN, NAN], [INF, -INF],
            [2.5, 2.5, 1.0]] + \
        [[float(x) for x in rng.randint(-3, 4, rng.randint(0, 6))]
         for _ in range(n - 7)]
    iarrs = [[3, -(2 ** 63), 2 ** 63 - 1], [], None, [3, 3, 1], [0]] + \
        [[int(x) for x in rng.randint(-5, 6, rng.randint(0, 6))]
         for _ in range(n - 5)]
    return {"dt": ("DATE", days), "ts": ("TIMESTAMP", micros),
            "sec": ("LONG", secs), "i": ("INT", i), "j": ("INT", j),
            "l": ("LONG", lng), "k": ("INT", k), "ds": ("STRING", strs),
            "d": ("DOUBLE", d), "a": (("DOUBLE",), arrs),
            "ai": (("LONG",), iarrs)}


def _types(mod, tname):
    if isinstance(tname, tuple):
        return mod.ArrayType(getattr(mod, tname[0]))
    return getattr(mod, tname)


def _batches():
    data = _table()
    jb = JaxHostBatch.from_pydict({k: (_types(JT, t), v)
                                   for k, (t, v) in data.items()})
    pb = HostBatch.from_pydict({k: (_types(T, t), v)
                                for k, (t, v) in data.items()})
    return jb, pb


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(jax.device_get(x))


def _run(make, num_rows=None):
    """((JAX device, JAX host), (port device, port host), port node) of
    ``make(modules, ColumnRef, Literal)``."""
    jb, pb = _batches()
    jdev, pdev = jax_h2d(jb), host_to_device(pb, "cpu")
    if num_rows is not None:
        jdev, pdev = JL.take_head(jdev, num_rows), PL.take_head(pdev,
                                                                 num_rows)
    jmods = {"D": JD, "B": JBW, "M": JM}
    pmods = {"D": PD, "B": PBW, "M": PM}
    je = JB.resolve(make(jmods, JB.ColumnRef, JB.Literal), jb.schema)
    pe = PB.resolve(make(pmods, PB.ColumnRef, PB.Literal), pb.schema)
    jd = je.tpu_eval(JB.TpuEvalCtx(jdev))
    pd = pe.gpu_eval(PB.GpuEvalCtx(pdev))
    jh = je.cpu_eval(JB.CpuEvalCtx(jb))
    ph = pe.cpu_eval(PB.CpuEvalCtx(pb))
    return (jd, jh), (pd, ph), pe


def assert_same_device(jd, pd):
    jv, pv = _np(jd.validity), _np(pd.validity)
    np.testing.assert_array_equal(pv, jv)
    jdat, pdat = _np(jd.data), _np(pd.data)
    assert pdat.dtype == jdat.dtype
    if jd.offsets is None:
        np.testing.assert_array_equal(pdat[pv], jdat[jv])
        return
    jo, po = _np(jd.offsets), _np(pd.offsets)
    np.testing.assert_array_equal(po, jo)
    total = int(po[-1])
    np.testing.assert_array_equal(pdat[:total], jdat[:total])


def _same(a, b) -> bool:
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


def assert_same_host(jh, ph):
    np.testing.assert_array_equal(ph.validity, jh.validity)
    ok = np.asarray(ph.validity)
    got, want = np.asarray(ph.values)[ok], np.asarray(jh.values)[ok]
    if got.dtype == object:
        assert all(_same(g, w) for g, w in zip(got, want)), (got, want)
    else:
        np.testing.assert_array_equal(got, want)


DEVICE_CASES = {
    "hour": lambda m, c, l: m["D"].Hour(c("ts")),
    "minute": lambda m, c, l: m["D"].Minute(c("ts")),
    "second": lambda m, c, l: m["D"].Second(c("ts")),
    "last-day": lambda m, c, l: m["D"].LastDay(c("dt")),
    "unix-timestamp-date": lambda m, c, l: m["D"].UnixTimestamp(c("dt")),
    "unix-timestamp-ts": lambda m, c, l: m["D"].UnixTimestamp(c("ts")),
    "to-unix-timestamp": lambda m, c, l: m["D"].ToUnixTimestamp(c("ts")),
    "from-unixtime": lambda m, c, l: m["D"].FromUnixTime(c("sec")),
    "time-add": lambda m, c, l: m["D"].TimeAdd(c("ts"), 18_000_000_007),
    "time-add-negative": lambda m, c, l: m["D"].TimeAdd(c("ts"),
                                                        -86_400_000_001),
    "date-format-date": lambda m, c, l: m["D"].DateFormat(c("dt")),
    "date-format-ts": lambda m, c, l: m["D"].DateFormat(c("ts")),
    "and": lambda m, c, l: m["B"].BitwiseAnd(c("i"), c("j")),
    "or": lambda m, c, l: m["B"].BitwiseOr(c("i"), c("j")),
    "xor-promoted": lambda m, c, l: m["B"].BitwiseXor(c("i"), c("l")),
    "and-literal": lambda m, c, l: m["B"].BitwiseAnd(c("l"), l(7)),
    "not-int": lambda m, c, l: m["B"].BitwiseNot(c("i")),
    "not-long": lambda m, c, l: m["B"].BitwiseNot(c("l")),
    "shl-int": lambda m, c, l: m["B"].ShiftLeft(c("i"), c("k")),
    "shl-long": lambda m, c, l: m["B"].ShiftLeft(c("l"), c("k")),
    "shr-int": lambda m, c, l: m["B"].ShiftRight(c("i"), c("k")),
    "shr-long": lambda m, c, l: m["B"].ShiftRight(c("l"), c("k")),
    "ushr-int": lambda m, c, l: m["B"].ShiftRightUnsigned(c("i"), c("k")),
    "ushr-long": lambda m, c, l: m["B"].ShiftRightUnsigned(c("l"), c("k")),
    "normalize": lambda m, c, l: m["M"].KnownFloatingPointNormalized(
        c("d")),
    "get-item-0": lambda m, c, l: m["M"].GetArrayItem(c("a"), 0),
    "get-item-2": lambda m, c, l: m["M"].GetArrayItem(c("ai"), 2),
    "get-item-negative": lambda m, c, l: m["M"].GetArrayItem(c("a"), -1),
    "size": lambda m, c, l: m["M"].ArraySize(c("a")),
    "contains": lambda m, c, l: m["M"].ArrayContains(c("a"), 2.5),
    "contains-nan": lambda m, c, l: m["M"].ArrayContains(c("a"), NAN),
    "contains-zero": lambda m, c, l: m["M"].ArrayContains(c("a"), 0.0),
    "contains-long": lambda m, c, l: m["M"].ArrayContains(c("ai"), 3),
    "array-min": lambda m, c, l: m["M"].ArrayMin(c("a")),
    "array-max": lambda m, c, l: m["M"].ArrayMax(c("a")),
    "array-min-long": lambda m, c, l: m["M"].ArrayMin(c("ai")),
    "array-max-long": lambda m, c, l: m["M"].ArrayMax(c("ai")),
    "sort-asc": lambda m, c, l: m["M"].SortArray(c("a")),
    "sort-desc": lambda m, c, l: m["M"].SortArray(c("a"), False),
    "sort-long-desc": lambda m, c, l: m["M"].SortArray(c("ai"), False),
    "position-nan": lambda m, c, l: m["M"].ArrayPosition(c("a"), NAN),
    "position-long": lambda m, c, l: m["M"].ArrayPosition(c("ai"), 3),
    "created-array": lambda m, c, l: m["M"].ArrayMax(m["M"].CreateArray(
        c("j"), c("k"), l(5))),
    "created-sort-item": lambda m, c, l: m["M"].GetArrayItem(
        m["M"].SortArray(m["M"].CreateArray(c("j"), c("k"), l(5))), 0),
}


@pytest.mark.parametrize("case", list(DEVICE_CASES))
@pytest.mark.parametrize("num_rows", [None, 40], ids=["all", "head"])
def test_expression_matches_jax(case, num_rows):
    (jd, jh), (pd, ph), _ = _run(DEVICE_CASES[case], num_rows)
    assert_same_device(jd, pd)
    assert_same_host(jh, ph)


@pytest.mark.parametrize("case", ["from-unixtime", "date-format-date",
                                  "date-format-ts"])
def test_formatted_strings_are_fixed_width(case):
    """The device's fixed-width strings: 19 or 10 bytes a live valid row,
    offsets constant past ``num_rows``, 0 past the live total; the rows
    read back as the host twin's (years 1000 on: ``strftime`` pads no
    shorter year)."""
    (_, _), (pd, ph), _ = _run(DEVICE_CASES[case], num_rows=40)
    off = pd.offsets.numpy()
    lens = np.diff(off)
    valid = pd.validity.numpy()
    width = 19 if case == "from-unixtime" else 10
    assert set(lens[:40][valid[:40]]) == {width}
    assert not lens[40:].any() and not lens[:40][~valid[:40]].any()
    assert not pd.data.numpy()[off[-1]:].any()
    raw = pd.data.numpy().tobytes()
    for r in range(40):
        if valid[r] and ph.values[r][:4] >= "1000":
            assert raw[off[r]:off[r + 1]].decode() == ph.values[r]


HOST_CASES = {
    "unix-timestamp-string": lambda m, c, l: m["D"].UnixTimestamp(c("ds")),
    "from-unixtime-format": lambda m, c, l: m["D"].FromUnixTime(
        c("sec"), "yyyy/MM/dd"),
    "date-format-other": lambda m, c, l: m["D"].DateFormat(c("dt"),
                                                           "dd/MM/yyyy"),
    "and-double": lambda m, c, l: m["B"].BitwiseAnd(c("i"), c("d")),
    "shift-double": lambda m, c, l: m["B"].ShiftLeft(c("d"), c("k")),
    "not-double": lambda m, c, l: m["B"].BitwiseNot(c("d")),
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_placement_and_twin_match_jax(case):
    """Formats, string parsing and non-integral bitwise inputs stay on the
    host in both packages, with the JAX package's reason (TPU read as
    GPU); where the twin runs (not the bitwise ones over a DOUBLE, which
    numpy refuses), it gives the JAX twin's rows."""
    jb, pb = _batches()
    make = HOST_CASES[case]
    je = JB.resolve(make({"D": JD, "B": JBW, "M": JM}, JB.ColumnRef,
                         JB.Literal), jb.schema)
    pe = PB.resolve(make({"D": PD, "B": PBW, "M": PM}, PB.ColumnRef,
                         PB.Literal), pb.schema)
    want = [r.replace("TPU", "GPU")
            for r in JaxExprMeta(je, JaxConf({})).reasons]
    assert ExprMeta(pe, RapidsConf({})).reasons == want and want
    if case in ("unix-timestamp-string", "from-unixtime-format",
                "date-format-other"):
        assert_same_host(je.cpu_eval(JB.CpuEvalCtx(jb)),
                         pe.cpu_eval(PB.CpuEvalCtx(pb)))


@pytest.mark.parametrize("case", list(DEVICE_CASES))
def test_device_placement_matches_jax(case):
    jb, pb = _batches()
    make = DEVICE_CASES[case]
    je = JB.resolve(make({"D": JD, "B": JBW, "M": JM}, JB.ColumnRef,
                         JB.Literal), jb.schema)
    pe = PB.resolve(make({"D": PD, "B": PBW, "M": PM}, PB.ColumnRef,
                         PB.Literal), pb.schema)
    want = JaxExprMeta(je, JaxConf({})).reasons
    got = ExprMeta(pe, RapidsConf({})).reasons
    # array() over nullable columns: on the host in both packages
    assert bool(got) == bool(want) == case.startswith("created-")


@pytest.mark.parametrize("part,want", [
    ("Year", lambda d: d.year), ("Month", lambda d: d.month),
    ("DayOfMonth", lambda d: d.day), ("LastDay", None)])
def test_date_parts_of_a_string_parse_it(part, want):
    """A date part (and ``last_day``, ``date_add``) of a string reads it as
    ``yyyy-MM-dd``, on the device as on the host; a row that does not
    parse (Feb 29 of 2023, a one-digit month, month 13, '') is NULL.
    Both packages place the node on their device; the JAX package's
    device form reads the string's bytes as day numbers (ROADMAP,
    differences of design), so this holds the port to Python's
    calendar."""
    jb, pb = _batches()
    strs = _table()["ds"][1]
    e = PB.resolve(getattr(PD, part)(PB.ColumnRef("ds")), pb.schema)
    je = JB.resolve(getattr(JD, part)(JB.ColumnRef("ds")), jb.schema)
    assert ExprMeta(e, RapidsConf({})).reasons == []
    assert JaxExprMeta(je, JaxConf({})).reasons == []
    dev = e.gpu_eval(PB.GpuEvalCtx(host_to_device(pb, "cpu")))
    host = e.cpu_eval(PB.CpuEvalCtx(pb))
    for r, s in enumerate(strs):
        try:
            d = _dt.date.fromisoformat(s) if s and len(s) == 10 else None
        except ValueError:
            d = None
        assert bool(dev.validity[r]) == (d is not None) == host.validity[r]
        if d is None:
            continue
        if want is None:
            nxt = _dt.date(d.year + d.month // 12, d.month % 12 + 1, 1)
            expect = (nxt - _dt.timedelta(days=1) - EPOCH).days
        else:
            expect = want(d)
        assert int(dev.data[r]) == expect == int(host.values[r])
    add = PB.resolve(PD.DateAdd(PB.ColumnRef("ds"), PB.ColumnRef("k")),
                     pb.schema)
    got = add.gpu_eval(PB.GpuEvalCtx(host_to_device(pb, "cpu")))
    host = add.cpu_eval(PB.CpuEvalCtx(pb))
    ok = host.validity
    np.testing.assert_array_equal(got.validity.numpy()[:len(ok)], ok)
    np.testing.assert_array_equal(got.data.numpy()[:len(ok)][ok],
                                  host.values[ok])


def test_array_needle_type_is_checked_like_jax():
    jb, pb = _batches()
    for mod, b, batch in ((JM, JB, jb), (PM, PB, pb)):
        e = b.resolve(mod.ArrayContains(b.ColumnRef("ai"), 1.5),
                      batch.schema)
        with pytest.raises(TypeError, match="no implicit narrowing"):
            e.cpu_eval(b.CpuEvalCtx(batch))
        with pytest.raises(ValueError):
            mod.ArrayPosition(b.ColumnRef("ai"), None)
