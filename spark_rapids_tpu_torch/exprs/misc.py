"""Nondeterministic expressions, arrays and float normalization (port of
``spark_rapids_tpu/exprs/misc.py``): ``monotonically_increasing_id``,
``spark_partition_id``, ``rand``, ``array``, ``getItem``, ``size``,
``array_contains``, ``array_min``, ``array_max``, ``sort_array``,
``array_position`` and ``KnownFloatingPointNormalized``.

The nondeterministic three read the evaluation context's
``partition_index`` and ``base_row_id``, which the project and filter
execs set per partition and batch (the JAX package leaves both at 0):
``monotonically_increasing_id`` is ``(partition << 33) + row``, unique over
batches and partitions; ``rand(seed)`` on the device gives the JAX device
form's bits for the same context: threefry-2x32 (written out in int64
words, as murmur3 is) keyed by ``seed + 1000003 * (partition + 1)``, the
row id folded in, 64 random bits a row made a double in [0, 1); on the
host the JAX twin's ``RandomState`` stream.

``array(e1, ..., ek)`` gives each row a k-element array.  On the device
the elements ride the varlen layout (``batch.py``): a flat ``[cap * k]``
buffer, row-major, with offsets ``r * k`` clamped at the live rows' total,
so they stay constant past ``num_rows``.  Element NULLs have no device
layout: an array of nullable inputs, or of strings, is built on the host,
one list a row.  The functions over arrays work on that layout: each
element slot finds its row with ``rows_of_positions`` (slots past
``offsets[-1]`` are padding), then a segment reduction by row (min, max,
the first match) or one stable sort by (row, value).  Spark orders NaN
above every value: ``array_min`` skips NaNs unless a row holds only NaNs,
``array_max`` is NaN where a row holds one, ``sort_array`` puts them last
(first descending), and ``array_contains``/``array_position`` find a NaN
needle.  The host twins are the JAX package's, one list a row.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import element_value
from spark_rapids_tpu_torch.exprs.base import (
    CpuVal, DevVal, Expression, Literal, UnaryExpression, cast_cpu,
)
from spark_rapids_tpu_torch.kernels import cuda_tier

_M32 = 0xFFFFFFFF


class _Nondeterministic(Expression):
    """A leaf whose value depends on the row's partition and position."""

    nondeterministic = True
    children = ()
    nullable = False

    def with_children(self, children):
        return self

    def gpu_supported(self, conf):
        return None


class MonotonicallyIncreasingID(_Nondeterministic):
    """(partition_id << 33) + row offset within partition."""

    dtype = T.LONG

    def gpu_eval(self, ctx) -> DevVal:
        data = torch.arange(ctx.capacity, dtype=torch.int64,
                            device=ctx.device) + (ctx.partition_index << 33)
        if ctx.base_row_id is not None:
            data = data + ctx.base_row_id
        return DevVal(T.LONG, data, torch.ones(ctx.capacity, dtype=torch.bool,
                                               device=ctx.device))

    def cpu_eval(self, ctx) -> CpuVal:
        base = (np.int64(ctx.partition_index) << np.int64(33)) + \
            np.int64(ctx.base_row_id)
        return CpuVal(T.LONG, base + np.arange(ctx.num_rows, dtype=np.int64),
                      np.ones(ctx.num_rows, dtype=np.bool_))


class SparkPartitionID(_Nondeterministic):
    dtype = T.INT

    def gpu_eval(self, ctx) -> DevVal:
        return DevVal(T.INT, torch.full((ctx.capacity,), ctx.partition_index,
                                        dtype=torch.int32, device=ctx.device),
                      torch.ones(ctx.capacity, dtype=torch.bool,
                                 device=ctx.device))

    def cpu_eval(self, ctx) -> CpuVal:
        return CpuVal(T.INT, np.full(ctx.num_rows, ctx.partition_index,
                                     dtype=np.int32),
                      np.ones(ctx.num_rows, dtype=np.bool_))


_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    """jax's threefry-2x32 hash (``prng._threefry2x32_lowering``) over u32
    values held in int64 (tensors or ints): 20 rounds of add, rotate, xor,
    with the key schedule injected every four."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M32
    x1 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def rand_uniform(seed: int, partition_index: int, base_row_id, cap: int,
                 device) -> torch.Tensor:
    """float64[cap]: the JAX device form of ``rand(seed)``,
    ``uniform(fold_in(PRNGKey(seed + 1000003 * (partition + 1)),
    uint32(base_row_id)), (cap,), float64)`` under jax's partitionable
    threefry: the key is the int64 seed's two halves; ``fold_in`` hashes
    the count (0, row id); row i's 64 bits hash (0, i), of which the top
    52 become the mantissa of a double in [1, 2), minus 1.  ``base_row_id``
    is a 0-d int64 tensor or an int."""
    s = (seed + 1000003 * (partition_index + 1)) & 0xFFFFFFFFFFFFFFFF
    if isinstance(base_row_id, torch.Tensor):
        row = base_row_id.reshape(()).to(torch.int64) & _M32
    else:
        row = torch.full((), int(base_row_id) & _M32, dtype=torch.int64,
                         device=device)
    k1, k2 = threefry2x32(s >> 32, s & _M32, torch.zeros_like(row), row)
    iota = torch.arange(cap, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(iota), iota)
    mantissa = (b1 << 20) | (b2 >> 12)
    return (mantissa | 0x3FF0000000000000).view(torch.float64) - 1.0


class Rand(_Nondeterministic):
    """Uniform [0, 1) a row; on the device jax's threefry stream for the
    (seed, partition, base row id) context, on the host the JAX twin's
    ``RandomState`` stream (the two differ, in both packages)."""

    dtype = T.DOUBLE

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def gpu_eval(self, ctx) -> DevVal:
        base = ctx.base_row_id if ctx.base_row_id is not None else 0
        return DevVal(T.DOUBLE, rand_uniform(self.seed, ctx.partition_index,
                                             base, ctx.capacity, ctx.device),
                      torch.ones(ctx.capacity, dtype=torch.bool,
                                 device=ctx.device))

    def cpu_eval(self, ctx) -> CpuVal:
        rng = np.random.RandomState(
            (self.seed + 1000003 * (ctx.partition_index + 1)
             + 31 * int(ctx.base_row_id)) % (2 ** 31))
        return CpuVal(T.DOUBLE, rng.uniform(size=ctx.num_rows),
                      np.ones(ctx.num_rows, dtype=np.bool_))


def is_nondeterministic(e: Expression) -> bool:
    """Whether ``e`` reads the partition and row context."""
    return bool(e.collect(lambda x: getattr(x, "nondeterministic", False)))


class CreateArray(Expression):
    """array(e1, e2, ...) -> array<the inputs' common type>, never NULL."""

    def __init__(self, *children: Expression):
        if not children:
            raise ValueError("array() needs at least one element")
        elem = children[0].dtype
        for c in children[1:]:
            elem = T.promote(elem, c.dtype)
        self.children = tuple(children)
        self.dtype = T.ArrayType(elem)
        self.nullable = False

    def with_children(self, children):
        return CreateArray(*children)

    def gpu_supported(self, conf):
        if self.dtype.element.is_string:
            return ("CreateArray: array<string> has variable-length "
                    "elements, which only the host holds")
        if any(c.nullable for c in self.children):
            return ("CreateArray: nullable inputs can make NULL elements, "
                    "which only the host holds")
        return None

    def gpu_eval(self, ctx) -> DevVal:
        elem = self.dtype.element
        k = len(self.children)
        cap = ctx.capacity
        vals = [c.gpu_eval(ctx).data.to(elem.torch_dtype)
                for c in self.children]
        data = torch.stack(vals, dim=1).reshape(-1)  # row-major [cap * k]
        total = ctx.batch.num_rows.to(torch.int32) * k
        offsets = torch.minimum(
            torch.arange(cap + 1, dtype=torch.int32, device=ctx.device) * k,
            total)
        return DevVal(self.dtype, data,
                      torch.ones(cap, dtype=torch.bool, device=ctx.device),
                      offsets)

    def cpu_eval(self, ctx) -> CpuVal:
        elem = self.dtype.element
        n = ctx.num_rows
        vals = [cast_cpu(c.cpu_eval(ctx), elem) if not elem.is_string
                else c.cpu_eval(ctx) for c in self.children]
        cols = [[None if not ok else element_value(elem, x)
                 for x, ok in zip(v.values, v.validity)] for v in vals]
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = [c[i] for c in cols]
        return CpuVal(self.dtype, out, np.ones(n, dtype=np.bool_))



class KnownFloatingPointNormalized(UnaryExpression):
    """-0.0 becomes 0.0 and every NaN the canonical NaN (float keys)."""

    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        data = torch.where(v.data == 0, torch.zeros_like(v.data), v.data)
        data = torch.where(torch.isnan(data),
                           torch.full_like(data, float("nan")), data)
        return DevVal(v.dtype, data, v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        data = np.where(v.values == 0, np.zeros_like(v.values), v.values)
        data = np.where(np.isnan(data), np.full_like(data, np.nan), data)
        return CpuVal(v.dtype, data, v.validity)


def _not_array(e: Expression, what: str):
    if not isinstance(e.dtype, T.ArrayType):
        return f"{what} needs an array, got {e.dtype}"
    if e.dtype.element.is_string:
        return "array<string> is host-only"
    return None


def _slots(v: DevVal, cap: int):
    """(rows, in_range): each element slot's row, clamped into the
    capacity, and whether the slot holds a live element."""
    nelem = int(v.data.shape[0])
    rows = cuda_tier.rows_of_positions(v.offsets, nelem)
    in_range = torch.arange(nelem, dtype=torch.int32,
                            device=rows.device) < v.offsets[-1]
    return rows.clamp(0, cap - 1).long(), in_range


def _host_isnan(value) -> bool:
    return isinstance(value, float) and value != value


def _needle_eq(e, needle) -> bool:
    """Array membership's equality (Spark's ordering equivalence): NaN
    equals NaN."""
    if _host_isnan(needle):
        return isinstance(e, float) and e != e
    return e == needle


def _check_array_needle(elem_dt: T.DataType, value) -> None:
    """A needle whose Python type does not match the element type is
    refused (a narrowing cast would differ between the two sides)."""
    if elem_dt.is_string:
        ok = isinstance(value, str)
    elif elem_dt == T.BOOLEAN:
        ok = isinstance(value, bool)
    elif elem_dt.is_integral:
        ok = isinstance(value, int) and not isinstance(value, bool)
    else:
        ok = isinstance(value, (int, float)) and not isinstance(value, bool)
    if not ok:
        raise TypeError(f"needle {value!r} does not match array element "
                        f"type {elem_dt} (no implicit narrowing)")


def _literal_needle(value, what: str) -> Literal:
    if isinstance(value, Expression) and not isinstance(value, Literal):
        raise NotImplementedError(f"{what} needs a literal needle")
    if not isinstance(value, Literal):
        value = Literal(value)
    if value.value is None:
        raise ValueError(f"{what} value must not be NULL")
    return value


def _hits(v: DevVal, elem_dt: T.DataType, value, in_range):
    """bool[slots]: live slots equal to the needle (NaN finds NaN)."""
    if elem_dt.is_fractional and _host_isnan(value):
        return in_range & torch.isnan(v.data)
    needle = torch.tensor(value, dtype=elem_dt.torch_dtype,
                          device=v.data.device)
    return in_range & (v.data == needle)


class GetArrayItem(Expression):
    """arr[i] with a literal 0-based ordinal: NULL out of range, for a
    negative ordinal and for a NULL array."""

    def __init__(self, child: Expression, ordinal: int):
        self.children = (child,)
        self.ordinal = int(ordinal)
        self.dtype = child.dtype.element \
            if isinstance(child.dtype, T.ArrayType) else T.NULL
        self.nullable = True

    def with_children(self, children):
        return GetArrayItem(children[0], self.ordinal)

    def gpu_supported(self, conf):
        if not isinstance(self.children[0].dtype, T.ArrayType):
            return f"getItem needs an array, got {self.children[0].dtype}"
        return None

    def gpu_eval(self, ctx) -> DevVal:
        v = self.children[0].gpu_eval(ctx)
        cap, tdt = ctx.capacity, self.dtype.torch_dtype
        if self.ordinal < 0:
            return DevVal(self.dtype,
                          torch.zeros(cap, dtype=tdt, device=ctx.device),
                          torch.zeros(cap, dtype=torch.bool,
                                      device=ctx.device))
        lens = v.offsets[1:] - v.offsets[:-1]
        in_range = self.ordinal < lens
        idx = (v.offsets[:-1] + self.ordinal).clamp(
            0, int(v.data.shape[0]) - 1).long()
        data = torch.where(in_range, v.data[idx], 0).to(tdt)
        return DevVal(self.dtype, data, v.validity & in_range & ctx.row_mask)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.children[0].cpu_eval(ctx)
        n = len(v.values)
        out = np.zeros(n, dtype=self.dtype.np_dtype)
        ok = np.zeros(n, dtype=np.bool_)
        k = self.ordinal
        for i, (arr, valid) in enumerate(zip(v.values, v.validity)):
            if valid and arr is not None and 0 <= k < len(arr) and \
                    arr[k] is not None:
                out[i] = arr[k]
                ok[i] = True
        return CpuVal(self.dtype, out, ok)


class ArraySize(UnaryExpression):
    """size(arr) -> INT; NULL for a NULL array (Spark with
    ``spark.sql.legacy.sizeOfNull`` false, as in the JAX package)."""

    def _resolve_type(self):
        self.dtype = T.INT
        self.nullable = self.child.nullable

    def gpu_supported(self, conf):
        if not isinstance(self.child.dtype, T.ArrayType):
            return f"size needs an array, got {self.child.dtype}"
        return None

    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        return DevVal(T.INT, (v.offsets[1:] - v.offsets[:-1])
                      .to(torch.int32), v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        out = np.fromiter((len(a) if ok and a is not None else 0
                           for a, ok in zip(v.values, v.validity)),
                          dtype=np.int32, count=len(v.values))
        return CpuVal(T.INT, out, v.validity)


class ArrayContains(Expression):
    """array_contains(arr, literal) -> BOOLEAN; NULL for a NULL array, and
    on the host where a row has NULL elements and no match."""

    def __init__(self, child: Expression, value):
        value = _literal_needle(value, "array_contains")
        self.children = (child, value)
        self.dtype = T.BOOLEAN
        self.nullable = True

    def with_children(self, children):
        return ArrayContains(children[0], children[1])

    def gpu_supported(self, conf):
        r = _not_array(self.children[0], "array_contains")
        if r:
            return r
        _check_array_needle(self.children[0].dtype.element,
                            self.children[1].value)
        return None

    def gpu_eval(self, ctx) -> DevVal:
        v = self.children[0].gpu_eval(ctx)
        elem_dt = self.children[0].dtype.element
        value = self.children[1].value
        _check_array_needle(elem_dt, value)
        rows, in_range = _slots(v, ctx.capacity)
        hit = _hits(v, elem_dt, value, in_range).to(torch.int32)
        n = torch.zeros(ctx.capacity, dtype=torch.int32,
                        device=ctx.device).index_add_(0, rows, hit)
        return DevVal(T.BOOLEAN, n > 0, v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.children[0].cpu_eval(ctx)
        dt = self.children[0].dtype
        if isinstance(dt, T.ArrayType):
            _check_array_needle(dt.element, self.children[1].value)
        needle = self.children[1].value
        n = len(v.values)
        out = np.zeros(n, dtype=np.bool_)
        valid = np.array(v.validity, dtype=np.bool_)
        for i, (arr, ok) in enumerate(zip(v.values, v.validity)):
            if not (ok and arr is not None):
                continue
            hit = any(e is not None and _needle_eq(e, needle) for e in arr)
            out[i] = hit
            if not hit and any(e is None for e in arr):
                valid[i] = False
        return CpuVal(T.BOOLEAN, out, valid)


class _ArrayMinMax(UnaryExpression):
    """array_min / array_max: NULL for an empty or NULL array."""

    _is_min = True

    def _resolve_type(self):
        dt = self.child.dtype
        self.dtype = dt.element if isinstance(dt, T.ArrayType) else T.NULL
        self.nullable = True

    def gpu_supported(self, conf):
        return _not_array(self.child, self.name)

    def _identity(self):
        if self.dtype.is_fractional:
            return float("inf") if self._is_min else float("-inf")
        if self.dtype == T.BOOLEAN:
            return 1 if self._is_min else 0
        info = torch.iinfo(self.dtype.torch_dtype)
        return info.max if self._is_min else info.min

    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        cap, dev = ctx.capacity, ctx.device
        rows, in_range = _slots(v, cap)
        # booleans reduce as int8
        rdt = torch.int8 if self.dtype == T.BOOLEAN else \
            self.dtype.torch_dtype
        ident = self._identity()
        x = torch.where(in_range, v.data.to(rdt), ident)
        how = "amin" if self._is_min else "amax"
        if self.dtype.is_fractional:
            is_nan = in_range & torch.isnan(x)
            x = torch.where(is_nan, ident, x)
            nan_n = torch.zeros(cap, dtype=torch.int32, device=dev) \
                .index_add_(0, rows, is_nan.to(torch.int32))
            num_n = torch.zeros(cap, dtype=torch.int32, device=dev) \
                .index_add_(0, rows, (in_range & ~is_nan).to(torch.int32))
        out = torch.full((cap,), ident, dtype=rdt, device=dev) \
            .scatter_reduce_(0, rows, x, how, include_self=True)
        if self.dtype.is_fractional:
            nan_row = (num_n == 0) & (nan_n > 0) if self._is_min else \
                nan_n > 0
            out = torch.where(nan_row, float("nan"), out)
        lens = (v.offsets[1:] - v.offsets[:-1]) > 0
        return DevVal(self.dtype, out.to(self.dtype.torch_dtype),
                      v.validity & lens)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        n = len(v.values)
        out = np.zeros(n, dtype=self.dtype.np_dtype)
        valid = np.zeros(n, dtype=np.bool_)
        frac = self.dtype.is_fractional
        for i, (arr, ok) in enumerate(zip(v.values, v.validity)):
            if not (ok and arr):
                continue
            vals = [e for e in arr if e is not None]
            if not vals:
                continue
            valid[i] = True
            if frac:
                nn = [e for e in vals if e == e]
                if self._is_min:
                    out[i] = min(nn) if nn else float("nan")
                else:
                    out[i] = float("nan") if len(nn) < len(vals) \
                        else max(vals)
            else:
                out[i] = min(vals) if self._is_min else max(vals)
        return CpuVal(self.dtype, out, valid)


class ArrayMin(_ArrayMinMax):
    _is_min = True


class ArrayMax(_ArrayMinMax):
    _is_min = False


class SortArray(UnaryExpression):
    """sort_array(arr[, asc]): each row's elements sorted, by one stable
    sort of the flat slots by (row, value, NaN rank); offsets and
    validity unchanged.  Padding slots sort after every row (their row
    is the capacity itself)."""

    def __init__(self, child: Expression, ascending: bool = True):
        self.ascending = bool(ascending)
        super().__init__(child)

    def with_children(self, children):
        return SortArray(children[0], self.ascending)

    def _resolve_type(self):
        self.dtype = self.child.dtype
        self.nullable = self.child.nullable

    def gpu_supported(self, conf):
        return _not_array(self.child, "sort_array")

    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        nelem = int(v.data.shape[0])
        rows = cuda_tier.rows_of_positions(v.offsets, nelem).long()
        in_range = rows < ctx.capacity
        elem_dt = self.child.dtype.element
        if elem_dt.is_fractional:
            x = v.data.to(torch.float64)
            is_nan = torch.isnan(x)
            rk = torch.where(is_nan, float("inf"), x)
            if not self.ascending:
                rk = -rk
            # NaN after +inf ascending, before -(+inf) descending
            tie = torch.where(is_nan, 1 if self.ascending else -1, 0)
        else:
            rk = v.data.to(torch.int64)
            if not self.ascending:
                rk = ~rk  # a monotone flip with no INT64_MIN wrap
            tie = torch.zeros_like(rows)
        rk = torch.where(in_range, rk, 0)
        tie = torch.where(in_range, tie, 2)
        order = torch.arange(nelem, device=rows.device)
        for key in (tie, rk, rows):   # least significant first, stable
            idx = torch.sort(key[order], stable=True).indices
            order = order[idx]
        return DevVal(self.dtype, v.data[order], v.validity, v.offsets)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        out = np.empty(len(v.values), dtype=object)
        for i, (arr, ok) in enumerate(zip(v.values, v.validity)):
            if not ok or arr is None:
                out[i] = None
                continue
            nn = [e for e in arr if e is not None]
            nulls = [None] * (len(arr) - len(nn))
            key = (lambda e: (e != e, e)) if any(
                isinstance(e, float) for e in nn) else (lambda e: e)
            srt = sorted(nn, key=key, reverse=not self.ascending)
            # NULL elements first ascending, last descending (Spark)
            out[i] = nulls + srt if self.ascending else srt + nulls
        return CpuVal(self.dtype, out, v.validity)


class ArrayPosition(Expression):
    """array_position(arr, literal) -> LONG: the 1-based index of the
    first match, 0 where there is none, NULL for a NULL array."""

    def __init__(self, child: Expression, value):
        value = _literal_needle(value, "array_position")
        self.children = (child, value)
        self.dtype = T.LONG
        self.nullable = child.nullable

    def with_children(self, children):
        return ArrayPosition(children[0], children[1])

    def gpu_supported(self, conf):
        r = _not_array(self.children[0], "array_position")
        if r:
            return r
        _check_array_needle(self.children[0].dtype.element,
                            self.children[1].value)
        return None

    def gpu_eval(self, ctx) -> DevVal:
        v = self.children[0].gpu_eval(ctx)
        cap = ctx.capacity
        elem_dt = self.children[0].dtype.element
        value = self.children[1].value
        _check_array_needle(elem_dt, value)
        rows, in_range = _slots(v, cap)
        hit = _hits(v, elem_dt, value, in_range)
        pos = torch.arange(int(v.data.shape[0]), dtype=torch.int32,
                           device=ctx.device)
        big = 1 << 30
        first = torch.full((cap,), big, dtype=torch.int32,
                           device=ctx.device).scatter_reduce_(
            0, rows, torch.where(hit, pos, big), "amin", include_self=True)
        idx = torch.where(first < big, first - v.offsets[:-1] + 1, 0)
        return DevVal(T.LONG, idx.to(torch.int64), v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.children[0].cpu_eval(ctx)
        dt = self.children[0].dtype
        if isinstance(dt, T.ArrayType):
            _check_array_needle(dt.element, self.children[1].value)
        needle = self.children[1].value
        out = np.zeros(len(v.values), dtype=np.int64)
        for i, (arr, ok) in enumerate(zip(v.values, v.validity)):
            if ok and arr is not None:
                for j, e in enumerate(arr):
                    if e is not None and _needle_eq(e, needle):
                        out[i] = j + 1
                        break
        return CpuVal(T.LONG, out, v.validity)
