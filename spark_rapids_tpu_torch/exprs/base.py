"""Expression base classes and the evaluation contexts.

Port of ``spark_rapids_tpu/exprs/base.py``: ``gpu_eval`` evaluates an
expression over a :class:`ColumnBatch` into a :class:`DevVal` of dense
tensors; ``cpu_eval``, the host twin the planner falls back to, evaluates it
over a :class:`HostBatch` into a :class:`CpuVal` of numpy arrays, strings
one Python value a row (a string column held as bytes and offsets is
decoded when an expression reads it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import (
    ColumnBatch, DeviceColumn, HostBatch, HostColumn,
)


@dataclasses.dataclass
class DevVal:
    """An evaluated expression on the device: data + validity mask.

    For strings ``data`` is the flat uint8 byte buffer and ``offsets`` the
    int32[cap+1] row offsets; otherwise ``data`` is [cap] of the torch dtype.
    """

    dtype: T.DataType
    data: Any
    validity: Any
    offsets: Any = None

    def to_column(self) -> DeviceColumn:
        return DeviceColumn(self.dtype, self.data, self.validity, self.offsets)

    @staticmethod
    def from_column(col: DeviceColumn) -> "DevVal":
        return DevVal(col.dtype, col.data, col.validity, col.offsets)


@dataclasses.dataclass
class CpuVal:
    """An evaluated expression on the host: numpy values + validity
    (strings: an object array of ``str``)."""

    dtype: T.DataType
    values: np.ndarray
    validity: np.ndarray

    def to_column(self) -> HostColumn:
        return HostColumn(self.dtype, self.values, self.validity)

    @staticmethod
    def from_column(col: HostColumn) -> "CpuVal":
        values = col.string_values() if col.dtype.is_string else col.values
        return CpuVal(col.dtype, values, col.validity)


class CpuEvalCtx:
    """Evaluation context for one host batch.  ``partition_index`` (the
    partition's ordinal) and ``base_row_id`` (the partition's rows before
    this batch) are the nondeterministic expressions' context
    (``exprs/misc.py``); the project and filter execs set them."""

    def __init__(self, batch: HostBatch, partition_index: int = 0,
                 base_row_id: int = 0):
        self.batch = batch
        self.num_rows = batch.num_rows
        self.partition_index = partition_index
        self.base_row_id = base_row_id


class GpuEvalCtx:
    """Evaluation context for one device batch; ``partition_index`` and
    ``base_row_id`` as :class:`CpuEvalCtx`'s, the row id a 0-d int64
    device tensor (a running sum with no host sync), None for 0."""

    def __init__(self, batch: ColumnBatch, partition_index: int = 0,
                 base_row_id: Optional[torch.Tensor] = None):
        self.batch = batch
        self.capacity = batch.capacity
        self.device = batch.device
        self.partition_index = partition_index
        self.base_row_id = base_row_id
        self._row_mask = None

    @property
    def row_mask(self) -> torch.Tensor:
        """bool[cap]: the live rows (position < ``num_rows``), made once."""
        if self._row_mask is None:
            self._row_mask = torch.arange(
                self.capacity, dtype=torch.int32,
                device=self.device) < self.batch.num_rows
        return self._row_mask


def _fp(v) -> str:
    """Encode a value for :meth:`Expression.fingerprint`."""
    if isinstance(v, Expression):
        return v.fingerprint()
    if isinstance(v, SortOrder):
        return f"SO({_fp(v.child)},{v.ascending},{v.nulls_first})"
    if isinstance(v, (str, int, float, bool, type(None))):
        return repr(v)
    if isinstance(v, (T.DataType, T.Schema)):
        return str(v)
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_fp(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ",".join(f"{_fp(k)}:{_fp(x)}" for k, x in sorted(
            v.items(), key=lambda kv: str(kv[0]))) + "}"
    return f"id:{id(v):x}"


class Expression:
    """Declarative expression tree node.

    Subclasses define ``children``, resolve ``dtype``/``nullable`` in
    ``__init__`` and implement ``gpu_eval``.
    """

    children: Tuple["Expression", ...] = ()
    dtype: T.DataType = T.NULL
    nullable: bool = True

    @property
    def name(self) -> str:
        return type(self).__name__

    def __repr__(self) -> str:
        args = ", ".join(repr(c) for c in self.children)
        return f"{self.name}({args})"

    def fingerprint(self) -> str:
        """Structural identity including the attributes that are not
        children (a CASE's branch count, a Like's pattern): the key the SQL
        front end matches group keys and aggregate calls by."""
        parts = [type(self).__name__]
        for k, a in sorted(vars(self).items()):
            if k == "children":
                continue
            parts.append(f"{k}={_fp(a)}")
        kids = ",".join(_fp(c) for c in self.children)
        return f"{'|'.join(parts)}({kids})"

    def with_children(self, children: Sequence["Expression"]) -> "Expression":
        """Rebuild this node with new children (default: positional ctor)."""
        return type(self)(*children)

    def transform_up(self, fn) -> "Expression":
        new_children = [c.transform_up(fn) for c in self.children]
        node = self if all(a is b for a, b in zip(new_children,
                                                   self.children)) \
            else self.with_children(new_children)
        return fn(node)

    def collect(self, pred) -> List["Expression"]:
        out = [self] if pred(self) else []
        for c in self.children:
            out.extend(c.collect(pred))
        return out

    def gpu_eval(self, ctx: GpuEvalCtx) -> DevVal:
        raise NotImplementedError(f"{self.name}.gpu_eval")

    def cpu_eval(self, ctx: CpuEvalCtx) -> CpuVal:
        raise NotImplementedError(f"{self.name}.cpu_eval")

    def gpu_supported(self, conf) -> Optional[str]:
        """None if the port can evaluate this node, else the reason (the
        JAX package's ``tpu_supported`` text).  A node whose device form
        cannot build its result says so itself."""
        return None


class ColumnRef(Expression):
    """Unresolved attribute: refers to an input column by name."""

    def __init__(self, column: str, dtype: T.DataType = T.NULL,
                 nullable: bool = True):
        self.column = column
        self.dtype = dtype
        self.nullable = nullable
        self.children = ()

    def with_children(self, children):
        return self

    @property
    def name(self):
        return f"col({self.column})"

    def __repr__(self):
        return f"`{self.column}`"

    def gpu_supported(self, conf) -> Optional[str]:
        return None

    def gpu_eval(self, ctx: GpuEvalCtx) -> DevVal:
        return DevVal.from_column(ctx.batch.column(self.column))

    def cpu_eval(self, ctx: CpuEvalCtx) -> CpuVal:
        return CpuVal.from_column(
            ctx.batch.columns[ctx.batch.schema.index_of(self.column)])


class BoundRef(Expression):
    """Reference bound to an input ordinal."""

    def __init__(self, ordinal: int, dtype: T.DataType,
                 nullable: bool = True):
        self.ordinal = ordinal
        self.dtype = dtype
        self.nullable = nullable
        self.children = ()

    def with_children(self, children):
        return self

    def __repr__(self):
        return f"input[{self.ordinal}]"

    def gpu_supported(self, conf) -> Optional[str]:
        return None

    def gpu_eval(self, ctx: GpuEvalCtx) -> DevVal:
        return DevVal.from_column(ctx.batch.columns[self.ordinal])

    def cpu_eval(self, ctx: CpuEvalCtx) -> CpuVal:
        return CpuVal.from_column(ctx.batch.columns[self.ordinal])


def infer_literal_type(value: Any) -> T.DataType:
    if value is None:
        return T.NULL
    if isinstance(value, bool):
        return T.BOOLEAN
    if isinstance(value, int):
        return T.INT if -(2 ** 31) <= value < 2 ** 31 else T.LONG
    if isinstance(value, float):
        return T.DOUBLE
    if isinstance(value, str):
        return T.STRING
    raise TypeError(f"cannot infer literal type for {value!r}")


class Literal(Expression):
    def __init__(self, value: Any, dtype: Optional[T.DataType] = None):
        self.value = value
        self.dtype = dtype if dtype is not None else infer_literal_type(value)
        self.nullable = value is None
        self.children = ()

    def with_children(self, children):
        return self

    def __repr__(self):
        return f"lit({self.value!r})"

    def gpu_supported(self, conf) -> Optional[str]:
        return None

    def gpu_eval(self, ctx: GpuEvalCtx) -> DevVal:
        cap, dev = ctx.capacity, ctx.device
        tdt = self.dtype.torch_dtype
        if self.dtype.is_string:
            return self._string_eval(cap, dev)
        if self.value is None:
            return DevVal(self.dtype, torch.zeros(cap, dtype=tdt, device=dev),
                          torch.zeros(cap, dtype=torch.bool, device=dev))
        return DevVal(self.dtype,
                      torch.full((cap,), self.value, dtype=tdt, device=dev),
                      torch.ones(cap, dtype=torch.bool, device=dev))

    def cpu_eval(self, ctx: CpuEvalCtx) -> CpuVal:
        n = ctx.num_rows
        if self.value is None:
            validity = np.zeros(n, dtype=np.bool_)
            if self.dtype.is_string:
                return CpuVal(self.dtype, np.array([""] * n, dtype=object),
                              validity)
            return CpuVal(self.dtype, np.zeros(n, dtype=self.dtype.np_dtype),
                          validity)
        validity = np.ones(n, dtype=np.bool_)
        if self.dtype.is_string:
            return CpuVal(self.dtype,
                          np.array([str(self.value)] * n, dtype=object),
                          validity)
        return CpuVal(self.dtype,
                      np.full(n, self.value, dtype=self.dtype.np_dtype),
                      validity)

    def _string_eval(self, cap: int, dev) -> DevVal:
        """Every row holds the literal: its bytes tiled ``cap`` times
        into a ``cap * len`` byte buffer (16 bytes for NULL)."""
        if self.value is None:
            return DevVal(self.dtype, torch.zeros(16, dtype=torch.uint8,
                                                  device=dev),
                          torch.zeros(cap, dtype=torch.bool, device=dev),
                          torch.zeros(cap + 1, dtype=torch.int32, device=dev))
        raw = str(self.value).encode("utf-8")
        data = torch.zeros(cap * max(len(raw), 1), dtype=torch.uint8,
                           device=dev)
        if raw:
            data[:cap * len(raw)] = torch.frombuffer(
                bytearray(raw), dtype=torch.uint8).to(dev).repeat(cap)
        offsets = torch.arange(cap + 1, dtype=torch.int32,
                               device=dev) * len(raw)
        return DevVal(self.dtype, data,
                      torch.ones(cap, dtype=torch.bool, device=dev), offsets)


class Alias(Expression):
    def __init__(self, child: Expression, alias_name: str):
        self.children = (child,)
        self.alias_name = alias_name
        self.dtype = child.dtype
        self.nullable = child.nullable

    def with_children(self, children):
        return Alias(children[0], self.alias_name)

    def __repr__(self):
        return f"{self.children[0]!r} AS {self.alias_name}"

    def gpu_supported(self, conf) -> Optional[str]:
        return None  # the child answers for itself

    def gpu_eval(self, ctx):
        return self.children[0].gpu_eval(ctx)

    def cpu_eval(self, ctx):
        return self.children[0].cpu_eval(ctx)


@dataclasses.dataclass
class SortOrder:
    """Sort key spec."""

    child: Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None  # default: Spark = nulls first iff asc

    def __post_init__(self):
        if self.nulls_first is None:
            self.nulls_first = self.ascending


def output_name(expr: Expression, ordinal: int) -> str:
    if isinstance(expr, Alias):
        return expr.alias_name
    if isinstance(expr, ColumnRef):
        return expr.column
    return f"_c{ordinal}"


def resolve(expr: Expression, schema: T.Schema) -> Expression:
    """Resolve ColumnRefs against a schema, filling in dtype/nullable, and
    re-deriving result types bottom-up."""

    def rebuild(e: Expression) -> Expression:
        new_children = [rebuild(c) for c in e.children]
        if isinstance(e, ColumnRef):
            f = schema.field(e.column)
            return ColumnRef(e.column, f.dtype, f.nullable)
        if new_children and not all(a is b for a, b in zip(new_children,
                                                            e.children)):
            return e.with_children(new_children)
        return e

    return rebuild(expr)


def bind_references(expr: Expression, schema: T.Schema) -> Expression:
    """Replace resolved ColumnRefs with ordinal BoundRefs."""

    def fn(e: Expression) -> Expression:
        if isinstance(e, ColumnRef):
            f = schema.field(e.column)
            return BoundRef(schema.index_of(e.column), f.dtype, f.nullable)
        return e

    return expr.transform_up(fn)


def promote_dev(a: DevVal, b: DevVal) -> Tuple[DevVal, DevVal, T.DataType]:
    out = T.promote(a.dtype, b.dtype)
    return cast_dev(a, out), cast_dev(b, out), out


def cast_dev(v: DevVal, to: T.DataType) -> DevVal:
    if v.dtype == to:
        return v
    if v.dtype.is_string or to.is_string:
        raise TypeError(f"cannot cast {v.dtype} to {to} on the device")
    return DevVal(to, v.data.to(to.torch_dtype), v.validity)


def promote_cpu(a: CpuVal, b: CpuVal) -> Tuple[CpuVal, CpuVal, T.DataType]:
    out = T.promote(a.dtype, b.dtype)
    return cast_cpu(a, out), cast_cpu(b, out), out


def cast_cpu(v: CpuVal, to: T.DataType) -> CpuVal:
    if v.dtype == to:
        return v
    return CpuVal(to, v.values.astype(to.np_dtype), v.validity)


class UnaryExpression(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)
        self._resolve_type()

    @property
    def child(self) -> Expression:
        return self.children[0]

    def _resolve_type(self):
        self.dtype = self.child.dtype
        self.nullable = self.child.nullable


class BinaryExpression(Expression):
    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)
        self._resolve_type()

    @property
    def left(self) -> Expression:
        return self.children[0]

    @property
    def right(self) -> Expression:
        return self.children[1]

    def _resolve_type(self):
        self.dtype = T.promote(self.left.dtype, self.right.dtype)
        self.nullable = self.left.nullable or self.right.nullable
