"""Data type system, mapped to torch dtypes.

Port of ``spark_rapids_tpu/types.py``: each SQL type carries the torch dtype
of its device buffer (``torch_dtype``) instead of a jnp dtype, plus the numpy
dtype of the host representation.  64-bit types are native in torch, so LONG,
TIMESTAMP and DOUBLE keep their full width on the device without the
process-wide ``jax_enable_x64`` switch the JAX package needs.

Device layout: fixed-width columns are dense ``[capacity]`` tensors; strings
are int32 ``offsets[capacity+1]`` into a flat uint8 byte buffer; an array
column (:class:`ArrayType`, fixed-width elements) rides the same layout,
its flat buffer the elements; every column carries a bool validity mask
(True = valid).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch


class DataType:
    """Base class for SQL data types."""

    #: torch dtype of the primary data buffer on the device.
    torch_dtype: Any = None
    #: numpy dtype of the host representation.
    np_dtype: Any = None

    @property
    def name(self) -> str:
        return type(self).__name__.replace("Type", "").lower()

    def __repr__(self) -> str:
        return self.name

    def __eq__(self, other: object) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self))

    @property
    def is_numeric(self) -> bool:
        return isinstance(self, (IntegralType, FractionalType))

    @property
    def is_integral(self) -> bool:
        return isinstance(self, IntegralType)

    @property
    def is_fractional(self) -> bool:
        return isinstance(self, FractionalType)

    @property
    def is_string(self) -> bool:
        return isinstance(self, StringType)

    @property
    def is_datetime(self) -> bool:
        return isinstance(self, (DateType, TimestampType))

    @property
    def is_array(self) -> bool:
        return False


class NumericType(DataType):
    pass


class IntegralType(NumericType):
    pass


class FractionalType(NumericType):
    pass


class BooleanType(DataType):
    torch_dtype = torch.bool
    np_dtype = np.bool_


class ByteType(IntegralType):
    torch_dtype = torch.int8
    np_dtype = np.int8


class ShortType(IntegralType):
    torch_dtype = torch.int16
    np_dtype = np.int16


class IntegerType(IntegralType):
    torch_dtype = torch.int32
    np_dtype = np.int32


class LongType(IntegralType):
    torch_dtype = torch.int64
    np_dtype = np.int64


class FloatType(FractionalType):
    torch_dtype = torch.float32
    np_dtype = np.float32


class DoubleType(FractionalType):
    torch_dtype = torch.float64
    np_dtype = np.float64


class DateType(DataType):
    """Days since unix epoch, int32."""

    torch_dtype = torch.int32
    np_dtype = np.int32


class TimestampType(DataType):
    """Microseconds since unix epoch, int64, UTC only."""

    torch_dtype = torch.int64
    np_dtype = np.int64


class StringType(DataType):
    """Variable-length UTF-8: offsets int32[n+1] + flat uint8 byte buffer."""

    torch_dtype = torch.uint8
    np_dtype = np.object_  # host keeps python str


class NullType(DataType):
    """Type of an untyped NULL literal."""

    torch_dtype = torch.int32
    np_dtype = np.int32


class ArrayType(DataType):
    """array<element>: on the device a flat element buffer, int32
    ``offsets[capacity+1]`` and the row validity, as strings (which are
    array<byte>).  Elements are fixed-width and never NULL on the device;
    array<string> and element NULLs exist only on the host, whose column
    holds one Python list a row."""

    np_dtype = np.object_

    def __init__(self, element: DataType):
        if element.torch_dtype is None or isinstance(element, ArrayType):
            raise TypeError(f"unsupported array element type: {element}")
        self.element = element
        self.torch_dtype = None if element.is_string else \
            element.torch_dtype

    @property
    def name(self) -> str:
        return f"array<{self.element.name}>"

    def __eq__(self, other) -> bool:
        return isinstance(other, ArrayType) and self.element == other.element

    def __hash__(self) -> int:
        return hash((ArrayType, self.element))

    @property
    def is_array(self) -> bool:
        return True


BOOLEAN = BooleanType()
BYTE = ByteType()
SHORT = ShortType()
INT = IntegerType()
LONG = LongType()
FLOAT = FloatType()
DOUBLE = DoubleType()
DATE = DateType()
TIMESTAMP = TimestampType()
STRING = StringType()
NULL = NullType()

ALL_TYPES = (BOOLEAN, BYTE, SHORT, INT, LONG, FLOAT, DOUBLE, DATE, TIMESTAMP,
             STRING)

_NAME_TO_TYPE = {t.name: t for t in ALL_TYPES}
_NAME_TO_TYPE.update({"int": INT, "bigint": LONG, "smallint": SHORT,
                      "tinyint": BYTE})

# Numeric widening lattice for implicit binary-op promotion (Spark semantics).
_NUMERIC_ORDER = [BYTE, SHORT, INT, LONG, FLOAT, DOUBLE]


def type_from_name(name: str) -> DataType:
    return _NAME_TO_TYPE[name.lower()]


def promote(a: DataType, b: DataType) -> DataType:
    """Common type for a binary numeric operation (wider wins)."""
    if a == b:
        return a
    if isinstance(a, NullType):
        return b
    if isinstance(b, NullType):
        return a
    if a.is_numeric and b.is_numeric:
        return _NUMERIC_ORDER[max(_NUMERIC_ORDER.index(a),
                                  _NUMERIC_ORDER.index(b))]
    if a.is_datetime or b.is_datetime:
        def norm(t: DataType) -> DataType:
            if isinstance(t, DateType):
                return INT
            if isinstance(t, TimestampType):
                return LONG
            return t
        na, nb = norm(a), norm(b)
        if na.is_numeric and nb.is_numeric:
            return promote(na, nb)
    raise TypeError(f"no common type for {a} and {b}")


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True

    def __repr__(self) -> str:
        n = "" if self.nullable else " not null"
        return f"{self.name}: {self.dtype}{n}"


class Schema:
    """Ordered collection of named, typed fields."""

    def __init__(self, fields):
        self.fields: Tuple[Field, ...] = tuple(
            f if isinstance(f, Field) else Field(*f) for f in fields)
        self._index = {f.name: i for i, f in enumerate(self.fields)}
        if len(self._index) != len(self.fields):
            raise ValueError(f"duplicate column names in schema: {self.fields}")

    @property
    def names(self):
        return [f.name for f in self.fields]

    def index_of(self, name: str) -> int:
        return self._index[name]

    def field(self, name: str) -> Field:
        return self.fields[self._index[name]]

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __getitem__(self, i):
        if isinstance(i, str):
            return self.field(i)
        return self.fields[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, Schema) and self.fields == other.fields

    def __hash__(self) -> int:
        return hash(self.fields)

    def __repr__(self) -> str:
        return "Schema(" + ", ".join(repr(f) for f in self.fields) + ")"
