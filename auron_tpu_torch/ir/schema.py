"""Logical data types, fields and schemas (counterpart of
auron_tpu/ir/schema.py).

The full `TypeId` enum is kept so that every type name on the wire
decodes.  The port's device layer handles the flat types it maps to a
torch dtype (`torch_dtype`): bool, int8/16/32/64, float64, date32 as
int32 days and timestamp as int64 microseconds, the JAX package's
physical types; and string and binary, whose device layout is the
padded byte matrix of columnar/batch.py (`DeviceStringColumn`), so they
have no torch dtype of their own.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Tuple

import torch


class TypeId(enum.IntEnum):
    NULL = 0
    BOOL = 1
    INT8 = 2
    INT16 = 3
    INT32 = 4
    INT64 = 5
    FLOAT32 = 6
    FLOAT64 = 7
    DECIMAL = 8
    STRING = 9
    BINARY = 10
    DATE32 = 11
    TIMESTAMP_US = 12
    LIST = 13
    MAP = 14
    STRUCT = 15


_INTEGRAL = {TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64}

_TORCH_DTYPES = {
    TypeId.BOOL: torch.bool,
    TypeId.INT8: torch.int8,
    TypeId.INT16: torch.int16,
    TypeId.INT32: torch.int32,
    TypeId.INT64: torch.int64,
    TypeId.FLOAT64: torch.float64,
    TypeId.DATE32: torch.int32,
    TypeId.TIMESTAMP_US: torch.int64,
}


@dataclass(frozen=True)
class DataType:
    id: TypeId
    precision: int = 0            # DECIMAL only
    scale: int = 0                # DECIMAL only
    children: Tuple["Field", ...] = ()

    @staticmethod
    def null() -> "DataType": return DataType(TypeId.NULL)
    @staticmethod
    def bool_() -> "DataType": return DataType(TypeId.BOOL)
    @staticmethod
    def int8() -> "DataType": return DataType(TypeId.INT8)
    @staticmethod
    def int16() -> "DataType": return DataType(TypeId.INT16)
    @staticmethod
    def int32() -> "DataType": return DataType(TypeId.INT32)
    @staticmethod
    def int64() -> "DataType": return DataType(TypeId.INT64)
    @staticmethod
    def float32() -> "DataType": return DataType(TypeId.FLOAT32)
    @staticmethod
    def float64() -> "DataType": return DataType(TypeId.FLOAT64)
    @staticmethod
    def decimal(precision: int, scale: int) -> "DataType":
        return DataType(TypeId.DECIMAL, precision=precision, scale=scale)
    @staticmethod
    def date32() -> "DataType": return DataType(TypeId.DATE32)
    @staticmethod
    def timestamp_us() -> "DataType": return DataType(TypeId.TIMESTAMP_US)
    @staticmethod
    def string() -> "DataType": return DataType(TypeId.STRING)
    @staticmethod
    def binary() -> "DataType": return DataType(TypeId.BINARY)
    @staticmethod
    def list_(value: "DataType") -> "DataType":
        return DataType(TypeId.LIST, children=(Field("item", value),))
    @staticmethod
    def map_(key: "DataType", value: "DataType") -> "DataType":
        return DataType(TypeId.MAP, children=(Field("key", key, nullable=False),
                                              Field("value", value)))
    @staticmethod
    def struct(fields: Tuple["Field", ...]) -> "DataType":
        return DataType(TypeId.STRUCT, children=tuple(fields))

    @property
    def is_integral(self) -> bool: return self.id in _INTEGRAL
    @property
    def is_floating(self) -> bool:
        return self.id in (TypeId.FLOAT32, TypeId.FLOAT64)
    @property
    def is_decimal(self) -> bool: return self.id == TypeId.DECIMAL
    @property
    def is_stringlike(self) -> bool:
        return self.id in (TypeId.STRING, TypeId.BINARY)

    def torch_dtype(self) -> torch.dtype:
        """The device dtype of a flat column of this type (a string type
        raises: its column is a byte matrix and lengths)."""
        if self.id not in _TORCH_DTYPES:
            raise TypeError(f"type {self!r} has no device layout in "
                            f"auron_tpu_torch yet")
        return _TORCH_DTYPES[self.id]

    def __repr__(self) -> str:
        if self.id == TypeId.DECIMAL:
            return f"decimal({self.precision},{self.scale})"
        return self.id.name.lower()


def is_flat_type(dtype: DataType) -> bool:
    """Whether a column of this type has a flat device layout here."""
    return dtype.id in _TORCH_DTYPES


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True


@dataclass(frozen=True)
class Schema:
    fields: Tuple[Field, ...]

    def __post_init__(self):
        object.__setattr__(self, "fields", tuple(self.fields))

    @staticmethod
    def of(*fields: Field) -> "Schema":
        return Schema(tuple(fields))

    def __len__(self) -> int: return len(self.fields)
    def __iter__(self): return iter(self.fields)
    def __getitem__(self, i: int) -> Field: return self.fields[i]

    def index_of(self, name: str) -> int:
        """Column resolution, case-insensitive like the JAX package's
        default (`auron.case.sensitive` = false)."""
        for i, f in enumerate(self.fields):
            if f.name == name or f.name.lower() == name.lower():
                return i
        raise KeyError(name)

    def field(self, name: str) -> Field:
        return self.fields[self.index_of(name)]

    def names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.fields)

    def rename(self, names) -> "Schema":
        return Schema(tuple(Field(n, f.dtype, f.nullable)
                            for n, f in zip(names, self.fields)))

    def select(self, indices) -> "Schema":
        return Schema(tuple(self.fields[i] for i in indices))

    def concat(self, other: "Schema") -> "Schema":
        return Schema(self.fields + other.fields)
