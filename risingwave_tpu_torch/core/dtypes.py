"""SQL data type system.

TPU-native re-design of the reference's type layer
(`src/common/src/types/mod.rs:120` — `DataType`). Instead of one Rust enum with
per-type array impls, types here carry (a) a numpy dtype for the exact host
path, (b) a JAX dtype for the device path, and (c) SQL semantics metadata
(nullability is carried per-column via validity bitmaps, not in the type).

Fixed-width types live on device; VARCHAR/DECIMAL keep exact host
representations and enter the device as 64-bit hashes / scaled ints when used
as keys (see `risingwave_tpu/core/chunk.py`).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np


class TypeKind(enum.Enum):
    BOOLEAN = "boolean"
    INT16 = "smallint"
    INT32 = "int"
    INT64 = "bigint"
    FLOAT32 = "real"
    FLOAT64 = "double precision"
    DECIMAL = "numeric"
    DATE = "date"
    TIME = "time"
    TIMESTAMP = "timestamp"      # microseconds since epoch, no tz
    TIMESTAMPTZ = "timestamptz"  # microseconds since epoch, UTC
    INTERVAL = "interval"        # months:i32, days:i32, usecs:i64 packed
    VARCHAR = "varchar"
    BYTEA = "bytea"
    STRUCT = "struct"
    LIST = "list"
    MAP = "map"
    JSONB = "jsonb"
    SERIAL = "serial"
    INT256 = "rw_int256"


# numpy dtype for the exact host-side column representation.
_NP_DTYPES = {
    TypeKind.BOOLEAN: np.dtype(np.bool_),
    TypeKind.INT16: np.dtype(np.int16),
    TypeKind.INT32: np.dtype(np.int32),
    TypeKind.INT64: np.dtype(np.int64),
    TypeKind.FLOAT32: np.dtype(np.float32),
    TypeKind.FLOAT64: np.dtype(np.float64),
    TypeKind.DECIMAL: np.dtype(object),      # decimal.Decimal scalars
    TypeKind.DATE: np.dtype(np.int32),       # days since 1970-01-01
    TypeKind.TIME: np.dtype(np.int64),       # usecs since midnight
    TypeKind.TIMESTAMP: np.dtype(np.int64),  # usecs since epoch
    TypeKind.TIMESTAMPTZ: np.dtype(np.int64),
    TypeKind.INTERVAL: np.dtype(object),     # Interval scalars
    TypeKind.VARCHAR: np.dtype(object),      # python str
    TypeKind.BYTEA: np.dtype(object),        # python bytes
    TypeKind.STRUCT: np.dtype(object),
    TypeKind.LIST: np.dtype(object),
    TypeKind.MAP: np.dtype(object),
    TypeKind.JSONB: np.dtype(object),
    TypeKind.SERIAL: np.dtype(np.int64),
    TypeKind.INT256: np.dtype(object),
}

# JAX/device dtype; None => host-only type (enters device as hash64/scaled repr).
_DEVICE_DTYPES = {
    TypeKind.BOOLEAN: np.dtype(np.bool_),
    TypeKind.INT16: np.dtype(np.int16),
    TypeKind.INT32: np.dtype(np.int32),
    TypeKind.INT64: np.dtype(np.int64),
    TypeKind.FLOAT32: np.dtype(np.float32),
    TypeKind.FLOAT64: np.dtype(np.float64),
    TypeKind.DATE: np.dtype(np.int32),
    TypeKind.TIME: np.dtype(np.int64),
    TypeKind.TIMESTAMP: np.dtype(np.int64),
    TypeKind.TIMESTAMPTZ: np.dtype(np.int64),
    TypeKind.SERIAL: np.dtype(np.int64),
}


@dataclass(frozen=True)
class DataType:
    """A SQL data type. Compare with `DataType` in the reference
    (`src/common/src/types/mod.rs:120`)."""

    kind: TypeKind
    # DECIMAL precision/scale (None = unconstrained, Postgres-style).
    precision: Optional[int] = None
    scale: Optional[int] = None
    # STRUCT fields / LIST element / MAP key+value.
    fields: Tuple[Tuple[str, "DataType"], ...] = field(default_factory=tuple)
    elem: Optional["DataType"] = None

    # ---- classification ----
    @property
    def np_dtype(self) -> np.dtype:
        return _NP_DTYPES[self.kind]

    @property
    def device_dtype(self) -> Optional[np.dtype]:
        return _DEVICE_DTYPES.get(self.kind)

    @property
    def is_numeric(self) -> bool:
        return self.kind in (
            TypeKind.INT16, TypeKind.INT32, TypeKind.INT64,
            TypeKind.FLOAT32, TypeKind.FLOAT64, TypeKind.DECIMAL,
            TypeKind.SERIAL, TypeKind.INT256,
        )

    @property
    def is_integral(self) -> bool:
        return self.kind in (TypeKind.INT16, TypeKind.INT32, TypeKind.INT64,
                             TypeKind.SERIAL)

    @property
    def is_fixed_width(self) -> bool:
        return self.kind in _DEVICE_DTYPES

    def sql_name(self) -> str:
        return self.kind.value

    def __str__(self) -> str:  # pragma: no cover - debug aid
        return self.sql_name()


# Singleton-ish constructors for the common types.
BOOLEAN = DataType(TypeKind.BOOLEAN)
INT16 = DataType(TypeKind.INT16)
INT32 = DataType(TypeKind.INT32)
INT64 = DataType(TypeKind.INT64)
FLOAT32 = DataType(TypeKind.FLOAT32)
FLOAT64 = DataType(TypeKind.FLOAT64)
DECIMAL = DataType(TypeKind.DECIMAL)
DATE = DataType(TypeKind.DATE)
TIME = DataType(TypeKind.TIME)
TIMESTAMP = DataType(TypeKind.TIMESTAMP)
TIMESTAMPTZ = DataType(TypeKind.TIMESTAMPTZ)
INTERVAL = DataType(TypeKind.INTERVAL)
VARCHAR = DataType(TypeKind.VARCHAR)
BYTEA = DataType(TypeKind.BYTEA)
JSONB = DataType(TypeKind.JSONB)
SERIAL = DataType(TypeKind.SERIAL)


def struct_of(*fields: Tuple[str, DataType]) -> DataType:
    return DataType(TypeKind.STRUCT, fields=tuple(fields))


def list_of(elem: DataType) -> DataType:
    return DataType(TypeKind.LIST, elem=elem)


_SQL_NAME_TO_TYPE = {
    "boolean": BOOLEAN, "bool": BOOLEAN,
    "smallint": INT16, "int2": INT16,
    "int": INT32, "integer": INT32, "int4": INT32,
    "bigint": INT64, "int8": INT64,
    "real": FLOAT32, "float4": FLOAT32,
    "double precision": FLOAT64, "double": FLOAT64, "float8": FLOAT64,
    "float": FLOAT64,
    "numeric": DECIMAL, "decimal": DECIMAL,
    "date": DATE,
    "time": TIME, "time without time zone": TIME,
    "timestamp": TIMESTAMP, "timestamp without time zone": TIMESTAMP,
    "timestamptz": TIMESTAMPTZ, "timestamp with time zone": TIMESTAMPTZ,
    "interval": INTERVAL,
    "varchar": VARCHAR, "text": VARCHAR, "string": VARCHAR,
    "character varying": VARCHAR,
    "bytea": BYTEA,
    "jsonb": JSONB,
    "serial": SERIAL,
}


def type_from_sql_name(name: str) -> DataType:
    key = " ".join(name.strip().lower().split())
    # strip parenthesized precision e.g. varchar(30), numeric(10,2)
    if "(" in key:
        base, rest = key.split("(", 1)
        base = base.strip()
        if base in ("numeric", "decimal"):
            args = rest.rstrip(")").split(",")
            prec = int(args[0])
            scale = int(args[1]) if len(args) > 1 else 0
            return DataType(TypeKind.DECIMAL, precision=prec, scale=scale)
        key = base
    t = _SQL_NAME_TO_TYPE.get(key)
    if t is None:
        raise ValueError(f"unknown SQL type: {name!r}")
    return t


@dataclass(frozen=True)
class Interval:
    """Postgres interval: months, days, microseconds — mirrors the reference's
    `Interval` (`src/common/src/types/interval.rs`)."""
    months: int = 0
    days: int = 0
    usecs: int = 0

    def total_usecs_approx(self) -> int:
        """Exact only when months == 0; used for window arithmetic where the
        reference also requires day/usec intervals."""
        return ((self.months * 30 + self.days) * 86_400_000_000) + self.usecs

    def __add__(self, other: "Interval") -> "Interval":
        return Interval(self.months + other.months, self.days + other.days,
                        self.usecs + other.usecs)

    def __str__(self) -> str:
        parts = []
        if self.months:
            parts.append(f"{self.months} mons")
        if self.days:
            parts.append(f"{self.days} days")
        if self.usecs or not parts:
            secs = self.usecs / 1_000_000
            parts.append(f"{secs:g} secs")
        return " ".join(parts)


def parse_interval(text: str) -> Interval:
    """Parse a small useful subset of Postgres interval syntax:
    '2 seconds', '10 minutes', '1 hour', '1 day', '3 months', '00:00:10'."""
    s = text.strip().lower()
    if ":" in s and not any(c.isalpha() for c in s):
        hh, mm, *rest = s.split(":")
        ss = float(rest[0]) if rest else 0.0
        usecs = int((int(hh) * 3600 + int(mm) * 60) * 1_000_000 + ss * 1_000_000)
        return Interval(usecs=usecs)
    tokens = s.split()
    if len(tokens) % 2 != 0:
        raise ValueError(f"cannot parse interval: {text!r}")
    months = days = usecs = 0
    unit_usecs = {
        "microsecond": 1, "microseconds": 1,
        "millisecond": 1_000, "milliseconds": 1_000,
        "second": 1_000_000, "seconds": 1_000_000, "sec": 1_000_000, "secs": 1_000_000,
        "minute": 60_000_000, "minutes": 60_000_000, "min": 60_000_000, "mins": 60_000_000,
        "hour": 3_600_000_000, "hours": 3_600_000_000,
    }
    for qty, unit in zip(tokens[::2], tokens[1::2]):
        n = float(qty)
        if unit in unit_usecs:
            usecs += int(n * unit_usecs[unit])
        elif unit in ("day", "days"):
            days += int(n)
        elif unit in ("week", "weeks"):
            days += int(n) * 7
        elif unit in ("month", "months", "mon", "mons"):
            months += int(n)
        elif unit in ("year", "years"):
            months += int(n) * 12
        else:
            raise ValueError(f"unknown interval unit {unit!r} in {text!r}")
    return Interval(months=months, days=days, usecs=usecs)
