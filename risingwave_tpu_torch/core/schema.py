"""Schema: named, typed columns — the reference's `Schema`/`Field`
(`src/common/src/catalog/schema.rs`)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from .dtypes import DataType


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType


class Schema:
    def __init__(self, fields: Sequence[Field]):
        self.fields: List[Field] = list(fields)

    @classmethod
    def of(cls, *pairs: Tuple[str, DataType]) -> "Schema":
        return cls([Field(n, t) for n, t in pairs])

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    @property
    def dtypes(self) -> List[DataType]:
        return [f.dtype for f in self.fields]

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def maybe_index_of(self, name: str) -> Optional[int]:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        return None

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def concat(self, other: "Schema") -> "Schema":
        return Schema(self.fields + other.fields)

    def project(self, indices: Sequence[int]) -> "Schema":
        return Schema([self.fields[i] for i in indices])

    def __repr__(self) -> str:  # pragma: no cover
        inner = ", ".join(f"{f.name} {f.dtype}" for f in self.fields)
        return f"Schema({inner})"
