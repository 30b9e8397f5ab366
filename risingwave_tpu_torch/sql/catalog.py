"""Catalog: named tables/sources/MVs/sinks -> schemas + state table ids
(the port's own copy of the JAX package's `sql/catalog.py`).

Analog of the reference's meta catalog + frontend catalog cache
(`src/meta/src/controller/catalog/`, `src/frontend/src/catalog/`), collapsed
to the single-process control plane.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..core.schema import Schema


@dataclass
class CatalogObject:
    name: str
    kind: str                      # 'table' | 'source' | 'mv' | 'sink' | 'index'
    schema: Schema
    pk: List[int]                  # pk column indices into schema
    table_id: int                  # MV/table state table id
    append_only: bool = False
    with_options: Dict[str, str] = field(default_factory=dict)
    watermark_col: Optional[int] = None
    watermark_delay_usecs: int = 0
    n_visible: Optional[int] = None   # hidden stream-key cols sit past this
    parallelism: Optional[int] = None  # ALTER ... SET PARALLELISM override
    index_on: Optional[str] = None     # indexes: the indexed table's name
    # runtime attachments (set by Database)
    runtime: Any = None


class Catalog:
    def __init__(self):
        self.objects: Dict[str, CatalogObject] = {}
        self._next_table_id = 1

    def alloc_table_id(self) -> int:
        tid = self._next_table_id
        self._next_table_id += 1
        return tid

    def create(self, obj: CatalogObject) -> None:
        if obj.name in self.objects:
            raise ValueError(f"object {obj.name!r} already exists")
        self.objects[obj.name] = obj

    def drop(self, name: str, kind: Optional[str] = None) -> CatalogObject:
        obj = self.objects.get(name)
        if obj is None:
            raise KeyError(f"object {name!r} does not exist")
        if kind is not None and obj.kind != kind and \
                not (kind == "table" and obj.kind in ("table", "source")):
            raise ValueError(f"{name!r} is a {obj.kind}, not a {kind}")
        del self.objects[name]
        return obj

    def get(self, name: str) -> CatalogObject:
        obj = self.objects.get(name)
        if obj is None:
            raise KeyError(f"relation {name!r} does not exist")
        return obj

    def list(self, kind: str) -> List[str]:
        return sorted(n for n, o in self.objects.items() if o.kind == kind)
