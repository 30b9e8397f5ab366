"""Connectors (reference: `src/connector/`): the datagen and list
readers, and the Nexmark generator's constants and string pools
(`nexmark.py`)."""
from .datagen import DatagenReader, FieldGen, ListReader

__all__ = ["DatagenReader", "FieldGen", "ListReader"]
