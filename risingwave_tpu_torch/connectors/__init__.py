"""Connectors (reference: `src/connector/`): the datagen and list
readers, and the Nexmark generator — its host reader stack, and the
constants, string pools and surrogate generator that the device
generator and the host-ingest feed read (`nexmark.py`)."""
from .datagen import DatagenReader, FieldGen, ListReader
from .nexmark import (AUCTION_SCHEMA, BID_SCHEMA, PERSON_SCHEMA, NexmarkConfig,
                      NexmarkGenerator, NexmarkReader)

__all__ = [
    "DatagenReader", "FieldGen", "ListReader",
    "AUCTION_SCHEMA", "BID_SCHEMA", "PERSON_SCHEMA", "NexmarkConfig",
    "NexmarkGenerator", "NexmarkReader",
]
