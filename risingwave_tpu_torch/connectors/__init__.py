"""Connectors: sources & sinks (reference: `src/connector/`): the split
framework and its parsers, the filesystem source, the file sink, the
datagen and list readers, and the Nexmark generator — its host reader
stack, and the constants, string pools and surrogate generator that the
device generator and the host-ingest feed read (`nexmark.py`)."""
from .base import (CsvParser, JsonParser, Parser, SourceSplit,
                   SplitEnumerator, SplitReader, SplitSourceReader,
                   make_parser)
from .datagen import DatagenReader, FieldGen, ListReader
from .filesystem import DirEnumerator, LineFileReader
from .nexmark import (AUCTION_SCHEMA, BID_SCHEMA, PERSON_SCHEMA, NexmarkConfig,
                      NexmarkGenerator, NexmarkReader)
from .sink import FileSink, SinkExecutor

__all__ = [
    "CsvParser", "JsonParser", "Parser", "SourceSplit", "SplitEnumerator",
    "SplitReader", "SplitSourceReader", "make_parser",
    "DatagenReader", "FieldGen", "ListReader",
    "DirEnumerator", "LineFileReader", "FileSink", "SinkExecutor",
    "AUCTION_SCHEMA", "BID_SCHEMA", "PERSON_SCHEMA", "NexmarkConfig",
    "NexmarkGenerator", "NexmarkReader",
]
