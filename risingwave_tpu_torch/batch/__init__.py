"""Batch query engine (reference: `src/batch/`; the port's own copy of
the JAX package's `batch/`)."""
from .executor import (BatchExecutor, BatchHashAgg, BatchHashJoin,
                       BatchSimpleAgg, BatchUnion, SeqScan, StatelessWrap)
from .from_stream import translate_stream_plan

__all__ = [
    "BatchExecutor", "BatchHashAgg", "BatchHashJoin", "BatchSimpleAgg",
    "BatchUnion", "SeqScan", "StatelessWrap", "translate_stream_plan",
]
