"""Executor protocol.

Re-design of the reference's `Execute` trait
(`src/stream/src/executor/mod.rs:203`): an executor is a generator over
`Message`s. Composition is by wrapping input generators (the reference pins
boxed streams; Python generators give the same pull-based dataflow). The
invariant every stateful executor obeys (mod.rs docs + `state_table.rs`):
buffer state changes, `commit(epoch)` when a barrier arrives, THEN yield the
barrier downstream.

One executor here serves a whole fragment's data-parallelism: vnode-level
parallelism lives on the device, not in N OS-level actors. The port's own
copy of the JAX package's `ops/executor.py`.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Sequence

from ..core.chunk import StreamChunk
from ..core.schema import Schema
from .message import Barrier, Message, Watermark


class Executor:
    """Base: `execute()` yields Chunk | Barrier | Watermark."""

    # True when this stream can never emit DELETE / UPDATE rows — the
    # reference's append-only plan property (derived bottom-up over the
    # plan, `generic/agg.rs` `input.append_only()`). Lets the device agg
    # keep min/max as a single extreme column instead of a multiset.
    append_only = False

    def __init__(self, schema: Schema, name: str = ""):
        self.schema = schema
        self.name = name or type(self).__name__

    def execute(self) -> Iterator[Message]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Message]:
        return self.execute()


class UnaryExecutor(Executor):
    """Single-input executor with chunk/barrier/watermark hooks."""

    def __init__(self, input: Executor, schema: Schema, name: str = ""):
        super().__init__(schema, name)
        self.input = input

    # hooks ---------------------------------------------------------------
    def on_chunk(self, chunk: StreamChunk) -> Iterator[Message]:
        raise NotImplementedError

    def on_barrier(self, barrier: Barrier) -> Iterator[Message]:
        """Emit pre-barrier output (e.g. agg change chunks); commit state.
        The barrier itself is yielded by the driver loop afterwards."""
        return iter(())

    def on_watermark(self, wm: Watermark) -> Iterator[Message]:
        yield wm

    def execute(self) -> Iterator[Message]:
        for msg in self.input.execute():
            if isinstance(msg, StreamChunk):
                if msg.cardinality > 0:
                    yield from self.on_chunk(msg)
            elif isinstance(msg, Barrier):
                yield from self.on_barrier(msg)
                yield msg.with_trace(self.name)
            elif isinstance(msg, Watermark):
                yield from self.on_watermark(msg)
            else:  # pragma: no cover
                raise TypeError(f"unexpected message {msg!r}")


class SharedStream:
    """Fan-out buffer: lets one upstream executor feed multiple downstream
    consumers (the reference does this with per-dispatcher channels in
    `DispatchExecutor`; in-process we tee the generator)."""

    def __init__(self, upstream: Executor):
        self.upstream = upstream
        self._iter = None
        self._buffers: List[List[Message]] = []

    def subscribe(self) -> "SharedStreamPort":
        buf: List[Message] = []
        self._buffers.append(buf)
        return SharedStreamPort(self, buf)

    def unsubscribe(self, port: "SharedStreamPort") -> None:
        """Detach a consumer (DROP of a downstream MV/sink) — its buffer
        must stop accumulating messages. Identity-based removal: buffers
        are usually empty lists, and list.remove's equality match would
        detach some OTHER consumer's empty buffer."""
        self._buffers = [b for b in self._buffers if b is not port.buf]

    def _pump(self) -> bool:
        if self._iter is None:
            self._iter = self.upstream.execute()
        try:
            msg = next(self._iter)
        except StopIteration:
            return False
        for b in self._buffers:
            b.append(msg)
        return True


class SharedStreamPort(Executor):
    def __init__(self, shared: SharedStream, buf: List[Message]):
        super().__init__(shared.upstream.schema, f"tee({shared.upstream.name})")
        self.shared = shared
        self.buf = buf
        self.append_only = shared.upstream.append_only

    def execute(self) -> Iterator[Message]:
        while True:
            while not self.buf:
                if not self.shared._pump():
                    return
            yield self.buf.pop(0)
