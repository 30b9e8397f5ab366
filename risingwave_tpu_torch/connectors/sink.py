"""Sinks: deliver a change stream to an external system, exactly once (the
port's own copy of the JAX package's `connectors/sink.py`).

Reference: `src/connector/src/sink/mod.rs:602` (`Sink` trait) + the
log-store decoupling (`src/stream/src/common/log_store_impl/`) and the
"write epoch, then commit" discipline of the coordinated sinks. This
runtime's analog keeps the full two-store protocol:

* rows buffer per epoch in memory;
* at a CHECKPOINT barrier the epoch's rows are written to a durable LOG
  state table (the log-store analog) — that write becomes durable in the
  SAME store commit as the source offsets and every operator's state, so
  the log and the rest of the checkpoint agree by construction;
* delivery to the external file happens one checkpoint later, once the
  log entries are known durable: append + fsync, then a manifest
  (epoch -> byte length) renames into place — the external commit point —
  and the delivered log entries are deleted;
* on restart the sink truncates the data file to the manifested length,
  re-delivers any durable log epochs past the manifest, and drops log
  epochs at or below it. Every crash window re-delivers exactly the rows
  whose delivery is not manifested and whose ingestion is checkpointed —
  exactly-once end to end.

Formats: `jsonl` (append-only streams emit the bare row object;
retractable streams wrap it as {"op": "+"/"-", "row": {...}} — the
debezium-ish changelog shape) and `csv` (RFC-4180 quoting).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Iterator, List, Optional, Tuple

from ..core.chunk import StreamChunk
from ..core.encoding import decode_row, encode_row
from ..core.schema import Schema
from ..ops.executor import Executor
from ..ops.message import Barrier, Message
from ..state.state_table import StateTable
from ..utils.failpoint import declare, failpoint

_FORMATS = ("jsonl", "json", "ndjson", "csv")

declare("overload.slow_sink",
        "stalled-external-sink chaos: while armed, sink delivery is "
        "deferred (the external system is 'unavailable') — the backlog "
        "parks in the DURABLE sink log, the sink reports `stalled` in "
        "liveness, and the overload ladder sees full sink pressure; "
        "disarming delivers the backlog at the next checkpoint")


def _json_default(v):
    return str(v)


class FileSink:
    """Append-only local-file sink; the manifest rename is the external
    commit point."""

    def __init__(self, path: str, schema: Schema, fmt: str = "jsonl",
                 append_only: bool = False):
        if fmt not in _FORMATS:
            raise ValueError(
                f"unknown sink format {fmt!r} (expected one of {_FORMATS})")
        self.path = path
        self.schema = schema
        self.fmt = fmt
        self.append_only = append_only
        self._names = [f.name for f in schema.fields]
        self.committed_epoch = 0
        self._committed_bytes = 0
        self._recover()

    # ---- recovery -------------------------------------------------------
    @property
    def _manifest_path(self) -> str:
        return self.path + ".manifest"

    def _recover(self) -> None:
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                m = json.load(f)
            self.committed_epoch = m["epoch"]
            self._committed_bytes = m["bytes"]
        if os.path.exists(self.path):
            size = os.path.getsize(self.path)
            if size > self._committed_bytes:
                if self.committed_epoch == 0 and self._committed_bytes == 0:
                    # no manifest: this file was NOT written by this sink —
                    # truncating would destroy someone else's data
                    raise FileExistsError(
                        f"sink path {self.path!r} already exists with "
                        "content but no sink manifest; refusing to "
                        "overwrite")
                # drop any append that never reached its manifest commit
                with open(self.path, "r+b") as f:
                    f.truncate(self._committed_bytes)
            elif size < self._committed_bytes:
                # externally truncated: continuing would overstate
                # _committed_bytes and silently break the torn-tail guard
                raise IOError(
                    f"sink data file {self.path!r} is {size} bytes but "
                    f"manifest committed {self._committed_bytes}: external "
                    "truncation/corruption")
        elif self._committed_bytes:
            raise FileNotFoundError(
                f"sink data file {self.path!r} missing but manifest "
                f"claims {self._committed_bytes} bytes")

    # ---- delivery -------------------------------------------------------
    def _format_rows(self, pairs: List[Tuple[int, Tuple]]) -> str:
        if self.fmt == "csv":
            import csv
            import io
            buf = io.StringIO()
            w = csv.writer(buf)
            for sign, row in pairs:
                vals = ["" if v is None else str(v) for v in row]
                w.writerow(vals if self.append_only
                           else ["+" if sign > 0 else "-"] + vals)
            return buf.getvalue()
        out = []
        for sign, row in pairs:
            obj = dict(zip(self._names, row))
            if self.append_only:
                out.append(json.dumps(obj, default=_json_default))
            else:
                out.append(json.dumps(
                    {"op": "+" if sign > 0 else "-", "row": obj},
                    default=_json_default))
        return "".join(s + "\n" for s in out)

    def deliver(self, epoch: int, pairs: List[Tuple[int, Tuple]]) -> None:
        """Append `pairs` (already durable in the log) and move the
        manifest to `epoch`: append + fsync + atomic rename."""
        if epoch <= self.committed_epoch:
            return
        if pairs:
            enc = self._format_rows(pairs).encode("utf-8")
            with open(self.path, "ab") as f:
                f.write(enc)
                f.flush()
                os.fsync(f.fileno())
            self._committed_bytes += len(enc)
        self.committed_epoch = epoch
        if not pairs:
            return                       # idle epochs cost no IO
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"epoch": epoch, "bytes": self._committed_bytes}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path)


class SinkExecutor(Executor):
    """Executor shim: change stream -> durable log -> external delivery
    (`src/stream/src/executor/sink.rs` + log-store analog).

    The log state table rows are (epoch, seq) -> (sign, value-encoded
    row). Current-epoch rows are logged at their checkpoint barrier (they
    become durable in the same store commit as everything else); log
    epochs already durable — at or below the store's committed epoch —
    deliver to the file at the NEXT checkpoint and are then deleted.

    Refresh dedupe (`pk_indices`): a supervised worker respawn's v1
    full refresh re-INSERTs every owned group — the MV reconciles by pk,
    but the change stream carries duplicate `+` records straight into
    the sink. With a pk, the sink keeps a per-pk mirror of what it has
    delivered and reconciles at its boundary: a `+` identical to the
    mirrored row is dropped (the duplicate), a `+` for a pk holding a
    DIFFERENT row becomes a `-old`/`+new` repair pair, and a `-` for a
    pk the mirror holds retracts the mirrored row (robust to refresh
    artifacts). Rows for unseen pks always pass — unseen means the
    mirror genuinely never delivered them.

    Durable mirror journal (`mirror_table`, fault-tolerance v3): the
    per-pk mirror is no longer a coordinator-process-lifetime structure.
    Its deltas journal through a durable state table with EPOCH-FENCED
    commits — the same store commit as the sink log and every operator's
    state — and a restarted coordinator REBUILDS the mirror from the
    journal before the first post-restart change arrives. A refresh
    racing a coordinator crash therefore cannot duplicate into the
    external file: the re-stated rows meet a mirror that remembers them.
    Append-only streams and pk-less shapes skip the mirror entirely."""

    def __init__(self, input: Executor, sink: FileSink,
                 log_table: Optional[StateTable] = None,
                 pk_indices: Optional[List[int]] = None,
                 mirror_table: Optional[StateTable] = None,
                 name: str = "Sink"):
        super().__init__(input.schema, name)
        self.input = input
        self.sink = sink
        self.log_table = log_table
        self._pending: List[Tuple[int, Tuple]] = []
        # slow-sink isolation (overload control plane): `stalled` flips
        # while external delivery is deferred (overload.slow_sink chaos,
        # or a real delivery failure) — surfaced in rw_worker_liveness
        # and read by the overload manager as full sink pressure. The
        # backlog parks in the DURABLE sink log (disk), never RSS; the
        # in-memory window spool is bounded by `pending_rows()` feeding
        # the ladder, which throttles the sources upstream.
        self.stalled = False
        self.last_delivery_ts = time.time()
        self._dtypes = [f.dtype for f in input.schema.fields]
        self.pk_indices = list(pk_indices) if pk_indices else None
        self._mirror: dict = {}
        self.dedupe = bool(self.pk_indices) and not input.append_only
        self.mirror_table = mirror_table if self.dedupe else None
        self._pk_dtypes = [self._dtypes[i] for i in self.pk_indices] \
            if self.pk_indices else []
        # pk -> the exact journal row last written (delete-then-insert
        # upserts need the old row back)
        self._journaled: dict = {}
        # pks whose mirror entry changed since the last checkpoint —
        # the journal writes deltas, not full snapshots
        self._mirror_dirty: set = set()
        if self.mirror_table is not None:
            # coordinator restart: rebuild the delivered mirror from the
            # journal — only COMMITTED entries survive in the store, so
            # the rebuild is epoch-fenced by construction
            for jrow in self.mirror_table.iter_all():
                jrow = tuple(jrow)
                row = decode_row(jrow[2], self._dtypes)
                self._mirror[tuple(row[i] for i in self.pk_indices)] = row
                self._journaled[jrow[0]] = jrow

    def _reconcile(self, sign: int, row: Tuple) -> List[Tuple[int, Tuple]]:
        """Map one change through the delivered-row mirror; returns the
        (sign, row) pairs that actually go to the log/file."""
        pk = tuple(row[i] for i in self.pk_indices)
        held = self._mirror.get(pk)
        if sign > 0:
            if held == row:
                from ..utils.metrics import REGISTRY
                REGISTRY.counter(
                    "sink_dedupe_dropped_total",
                    "duplicate refresh records dropped at the sink "
                    "boundary").inc()
                return []
            self._mirror[pk] = row
            self._mirror_dirty.add(pk)
            if held is not None:        # refresh with a changed value
                return [(-1, held), (1, row)]
            return [(1, row)]
        if held is not None:
            del self._mirror[pk]
            self._mirror_dirty.add(pk)
            return [(-1, held)]
        return [(-1, row)]              # unseen pk: trust upstream

    def _journal_mirror(self, epoch: int) -> None:
        """Write the checkpoint window's mirror deltas to the journal
        table and commit them fenced at `epoch` — the same store commit
        that makes the sink log and the operators' state durable, so the
        mirror can never run ahead of (or behind) the data it fences."""
        if self.mirror_table is None or not self._mirror_dirty:
            self._mirror_dirty.clear()
            return
        for pk in self._mirror_dirty:
            key = encode_row(pk, self._pk_dtypes)
            old = self._journaled.pop(key, None)
            if old is not None:
                self.mirror_table.delete(old)
            row = self._mirror.get(pk)
            if row is not None:
                new = (key, epoch, encode_row(row, self._dtypes))
                self.mirror_table.insert(new)
                self._journaled[key] = new
        self._mirror_dirty.clear()
        self.mirror_table.commit(epoch)

    def pending_rows(self) -> int:
        """Rows spooled in the current checkpoint window (the in-memory
        spool the overload manager bounds against RW_SINK_SPOOL_ROWS)."""
        return len(self._pending)

    def _mark_stalled(self) -> None:
        if not self.stalled:
            from ..utils.metrics import REGISTRY
            REGISTRY.counter(
                "sink_stalls_total",
                "times a sink's external delivery stalled",
                labels=("sink",)).labels(self.name).inc()
        self.stalled = True

    def _stall(self) -> bool:
        """True while the external system is 'unavailable' (armed
        overload.slow_sink). Delivery defers — the durable log keeps the
        backlog on disk — and the stalled flag feeds liveness plus the
        overload ladder. A REAL delivery failure (OSError out of the
        external append/rename) takes the same path via the callers'
        except clauses."""
        if failpoint("overload.slow_sink"):
            self._mark_stalled()
            return True
        return False

    def deliver_durable(self) -> None:
        """Ship every log epoch that the store has made durable. Called by
        the barrier loop right after `store.commit_epoch` (the
        post-checkpoint sink-committer step), and again defensively at the
        next checkpoint barrier (covers recovery)."""
        if self.log_table is None:
            return
        if self._stall():
            return                       # backlog stays in the durable log
        durable = getattr(self.log_table.store, "committed_epoch", 0)
        by_epoch: dict = {}
        for row in list(self.log_table.iter_all()):
            epoch, seq, sign, payload = row
            if epoch > durable:
                continue
            by_epoch.setdefault(epoch, []).append((seq, sign, payload, row))
        for epoch in sorted(by_epoch):
            # explicit (epoch, seq) replay order — table iteration is
            # vnode-prefixed, which would interleave rows
            entries = sorted(by_epoch[epoch])
            if epoch > self.sink.committed_epoch:
                pairs = [(sign, decode_row(payload, self._dtypes))
                         for _, sign, payload, _ in entries]
                try:
                    self.sink.deliver(epoch, pairs)
                except OSError:
                    # real external failure (disk full, unmounted path):
                    # isolate like the chaos stall — backlog stays in
                    # the durable log, retried next checkpoint — instead
                    # of crashing the coordinator tick
                    self._mark_stalled()
                    return
            for _, _, _, row in entries:   # delivered or already manifested
                self.log_table.delete(row)
        self.stalled = False
        self.last_delivery_ts = time.time()

    def execute(self) -> Iterator[Message]:
        for msg in self.input.execute():
            if isinstance(msg, StreamChunk):
                if msg.cardinality:
                    for op, row in msg.compact().op_rows():
                        if self.dedupe:
                            self._pending.extend(
                                self._reconcile(op.sign, row))
                        else:
                            self._pending.append((op.sign, row))
            elif isinstance(msg, Barrier) and msg.is_checkpoint:
                epoch = msg.epoch.curr
                if self.log_table is None:
                    # non-durable runtime: deliver directly (tests/
                    # ephemeral); a stalled external defers delivery and
                    # the window accumulates in the bounded spool (the
                    # ladder throttles the sources against it)
                    if not self._stall():
                        try:
                            self.sink.deliver(epoch, self._pending)
                        except OSError:
                            self._mark_stalled()
                        else:
                            self._pending.clear()
                            self.stalled = False
                            self.last_delivery_ts = time.time()
                else:
                    self.deliver_durable()
                    if epoch > self.sink.committed_epoch:
                        for i, (sign, row) in enumerate(self._pending):
                            self.log_table.insert(
                                (epoch, i, sign,
                                 encode_row(row, self._dtypes)))
                    self._pending.clear()
                    self.log_table.commit(epoch)
                    # mirror deltas journal in the SAME epoch fence as
                    # the log entries they deduplicated against
                    self._journal_mirror(epoch)
            yield msg
