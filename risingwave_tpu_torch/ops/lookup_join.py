"""Lookup (delta) join over shared arrangements (the port's own copy of
the JAX package's `ops/lookup_join.py`).

Reference: `src/stream/src/executor/lookup.rs` + the delta-join plan
(`src/frontend/src/optimizer/plan_node/stream_delta_join.rs`,
`lookup_union.rs`): instead of each join keeping private copies of both
inputs (`hash_join.rs` JoinHashMap), the join reads the inputs' EXISTING
materialized state — their arrangement/state tables — and the maintained
algebra is the delta-join identity

    d(A ⋈ B) = dA ⋈ B_old  ∪  A_new ⋈ dB.

Epoch protocol (the analog of lookup.rs's epoch-pinned arrangement
reads): upstream jobs run to the barrier before this executor, so both
state tables already hold their FULL epoch delta when it runs. Each
epoch, both inputs' deltas are buffered to the barrier; then
  - dA probes  B_old = B_table_now adjusted by removing the buffered dB
    (inserts subtracted, deletes re-added), and
  - dB probes  A_new = A_table_now as-is.
No private join state exists at all: recovery is trivial (the executor
is stateless; upstream tables recover themselves), the reference's
arrangement-sharing win.

INNER join only; requires both sides' join keys to be a prefix of (or
equal to) that side's state-table pk, the same index requirement the
reference's delta-join rule imposes (it builds arrangements/indexes on
the join key). Enabled via SET streaming_enable_delta_join TO true.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from ..core.chunk import Op, StreamChunk, StreamChunkBuilder
from ..state.state_table import StateTable
from .executor import Executor
from .message import Barrier, Message, Watermark


class _Arrangement:
    """Probe-side view of an upstream state table."""

    def __init__(self, table: StateTable, key_cols: Sequence[int]):
        self.table = table
        self.key_cols = list(key_cols)       # join key positions in the row
        # join key must cover a pk prefix (in any pair order) for an
        # indexed probe; self.perm reorders probe values into pk order
        pkpre = table.pk_indices[: len(key_cols)]
        if sorted(pkpre) != sorted(key_cols):
            raise ValueError(
                "lookup join requires the join key to cover a pk prefix "
                f"of the arrangement (key {key_cols} vs pk "
                f"{table.pk_indices})")
        self.perm = [self.key_cols.index(c) for c in pkpre]
        # when the probe prefix covers the dist key, the owning vnode is
        # computable from the key — one range read instead of 256
        dist = table.dist_key_indices
        self.dist_in_prefix = ([pkpre.index(c) for c in dist]
                               if set(dist) <= set(pkpre) else None)

    def probe(self, key: Tuple) -> List[Tuple]:
        key = [key[i] for i in self.perm]
        if len(self.key_cols) == len(self.table.pk_indices):
            row = self.table.get_by_pk(key)
            return [tuple(row)] if row is not None else []
        if self.dist_in_prefix is not None:
            from ..core.vnode import vnode_of_row
            vn = vnode_of_row([key[i] for i in self.dist_in_prefix],
                              self.table.vnode_count)
            return [tuple(r)
                    for r in self.table.iter_vnode_prefix(vn, key)]
        out = []
        for vn in range(self.table.vnode_count):
            out.extend(tuple(r)
                       for r in self.table.iter_vnode_prefix(vn, key))
        return out


class LookupJoinExecutor(Executor):
    def __init__(self, left: Executor, right: Executor,
                 left_keys: Sequence[int], right_keys: Sequence[int],
                 left_table: StateTable, right_table: StateTable,
                 condition=None):
        schema = left.schema.concat(right.schema)
        super().__init__(schema, "LookupJoin[inner]")
        self.append_only = left.append_only and right.append_only
        self.left_exec, self.right_exec = left, right
        self.lkeys, self.rkeys = list(left_keys), list(right_keys)
        self.larr = _Arrangement(left_table, left_keys)
        self.rarr = _Arrangement(right_table, right_keys)
        self.condition = condition
        self._n_l = len(left.schema)

    def _key(self, row: Tuple, cols: Sequence[int]) -> Optional[Tuple]:
        k = tuple(row[i] for i in cols)
        return None if any(v is None for v in k) else k

    def _pairs_ok(self, rows: List[Tuple]) -> List[bool]:
        if self.condition is None or not rows:
            return [True] * len(rows)
        from ..core.chunk import DataChunk
        ch = DataChunk.from_rows(
            self.left_exec.schema.dtypes + self.right_exec.schema.dtypes,
            rows)
        c = self.condition.eval(ch)
        return [bool(v) and bool(ok)
                for v, ok in zip(c.values, c.validity)]

    def _emit(self, out: StreamChunkBuilder, sign: int,
              pairs: List[Tuple]) -> None:
        for row, ok in zip(pairs, self._pairs_ok(pairs)):
            if ok:
                out.append_row(Op.INSERT if sign > 0 else Op.DELETE, row)

    def _flush_epoch(self, lbuf: List[Tuple[int, Tuple]],
                     rbuf: List[Tuple[int, Tuple]]
                     ) -> Iterator[StreamChunk]:
        out = StreamChunkBuilder(self.schema.dtypes, 1024)
        # B_old adjustment: net the buffered right delta out of the table
        radj: Dict[Tuple, Counter] = {}
        for sign, row in rbuf:
            k = self._key(row, self.rkeys)
            if k is not None:
                radj.setdefault(k, Counter())[row] += sign
        # dA ⋈ B_old
        for sign, lrow in lbuf:
            k = self._key(lrow, self.lkeys)
            if k is None:
                continue
            matches = Counter(self.rarr.probe(k))
            for row, d in radj.get(k, {}).items():
                matches[row] -= d                 # undo this epoch's dB
            pairs = [lrow + r for r, c in matches.items() if c > 0
                     for _ in range(c)]
            self._emit(out, sign, pairs)
        # A_new ⋈ dB
        for sign, rrow in rbuf:
            k = self._key(rrow, self.rkeys)
            if k is None:
                continue
            lmatches = self.larr.probe(k)   # lkeys[i] pairs with rkeys[i]
            pairs = [lrow + rrow for lrow in lmatches]
            self._emit(out, sign, pairs)
        yield from out.drain()

    def execute(self) -> Iterator[Message]:
        liter = self.left_exec.execute()
        riter = self.right_exec.execute()
        alive = True
        while alive:
            barrier = None
            lbuf: List[Tuple[int, Tuple]] = []
            rbuf: List[Tuple[int, Tuple]] = []
            for buf, it in ((lbuf, liter), (rbuf, riter)):
                while True:
                    try:
                        msg = next(it)
                    except StopIteration:
                        alive = False
                        break
                    if isinstance(msg, Barrier):
                        barrier = msg
                        break
                    if isinstance(msg, StreamChunk):
                        for op, row in msg.compact().op_rows():
                            buf.append((op.sign, tuple(row)))
                    # watermarks: no output watermark (probe rows resurface)
            if barrier is None:
                return
            yield from self._flush_epoch(lbuf, rbuf)
            yield barrier.with_trace(self.name)
            if barrier.is_stop():
                return
