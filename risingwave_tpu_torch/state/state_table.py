"""StateTable: the relational state layer.

Re-design of `src/stream/src/common/table/state_table.rs:91,168,1013`: a
vnode-aware ordered row table over a `StateStore`. Writes buffer in a
mem-table and flush on `commit(epoch)` — the barrier commit discipline every
stateful executor follows. Key layout: 2-byte big-endian vnode prefix +
memcomparable pk (so per-vnode prefix scans and vnode-bitmap rescale are range
operations, `state_table.rs:752`).
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from ..core.dtypes import DataType
from ..core.encoding import encode_key
from ..core.vnode import VNODE_COUNT, vnode_of_row
from .store import StateStore


def _prefix_upper(prefix: bytes) -> Optional[bytes]:
    """Smallest byte string greater than every string with this prefix
    (exclusive range end for prefix scans); None = unbounded."""
    b = bytearray(prefix)
    while b and b[-1] == 0xFF:
        b.pop()
    if not b:
        return None
    b[-1] += 1
    return bytes(b)


class StateTable:
    def __init__(self, store: StateStore, table_id: int,
                 dtypes: Sequence[DataType], pk_indices: Sequence[int],
                 dist_key_indices: Optional[Sequence[int]] = None,
                 order_desc: Optional[Sequence[bool]] = None,
                 vnode_count: int = VNODE_COUNT,
                 vnodes: Optional[Sequence[int]] = None):
        self.store = store
        self.table_id = table_id
        self.dtypes = list(dtypes)
        self.pk_indices = list(pk_indices)
        # distribution key defaults to the pk prefix the reference uses
        self.dist_key_indices = (list(dist_key_indices)
                                 if dist_key_indices is not None
                                 else list(pk_indices))
        self.pk_dtypes = [self.dtypes[i] for i in self.pk_indices]
        self.order_desc = list(order_desc) if order_desc else [False] * len(self.pk_indices)
        self.vnode_count = vnode_count
        # vnode ownership bitmap (None = all vnodes; set on rescale)
        self.vnodes = set(vnodes) if vnodes is not None else None
        # mem-table: key -> (row|None). None = delete tombstone.
        self.mem: Dict[bytes, Optional[Tuple]] = {}
        self._pending_batch: List[Tuple[bytes, Optional[Tuple]]] = []

    # ---- key construction ----
    def _vnode(self, row: Sequence[Any]) -> int:
        key = [row[i] for i in self.dist_key_indices]
        return vnode_of_row(key, self.vnode_count)

    def key_of(self, row: Sequence[Any]) -> bytes:
        pk = [row[i] for i in self.pk_indices]
        vn = self._vnode(row)
        return struct.pack(">H", vn) + encode_key(pk, self.pk_dtypes, self.order_desc)

    def key_of_pk(self, pk: Sequence[Any], vnode: Optional[int] = None) -> bytes:
        """Key from a pk row (pk must embed the dist key when vnode=None —
        true for all our tables, where dist key ⊆ pk)."""
        if vnode is None:
            dist_in_pk = [self.pk_indices.index(i) for i in self.dist_key_indices]
            vnode = vnode_of_row([pk[j] for j in dist_in_pk], self.vnode_count)
        return struct.pack(">H", vnode) + encode_key(pk, self.pk_dtypes, self.order_desc)

    # ---- writes (buffered) ----
    def insert(self, row: Sequence[Any]) -> None:
        self.mem[self.key_of(row)] = tuple(row)

    def delete(self, row: Sequence[Any]) -> None:
        self.mem[self.key_of(row)] = None

    def write_chunk(self, chunk) -> None:
        """Bulk mem-table apply of a StreamChunk (insert-like ops upsert,
        delete-like ops tombstone), in chunk order. Key encoding is
        vectorized when the pk columns are fixed-width and null-free
        (`encode_key_matrix`); otherwise falls back to the per-row path.
        The Materialize hot path at scale — per-row `key_of` would dominate
        an epoch with 10^5 changed rows."""
        import numpy as np
        from ..core.chunk import _sign_of_ops
        from ..core.encoding import encode_key_matrix
        from ..core.vnode import compute_vnodes
        chunk = chunk.compact()
        n = chunk.capacity
        if n == 0:
            return
        cols = chunk.columns
        rows = chunk.data_chunk().rows()
        ins = (_sign_of_ops(chunk.ops) > 0).tolist()
        mat = encode_key_matrix([cols[i] for i in self.pk_indices],
                                self.pk_dtypes, self.order_desc)
        if mat is None:
            for row, i in zip(rows, range(n)):
                self.mem[self.key_of(row)] = row if ins[i] else None
            return
        vn = compute_vnodes([cols[i] for i in self.dist_key_indices], n,
                            self.vnode_count)
        full = np.empty((n, 2 + mat.shape[1]), np.uint8)
        full[:, :2] = vn.astype(">u2").view(np.uint8).reshape(n, 2)
        full[:, 2:] = mat
        buf = full.tobytes()
        w = full.shape[1]
        mem = self.mem
        for i, row in enumerate(rows):
            mem[buf[i * w:(i + 1) * w]] = row if ins[i] else None

    def update(self, old_row: Sequence[Any], new_row: Sequence[Any]) -> None:
        ko, kn = self.key_of(old_row), self.key_of(new_row)
        if ko != kn:
            self.mem[ko] = None
        self.mem[kn] = tuple(new_row)

    # ---- reads (read-your-writes through the mem-table) ----
    def get_by_pk(self, pk: Sequence[Any]) -> Optional[Tuple]:
        k = self.key_of_pk(pk)
        if k in self.mem:
            return self.mem[k]
        return self.store.get(self.table_id, k)

    def iter_vnode_prefix(self, vnode: int, prefix: Sequence[Any] = ()
                          ) -> Iterator[Tuple]:
        """Ordered scan of rows in `vnode` whose pk starts with `prefix`."""
        base = struct.pack(">H", vnode)
        if prefix:
            enc = encode_key(list(prefix), self.pk_dtypes[: len(prefix)],
                             self.order_desc[: len(prefix)])
            start = base + enc
        else:
            start = base
        yield from self._merged_range(start, _prefix_upper(start))

    def iter_all(self) -> Iterator[Tuple]:
        yield from self._merged_range(None, None)

    def _merged_range(self, start: Optional[bytes], end: Optional[bytes]
                      ) -> Iterator[Tuple]:
        """Merge committed store rows with the uncommitted mem-table overlay,
        in key order (the reference's merge of mem-table + shared buffer)."""
        mem_keys = sorted(k for k in self.mem
                          if (start is None or k >= start)
                          and (end is None or k < end))
        mi = 0
        for k, row in self.store.iter_range(self.table_id, start, end):
            while mi < len(mem_keys) and mem_keys[mi] < k:
                mrow = self.mem[mem_keys[mi]]
                if mrow is not None:
                    yield mrow
                mi += 1
            if mi < len(mem_keys) and mem_keys[mi] == k:
                mrow = self.mem[mem_keys[mi]]
                if mrow is not None:
                    yield mrow
                mi += 1
                continue
            yield row
        while mi < len(mem_keys):
            mrow = self.mem[mem_keys[mi]]
            if mrow is not None:
                yield mrow
            mi += 1

    # ---- barrier commit ----
    def commit(self, epoch: int) -> None:
        """Flush the mem-table at a barrier (`state_table.rs:1013`)."""
        if self.mem:
            batch = sorted(self.mem.items())
            self.store.ingest_batch(self.table_id, batch, epoch)
            self.mem.clear()

    def update_vnodes(self, vnodes: Optional[Sequence[int]]) -> None:
        """Rescale: adopt a new vnode ownership bitmap
        (`StateTablePostCommit`, `state_table.rs:694-790`). Must be called
        right after a commit (empty mem-table)."""
        assert not self.mem, "rescale requires a clean mem-table"
        self.vnodes = set(vnodes) if vnodes is not None else None

    def __len__(self) -> int:
        # approximate during an open epoch (mem-table not merged)
        return self.store.table_len(self.table_id) + len(self.mem)
