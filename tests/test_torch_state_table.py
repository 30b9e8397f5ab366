"""The port's relational state layer (`state/state_table.py` over
`state/store.py`) against the JAX package's: the same writes —
`write_chunk` on fixed-width (the vectorized key path), NULL and
varchar (the per-row path) primary keys, and `insert` / `delete` /
`update` — must give the same keys, byte for byte, and the same
`iter_all` rows in the same order, before and after commits."""
import numpy as np
import pytest

from risingwave_tpu.core import Op as JOp
from risingwave_tpu.core import StreamChunk as JChunk
from risingwave_tpu.core import dtypes as JT
from risingwave_tpu.state import MemoryStateStore as JStore
from risingwave_tpu.state import StateTable as JTable
from risingwave_tpu_torch.core import Op as POp
from risingwave_tpu_torch.core import StreamChunk as PChunk
from risingwave_tpu_torch.core import dtypes as PT
from risingwave_tpu_torch.state import MemoryStateStore as PStore
from risingwave_tpu_torch.state import StateTable as PTable

PKGS = [(JT, JOp, JChunk, JStore, JTable), (PT, POp, PChunk, PStore, PTable)]

SCHEMAS = {
    "int_pk": (["INT64", "INT32", "FLOAT64"], [0, 1], None),
    "int_pk_desc": (["INT64", "INT16", "INT64"], [1, 0], [True, False]),
    "null_pk": (["INT64", "INT64"], [0], None),
    "varchar_pk": (["VARCHAR", "INT64", "FLOAT64"], [0, 1], None),
    "dist_subset": (["INT32", "INT64", "INT64"], [0, 1], None),
}


def value(rng, kind, nulls):
    if nulls and rng.random() < 0.2:
        return None
    if kind == "VARCHAR":
        return f"k{int(rng.integers(0, 40))}"
    if kind == "FLOAT64":
        return float(np.round(rng.normal(), 3))
    if kind == "INT16":
        return int(rng.integers(-300, 300))
    if kind == "INT32":
        return int(rng.integers(-2**31, 2**31)) if rng.random() < 0.3 \
            else int(rng.integers(-20, 20))
    return int(rng.integers(-2**40, 2**40)) if rng.random() < 0.3 \
        else int(rng.integers(-20, 20))


def op_rows(rng, kinds, pk, n, nulls):
    out = []
    for _ in range(n):
        row = tuple(value(rng, k, nulls and i in pk)
                    for i, k in enumerate(kinds))
        op = rng.choice([0, 0, 0, 1, 2, 3])
        out.append((int(op), row))
    return out


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_write_chunk_keys_and_order(name):
    kinds, pk, desc = SCHEMAS[name]
    dist = [0] if name == "dist_subset" else None
    rng = np.random.default_rng(len(name))
    tables = []
    for T, Op, Chunk, Store, Table in PKGS:
        store = Store()
        t = Table(store, 7, [getattr(T, k) for k in kinds], pk,
                  dist_key_indices=dist, order_desc=desc)
        tables.append((t, store, T, Op, Chunk))
    for epoch in range(1, 5):
        batch = op_rows(rng, kinds, pk, 120, name == "null_pk"
                        or name == "varchar_pk")
        for t, store, T, Op, Chunk in tables:
            t.write_chunk(Chunk.from_rows(
                [getattr(T, k) for k in kinds],
                [(Op(o), r) for o, r in batch]))
        (jt, jstore, *_), (pt, pstore, *_) = tables
        assert list(pt.mem) == list(jt.mem)
        assert list(pt.mem.values()) == list(jt.mem.values())
        assert list(pt.iter_all()) == list(jt.iter_all())
        if epoch % 2 == 0:
            for t, store, *_ in tables:
                t.commit(epoch)
                store.commit_epoch(epoch)
            assert list(pstore.tables[7].data) == \
                list(jstore.tables[7].data)
            assert list(pt.iter_all()) == list(jt.iter_all())
            assert len(pt) == len(jt)


def test_insert_delete_update_and_reads():
    """The row-at-a-time writes and the point / prefix reads."""
    kinds, pk = ["VARCHAR", "INT64", "INT64"], [0, 1]
    rng = np.random.default_rng(4)
    rows = [(f"g{i % 7}", int(i), int(rng.integers(0, 100)))
            for i in range(60)]
    got = []
    for T, Op, Chunk, Store, Table in PKGS:
        store = Store()
        t = Table(store, 3, [getattr(T, k) for k in kinds], pk)
        for r in rows:
            t.insert(r)
        t.commit(1)
        for r in rows[::5]:
            t.delete(r)
        for r in rows[1::5]:
            t.update(r, (r[0], r[1], r[2] + 1000))
        for r in rows[2::9]:
            t.update(r, ("moved", r[1], r[2]))
        seen = [list(t.iter_all()), t.get_by_pk(["g1", 1]),
                t.get_by_pk(["g0", 0]), t.key_of(rows[3]),
                t.key_of_pk(["g3", 3]),
                [list(t.iter_vnode_prefix(v)) for v in range(256)]]
        t.commit(2)
        seen += [list(t.iter_all()), len(t)]
        got.append(seen)
    assert got[0] == got[1]
