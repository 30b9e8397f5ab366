"""The port's per-operator device path against the JAX package's, at the
executor level: the same graph is built in both packages —
`SourceExecutor(ListReader)` -> `DeviceHashAggExecutor` /
`DeviceHashJoinExecutor` -> `MaterializeExecutor`, driven by a
`StreamJob` over a `MemoryStateStore` (the reference's operator tests'
pattern, tests/test_stateful_ops.py) — and fed the same seeded chunks.
After every barrier the output chunks (ops, values, validity) and every
state table's `iter_all` rows must be equal. Floats are compared exactly
(no tolerance): both packages reduce in a fixed order.

The cases mirror the reference's `Database`-level device tests
(tests/test_device_seam.py, tests/test_device_join_netting.py) one level
down, where no SQL planner is needed."""
import importlib
from decimal import Decimal

import numpy as np
import pytest


class Pkg:
    """One package's executor-level names."""

    def __init__(self, root: str, **exec_kw):
        core = importlib.import_module(f"{root}.core")
        ops = importlib.import_module(f"{root}.ops")
        self.T = core.dtypes
        self.Op, self.StreamChunk, self.Schema = (core.Op, core.StreamChunk,
                                                  core.Schema)
        self.ops = ops
        self.da = importlib.import_module(f"{root}.ops.device_agg")
        self.dj = importlib.import_module(f"{root}.ops.device_join")
        self.state = importlib.import_module(f"{root}.state")
        self.StreamJob = importlib.import_module(
            f"{root}.runtime").StreamJob
        self.ListReader = importlib.import_module(
            f"{root}.connectors.datagen").ListReader
        self.expr = importlib.import_module(f"{root}.expr")
        self.epoch = importlib.import_module(f"{root}.core.epoch")
        self.exec_kw = exec_kw            # device="cpu" for the port

    def dt(self, name):
        return getattr(self.T, name)

    def chunk(self, kinds, op_rows):
        return self.StreamChunk.from_rows([self.dt(k) for k in kinds],
                                          [(self.Op(o), r)
                                           for o, r in op_rows])

    def ref(self, i, kind):
        return self.expr.InputRef(i, self.dt(kind))

    def calls(self, specs, kinds):
        """(agg kind, arg column or None) -> AggCalls over `kinds`."""
        return [self.expr.AggCall(k, None if a is None
                                  else self.ref(a, kinds[a]))
                for k, a in specs]


REF = Pkg("risingwave_tpu")
PORT = Pkg("risingwave_tpu_torch", device="cpu")
I, D, UD, UI = 0, 1, 2, 3               # Op values: insert, delete, U-, U+


class Source:
    """A ListReader-fed source whose chunks arrive one epoch at a time."""

    def __init__(self, P, kinds, injector, append_only=False):
        self.P, self.kinds = P, kinds
        self.reader = P.ListReader([])
        schema = P.Schema.of(*[(f"c{i}", P.dt(k))
                               for i, k in enumerate(kinds)])
        self.exec = P.ops.SourceExecutor(schema, self.reader, injector,
                                         append_only=append_only)

    def push(self, op_rows):
        if op_rows:
            self.reader.push(self.P.chunk(self.kinds, op_rows))


class WmAfterChunk:
    """Pass-through executor that emits queued watermarks after a chunk."""

    def __new__(cls, P, input):
        class _Wm(P.ops.UnaryExecutor):
            pending = []

            def on_chunk(self, chunk):
                yield chunk
                while self.pending:
                    yield self.pending.pop(0)
        ex = _Wm(input, input.schema, "WmAfterChunk")
        ex.append_only = input.append_only
        return ex


def agg_exec(P, store, input, gk, specs, kinds, append_only=False,
             capacity=8, tid=10):
    """The planner's wiring (sql/planner.py `_make_hash_agg`): a payload
    state table and one table per multiset."""
    calls = P.calls(specs, kinds)
    gdt = [P.dt(kinds[i]) for i in gk]
    nk = len(gk)
    st = P.state.StateTable(
        store, tid, gdt + P.da.device_payload_dtypes(calls, append_only),
        list(range(nk)))
    mts = [P.state.StateTable(store, tid + 1 + i,
                              gdt + [P.T.INT64, P.T.INT64],
                              list(range(nk + 1)))
           for i in range(P.da.device_minput_count(calls, append_only))]
    return P.ops.DeviceHashAggExecutor(
        input, gk, calls, state_table=st, minput_tables=mts,
        capacity=capacity, append_only=append_only, **P.exec_kw)


def join_exec(P, store, left, right, lk, rk, cond=None, capacity=8,
              pair_capacity=8, tid=30):
    lt = [f.dtype for f in left.schema.fields]
    rt = [f.dtype for f in right.schema.fields]
    ls = P.state.StateTable(store, tid, lt + [P.T.INT64],
                            list(range(len(lt))))
    rs = P.state.StateTable(store, tid + 1, rt + [P.T.INT64],
                            list(range(len(rt))))
    return P.dj.DeviceHashJoinExecutor(
        left, right, lk, rk, condition=cond, left_state=ls, right_state=rs,
        capacity=capacity, pair_capacity=pair_capacity, **P.exec_kw)


class Graph:
    """source(s) -> build -> materialize, one StreamJob."""

    def __init__(self, P, build, store=None, mv_tid=1):
        self.P = P
        self.store = store if store is not None else P.state.MemoryStateStore()
        self.injector = P.ops.BarrierInjector(start_epoch=1 << 16)
        self.node, self.sources = build(P, self.store, self.injector)
        self.mv = P.state.StateTable(self.store, mv_tid,
                                     self.node.schema.dtypes,
                                     list(range(len(self.node.schema))))
        mat = P.ops.MaterializeExecutor(self.node, self.mv)
        self.job = P.StreamJob(mat, self.injector, self.store)
        self.job.collect_output = True
        self.job.run_until_barrier()            # the initial barrier

    def epoch(self, *batches):
        for src, rows in zip(self.sources, batches):
            src.push(rows)
        self.job.output_chunks = []
        b = self.job.run_until_barrier()
        assert b is not None
        return self.job.output_chunks

    def tables(self):
        return {tid: list(t.iter_range(None, None))
                for tid, t in sorted(self.store.tables.items())}


def chunk_view(c):
    """A chunk as plain Python: ops, then per column (dtype kind, values
    where valid — Decimals and floats by repr — and validity)."""
    return (c.ops.tolist(),
            [(col.dtype.kind.value,
              [repr(v) for v, ok in zip(col.values.tolist(),
                                        col.validity.tolist()) if ok],
              col.validity.tolist()) for col in c.columns])


def assert_outputs(pout, rout):
    assert [chunk_view(c) for c in pout] == [chunk_view(c) for c in rout]


def assert_tables(pg, rg):
    pt, rt = pg.tables(), rg.tables()
    assert list(pt) == list(rt)
    for tid in rt:
        assert [k for k, _ in pt[tid]] == [k for k, _ in rt[tid]], tid
        assert repr([v for _, v in pt[tid]]) == \
            repr([v for _, v in rt[tid]]), tid


def drive(build, epochs, graphs=None):
    """Run both packages' graphs epoch by epoch; compare after each
    barrier. Returns the two graphs."""
    rg, pg = graphs or (Graph(REF, build), Graph(PORT, build))
    for batches in epochs:
        rout = rg.epoch(*batches)
        pout = pg.epoch(*batches)
        assert_outputs(pout, rout)
        assert_tables(pg, rg)
    return rg, pg


def one_agg(gk, specs, kinds, append_only=False, capacity=8, wm=False):
    def build(P, store, inj):
        src = Source(P, kinds, inj, append_only)
        inp = WmAfterChunk(P, src.exec) if wm else src.exec
        return agg_exec(P, store, inp, gk, specs, kinds, append_only,
                        capacity), [src]
    return build


class Table:
    """A host table of rows with ids, to draw deletes and updates from."""

    def __init__(self, rng):
        self.rng, self.rows = rng, []

    def inserts(self, make, n):
        new = [make() for _ in range(n)]
        self.rows += new
        return [(I, r) for r in new]

    def deletes(self, n, pred=lambda r: True):
        out = []
        for _ in range(n):
            cand = [i for i, r in enumerate(self.rows) if pred(r)]
            if not cand:
                break
            out.append((D, self.rows.pop(cand[int(self.rng.integers(
                0, len(cand)))])))
        return out

    def updates(self, n, change):
        out = []
        for _ in range(min(n, len(self.rows))):
            i = int(self.rng.integers(0, len(self.rows)))
            old = self.rows[i]
            self.rows[i] = change(old)
            out += [(UD, old), (UI, self.rows[i])]
        return out


# ---------------------------------------------------------------------------
# DeviceHashAggExecutor
# ---------------------------------------------------------------------------

T_KINDS = ["INT32", "VARCHAR", "INT64", "FLOAT64"]      # k, cat, v, f


def random_t_epochs(seed, n_epochs=5, nulls=True):
    rng = np.random.default_rng(seed)
    t = Table(rng)

    def make():
        v = None if nulls and rng.random() < 0.15 \
            else int(rng.integers(0, 100))
        return (int(rng.integers(0, 6)), f"c{int(rng.integers(0, 4))}", v,
                round(float(rng.random()), 3))
    epochs = []
    for _ in range(n_epochs):
        rows = t.inserts(make, 40)
        kd = int(rng.integers(0, 6))
        rows += t.deletes(5, lambda r: r[0] == kd and (r[2] or 0) < 30)
        rows += t.updates(4, lambda r: (r[0], r[1],
                                        None if r[2] is None else r[2] + 1,
                                        r[3]))
        epochs.append((rows,))
    return epochs


def test_random_workload_matches_reference():
    """tests/test_device_seam.py:23 — inserts, deletes and updates; count,
    count(v), sum(v), avg(v) by k, and a float sum by a varchar key."""
    epochs = random_t_epochs(7)
    drive(one_agg([0], [("count", None), ("count", 2), ("sum", 2),
                        ("avg", 2)], T_KINDS), epochs)
    drive(one_agg([1], [("sum", 3)], T_KINDS), epochs)


def test_null_group_and_distinct_shape():
    """:57 — a NULL group key (int32: the packed codec; int64: the hash
    codec), and a group-by with no calls (SELECT DISTINCT)."""
    rows = [(I, (None, 1)), (I, (None, 2)), (I, (3, 3)), (I, (3, 4))]
    dels = [(D, (None, 1)), (D, (None, 2))]
    for key in ("INT32", "INT64"):
        kinds = [key, "INT64"]
        drive(one_agg([0], [("count", None)], kinds),
              [(rows,), (dels,), ([(I, (None, 9))],)])
        _, pg = drive(one_agg([0], [], kinds),
                      [(rows,), (dels,), ([(I, (None, 9))],)])
        assert sorted(pg.mv.iter_all(), key=repr) == [(3,), (None,)]


def test_retractable_minmax_matches_reference():
    """:118 — min / max of an int and a float column under deletes and
    updates, through the multisets; NULL values included."""
    rng = np.random.default_rng(11)
    t = Table(rng)
    kinds = ["INT32", "INT64", "FLOAT64"]

    def make():
        v = None if rng.random() < 0.1 else int(rng.integers(-50, 50))
        return (int(rng.integers(0, 5)), v,
                round(float(rng.standard_normal()), 3))
    epochs = []
    for _ in range(5):
        rows = t.inserts(make, 30)
        th, kd = int(rng.integers(0, 40)), int(rng.integers(0, 5))
        rows += t.deletes(6, lambda r: r[0] == kd and (r[1] or 0) > th)
        rows += t.updates(4, lambda r: (r[0], None if r[1] is None
                                        else r[1] - 7, r[2]))
        epochs.append((rows,))
    drive(one_agg([0], [("min", 1), ("max", 1), ("min", 2), ("max", 2),
                        ("count", None)], kinds), epochs)


def test_extreme_values():
    """:145 — int64 max / min as aggregate values round-trip exactly,
    and retracting the max leaves the next one."""
    big, small = 2**63 - 1, -(2**63) + 1
    kinds = ["INT32", "INT64"]
    _, pg = drive(one_agg([0], [("min", 1), ("max", 1)], kinds),
                  [([(I, (1, big)), (I, (1, small)), (I, (1, 0))],),
                   ([(D, (1, big))],)])
    assert list(pg.mv.iter_all()) == [(1, small, 0)]


def test_minmax_of_one_column_share_a_multiset():
    """:161 — min(v) and max(v) share one multiset, max(w) has its own;
    the executors persist two minput tables."""
    kinds = ["INT32", "INT64", "INT64"]
    specs = [("min", 1), ("max", 1), ("max", 2)]
    rg, pg = drive(one_agg([0], specs, kinds),
                   [([(I, (1, 5, 7)), (I, (1, 9, 2)), (I, (2, 4, 4))],),
                    ([(D, (1, 9, 2))],)])
    assert len(pg.node.spec.minputs) == len(rg.node.spec.minputs) == 2


def test_append_only_minmax():
    """An append-only input keeps min / max as one extreme column."""
    rng = np.random.default_rng(3)
    kinds = ["INT64", "INT64", "FLOAT64"]
    epochs = [([(I, (int(rng.integers(0, 30)), int(rng.integers(0, 999)),
                     float(rng.normal()))) for _ in range(60)],)
              for _ in range(4)]
    rg, pg = drive(one_agg([0], [("max", 1), ("min", 2), ("sum", 1),
                                 ("count", None)], kinds,
                           append_only=True), epochs)
    assert not pg.node.spec.minputs and pg.node.spec.append_only


def recovery_case(build, epochs, split):
    """Drive `split` epochs, build fresh executors over the same stores
    and drive on; both packages compared throughout, and the recovered
    port run's MV equal to an uninterrupted one's."""
    rg, pg = drive(build, epochs[:split])
    rg2 = Graph(REF, build, store=rg.store)
    pg2 = Graph(PORT, build, store=pg.store)
    drive(build, epochs[split:], graphs=(rg2, pg2))
    _, whole = drive(build, epochs)
    assert list(pg2.mv.iter_all()) == list(whole.mv.iter_all())
    return pg2


def test_agg_recovery():
    """:76 and :173 — count / sum, and a retractable max whose recovered
    extreme is then retracted."""
    kinds = ["INT32", "INT64"]
    recovery_case(one_agg([0], [("count", None), ("sum", 1)], kinds),
                  [([(I, (1, 10)), (I, (2, 20)), (I, (1, 5))],),
                   ([(I, (1, 100))],), ([(D, (2, 20))],)], 1)
    pg = recovery_case(
        one_agg([0], [("max", 1)], kinds),
        [([(I, (1, 10)), (I, (1, 20)), (I, (2, 7))],),
         ([(D, (1, 20))],)], 1)
    assert sorted(pg.mv.iter_all()) == [(1, 10), (2, 7)]
    recovery_case(one_agg([1], [("sum", 3), ("min", 2), ("count", 0)],
                          T_KINDS), random_t_epochs(19, 6), 3)


def test_watermark_cleans_group_state():
    """`DeviceHashAggExecutor._clean_state`: a group-key watermark drops
    the groups below it from the device state, the state table and the
    multiset tables (the MV keeps their rows); a later row of a dropped
    group starts it anew."""
    kinds = ["INT64", "INT64"]
    build = one_agg([0], [("count", None), ("max", 1)], kinds, wm=True)
    rg, pg = Graph(REF, build), Graph(PORT, build)
    epochs = [[(I, (k, k * 10 + j)) for k in range(6) for j in range(2)],
              [(I, (4, 1)), (I, (5, 2))], [(I, (1, 99)), (D, (5, 51))]]
    for e, rows in enumerate(epochs):
        for g in (rg, pg):
            if e == 1:
                g.node.input.pending.append(g.P.ops.Watermark(
                    0, g.P.T.INT64, 3))
        drive(None, [(rows,)], graphs=(rg, pg))
    assert sorted(r[0] for r in pg.node.state_table.iter_all()) == \
        [1, 3, 4, 5]
    keys, _ = pg.node.engine.live_main()
    assert len(keys) == 4
    # the MV keeps the cleaned groups' rows (its key is the whole row, so
    # group 1's new start is a row of its own)
    assert sorted(r[:2] for r in pg.mv.iter_all()) == \
        [(0, 2), (1, 1), (1, 2), (2, 2), (3, 2), (4, 3), (5, 2)]


def test_int_sum_overflow_guard():
    """An int sum whose pushed magnitude can no longer be proven to stay
    below 2^62 raises OverflowError in both packages."""
    kinds = ["INT32", "INT64"]
    for P in (REF, PORT):
        g = Graph(P, one_agg([0], [("sum", 1)], kinds))
        with pytest.raises(OverflowError):
            g.epoch([(I, (1, 2**61)), (I, (2, 2**61))])


def test_mesh_is_not_ported():
    """The executors' mesh arms run on the port's own Mesh
    (their parity: tests/test_torch_sharded_ops.py); what stays unported
    on a mesh, serving replicas, raises."""
    from risingwave_tpu_torch.parallel.mesh import make_mesh
    from risingwave_tpu_torch.parallel.sharded_agg import ShardedHashAgg
    from risingwave_tpu_torch.parallel.sharded_join import ShardedHashJoin
    P = PORT
    store = P.state.MemoryStateStore()
    src = Source(P, ["INT64", "INT64"], P.ops.BarrierInjector())
    mesh = make_mesh(4, devices=["cpu"])
    a = P.ops.DeviceHashAggExecutor(src.exec, [0], [], mesh=mesh,
                                    device="cpu")
    assert isinstance(a.engine, ShardedHashAgg) and a.engine.n == 4
    j = P.dj.DeviceHashJoinExecutor(src.exec, src.exec, [0], [0],
                                    mesh=mesh, device="cpu")
    assert isinstance(j.engine, ShardedHashJoin) and j.engine.n == 4
    agg = agg_exec(P, store, src.exec, [0], [], ["INT64", "INT64"])
    agg.rescale_mesh(mesh)
    assert isinstance(agg.engine, ShardedHashAgg)
    agg.rescale_mesh(None)
    assert not isinstance(agg.engine, ShardedHashAgg)
    with pytest.raises(NotImplementedError, match="item 8"):
        make_mesh(2, devices=["cpu"], replicas=2)


# ---------------------------------------------------------------------------
# DeviceHashJoinExecutor
# ---------------------------------------------------------------------------

A_KINDS = ["INT32", "VARCHAR", "INT64", "INT64"]        # k, s, x, id
B_KINDS = ["INT32", "INT64", "INT64"]                   # k, y, id


def two_sided(cond=None, capacity=8, pair_capacity=8):
    def build(P, store, inj):
        a = Source(P, A_KINDS, inj)
        b = Source(P, B_KINDS, inj)
        c = cond(P) if cond is not None else None
        return join_exec(P, store, a.exec, b.exec, [0], [0], c, capacity,
                         pair_capacity), [a, b]
    return build


def x_lt_y(P):
    return P.expr.build_func("less_than", [P.ref(2, "INT64"),
                                           P.ref(5, "INT64")])


def random_join_epochs(seed, n_epochs=3):
    """tests/test_device_seam.py:226 — NULL keys, inserts, deletes of
    a's rows above a threshold, updates of b's y."""
    rng = np.random.default_rng(seed)
    ta, tb = Table(rng), Table(rng)
    ids = iter(range(1 << 30))

    def key():
        return None if rng.random() < 0.1 else int(rng.integers(0, 8))
    epochs = []
    for _ in range(n_epochs):
        ar = ta.inserts(lambda: (key(), f"s{int(rng.integers(0, 3))}",
                                 int(rng.integers(0, 50)), next(ids)), 25)
        br = tb.inserts(lambda: (key(), int(rng.integers(0, 50)),
                                 next(ids)), 25)
        th, kd = int(rng.integers(25, 45)), int(rng.integers(0, 8))
        ar += ta.deletes(6, lambda r: r[2] > th)
        br += tb.updates(3, lambda r: (r[0], r[1] + 3, r[2]))
        epochs.append((ar, br))
    return epochs


@pytest.mark.parametrize("cond", [None, x_lt_y], ids=["equi", "x<y"])
def test_join_random_workload(cond):
    """Both packages' joins, from 8 slots and 8 pairs (growth replays)."""
    _, pg = drive(two_sided(cond), random_join_epochs(23, 4))
    assert pg.node.engine.growth_replays >= 1


def test_join_recovery():
    """:196 — retract against recovered state."""
    recovery_case(two_sided(), [
        ([(I, (1, "a", 10, 1)), (I, (2, "b", 20, 2))],
         [(I, (1, 100, 3)), (I, (2, 200, 4)), (I, (1, 101, 5))]),
        ([], [(D, (1, 100, 3))]),
        ([(I, (2, "c", 21, 6))], [])], 1)
    recovery_case(two_sided(x_lt_y), random_join_epochs(31, 5), 2)


def test_join_net_zero_reinsert_keeps_row_cache():
    """:239 — a delete and identical re-insert in one epoch nets to zero
    on the device; the host row cache must keep the row."""
    got = []
    for P in (REF, PORT):
        S = P.Schema.of(("k", P.T.INT64), ("v", P.T.INT64))

        class Stub(P.ops.Executor):
            pass
        j = P.dj.DeviceHashJoinExecutor(Stub(S), Stub(S), [0], [0],
                                         **P.exec_kw)

        def bar(e):
            return P.ops.Barrier(P.epoch.EpochPair(e, e - 1))
        kinds = ["INT64", "INT64"]
        j._process_chunk("a", P.chunk(kinds, [(I, (1, 10))]))
        j._process_chunk("b", P.chunk(kinds, [(I, (1, 100))]))
        out = list(j._on_barrier(bar(1)))
        j._process_chunk("a", P.chunk(kinds, [(D, (1, 10)), (I, (1, 10))]))
        out += list(j._on_barrier(bar(2)))
        j._process_chunk("b", P.chunk(kinds, [(I, (1, 101))]))
        last = list(j._on_barrier(bar(3)))
        assert [r for ch in last for _, r in ch.op_rows()] == \
            [(1, 10, 1, 101)]
        got.append([chunk_view(c) for c in out + last])
    assert got[0] == got[1]


def q5_shape(P, store, inj):
    """tests/test_device_join_netting.py's Q5_SHAPE at the executor level:
    A = count(*) by (w, g), B = max(num) by w over a second count by
    (w, g), A JOIN B ON A.w = B.w AND A.num >= B.maxn."""
    kinds = ["INT32", "VARCHAR"]
    src = Source(P, kinds, inj)
    shared = P.ops.SharedStream(src.exec)
    a = agg_exec(P, store, shared.subscribe(), [0, 1], [("count", None)],
                 kinds, tid=10)
    c = agg_exec(P, store, shared.subscribe(), [0, 1], [("count", None)],
                 kinds, tid=20)
    b = agg_exec(P, store, c, [0], [("max", 2)], ["INT32", "VARCHAR",
                                                 "INT64"], tid=40)
    cond = P.expr.build_func("greater_than_or_equal",
                             [P.ref(2, "INT64"), P.ref(4, "INT64")])
    return join_exec(P, store, a, b, [0], [0], cond, tid=60), [src]


def test_same_epoch_two_sided_change_nets_to_zero():
    """test_device_join_netting.py:22 — one epoch changes A (b's count 2
    -> 3) and B (maxn 2 -> 4); b's pair must vanish, not resurrect, and
    come back when b catches up."""
    rg, pg = Graph(REF, q5_shape), Graph(PORT, q5_shape)
    want = [[(1, "a", 2, 1, 2), (1, "b", 2, 1, 2)], [(1, "a", 4, 1, 4)],
            [(1, "a", 4, 1, 4), (1, "b", 4, 1, 4)]]
    epochs = [[(I, (1, "a")), (I, (1, "a")), (I, (1, "b")), (I, (1, "b"))],
              [(I, (1, "a")), (I, (1, "a")), (I, (1, "b"))],
              [(I, (1, "b"))]]
    for rows, w in zip(epochs, want):
        drive(None, [(rows,)], graphs=(rg, pg))
        assert sorted(pg.mv.iter_all()) == w


def test_q5_shape_multi_epoch():
    """:38 — counts racing the max over eight epochs."""
    rng = np.random.default_rng(5)
    epochs = [([(I, (int(rng.integers(0, 3)), f"g{int(rng.integers(0, 6))}"))
                for _ in range(20)],) for _ in range(8)]
    _, pg = drive(q5_shape, epochs)
    counts = {}
    for rows, in epochs:
        for _, r in rows:
            counts[r] = counts.get(r, 0) + 1
    maxn = {}
    for (w, g), n in counts.items():
        maxn[w] = max(maxn.get(w, 0), n)
    want = sorted((w, g, n, w, maxn[w]) for (w, g), n in counts.items()
                  if n >= maxn[w])
    assert sorted(pg.mv.iter_all()) == want


def test_decimal_outputs():
    """Integer sum / avg come out as Decimal, as the host path's."""
    _, pg = drive(one_agg([0], [("sum", 1), ("avg", 1)],
                          ["INT32", "INT64"]),
                  [([(I, (1, 3)), (I, (1, 4))],)])
    assert list(pg.mv.iter_all()) == [(1, Decimal(7), Decimal("3.5"))]
