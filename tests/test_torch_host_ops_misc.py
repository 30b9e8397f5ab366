"""The port's other host executors against the JAX package's, one case
for each case of the reference's tests/test_misc_executors.py,
test_watermark_eowc.py and test_exchange.py, and one level down from
the SQL-level union, ASOF, temporal, lookup and project-set tests
(tests/test_union_watermark.py, test_asof_join.py,
test_project_set_temporal.py, test_lookup_join.py): each executor built
as sql/planner.py builds it, with its state tables laid out as the
planner's `make_state` lays them out.

Each case runs the same graph in both packages on the same messages and
holds everything emitted, and every state table after every barrier,
equal (tests/host_parity.py). A case whose reference raises must raise
the same exception type in the port. Every wait on a thread or a
`ThreadedChannel` has a deadline, and reaching it fails the test."""
import threading
import time

import numpy as np
import pytest

from host_parity import (D, I, PKGS, UD, UI, assert_same, drive_exec,
                         drive_job, dump_store, fixed_epochs, norm_chunk,
                         fixed_row_ids, norm_msg, sources)  # noqa: F401

KV = ["INT64", "INT64"]


def both(fn, *args):
    ref, port = (fn(P, *args) for P in PKGS)
    assert_same(ref, port)
    return ref


def both_raise(fn, *args):
    """`fn` raises in both packages, with the same exception type."""
    kinds = []
    for P in PKGS:
        with pytest.raises(Exception) as ei:
            fn(P, *args)
        kinds.append(type(ei.value).__name__)
    assert kinds[0] == kinds[1], kinds


# ---------------------------------------------------------------------------
# Changelog / Now / DynamicFilter / Sort (test_misc_executors.py)
# ---------------------------------------------------------------------------


def bar(P, n):
    e = P.epoch.epoch_from_physical
    return P.msg.Barrier(P.msg.EpochPair(e(1000 + n), e(999 + n)))


def _changelog(P):
    feed = P.feed(KV, [P.chunk(KV, [(I, (1, 10)), (D, (2, 20)),
                                    (UD, (3, 30)), (UI, (3, 31))]),
                       bar(P, 1)])
    ex = P.ops.ChangelogExecutor(feed)
    return drive_exec(P, ex) + [("append_only", ex.append_only)]


def _now(P):
    feed = P.feed([], [bar(P, 1), bar(P, 2), bar(P, 3)])
    return drive_exec(P, P.ops.NowExecutor(feed))


def _rchunk(P, *op_vals):
    return P.chunk(["INT64"], [(o, (v,)) for o, v in op_vals])


def _df_bound_movement(P):
    left = P.feed(KV, [P.chunk(KV, [(I, (1, 10)), (I, (2, 50))]), bar(P, 1),
                       bar(P, 2), P.chunk(KV, [(I, (3, 25))]), bar(P, 3)])
    right = P.feed(["INT64"], [_rchunk(P, (I, 20)), bar(P, 1),
                               _rchunk(P, (I, 40)), bar(P, 2), bar(P, 3)])
    return drive_exec(P, P.ops.DynamicFilterExecutor(left, right, key_col=1,
                                                     cmp=">"))


def _df_bound_rise(P):
    left = P.feed(KV, [P.chunk(KV, [(I, (1, 30))]), bar(P, 1), bar(P, 2)])
    right = P.feed(["INT64"], [_rchunk(P, (I, 10)), bar(P, 1),
                               _rchunk(P, (UD, 10), (UI, 99)), bar(P, 2)])
    return drive_exec(P, P.ops.DynamicFilterExecutor(left, right, key_col=1,
                                                     cmp=">"))


def _df_rhs_delete(P):
    left = P.feed(KV, [P.chunk(KV, [(I, (1, 30))]), bar(P, 1), bar(P, 2)])
    right = P.feed(["INT64"], [_rchunk(P, (I, 10)), bar(P, 1),
                               _rchunk(P, (D, 10)), bar(P, 2)])
    return drive_exec(P, P.ops.DynamicFilterExecutor(left, right, key_col=1,
                                                     cmp=">"))


def _sort_other_watermarks(P):
    feed = P.feed(KV, [P.watermark(0, 5), bar(P, 1)], append_only=True)
    return drive_exec(P, P.ops.SortExecutor(feed, time_col=1))


def _sort_release(P):
    store = P.state.MemoryStateStore()
    feed = P.feed(KV, [P.chunk(KV, [(I, (1, 30)), (I, (2, 10))]),
                       P.watermark(1, 15), bar(P, 1),
                       P.chunk(KV, [(I, (3, 12)), (I, (4, 40))]),
                       P.watermark(1, 35), bar(P, 2)], append_only=True)
    st = P.state.StateTable(store, 5, [P.T.INT64, P.T.INT64], [0])
    return drive_exec(P, P.ops.SortExecutor(feed, time_col=1,
                                            state_table=st), [store])


MISC_CASES = {"changelog": _changelog, "now": _now,
              "dynamic_filter_bound_movement": _df_bound_movement,
              "dynamic_filter_bound_rise": _df_bound_rise,
              "dynamic_filter_rhs_delete": _df_rhs_delete,
              "sort_other_watermarks": _sort_other_watermarks,
              "sort_release_in_order": _sort_release}


@pytest.mark.parametrize("case", list(MISC_CASES))
def test_misc_executors(case):
    both(MISC_CASES[case])


# ---------------------------------------------------------------------------
# WatermarkFilter + emit-on-window-close HashAgg (test_watermark_eowc.py)
# ---------------------------------------------------------------------------


def _wm_filter(msgs_of, delay, recover=False):
    def run(P):
        store = P.state.MemoryStateStore()
        trace = []
        for msgs in msgs_of(P):
            st = (P.state.StateTable(store, 9, [P.T.INT64, P.T.INT64], [0])
                  if recover else None)
            wf = P.ops.WatermarkFilterExecutor(P.feed(KV, msgs), 0, delay,
                                               state_table=st)
            trace += drive_exec(P, wf, [store])
        return trace
    return run


def _rows(P, *rows):
    return P.chunk(KV, [(I, r) for r in rows])


WM_CASES = {
    "derives_and_emits": _wm_filter(lambda P: [[
        _rows(P, (10, 1), (20, 2)), P.barrier(1)]], 5),
    "filters_late_rows": _wm_filter(lambda P: [[
        _rows(P, (100, 1)), P.barrier(1),
        _rows(P, (10, 2), (99, 3), (200, 4)), P.barrier(2)]], 0),
    "own_chunk_max": _wm_filter(lambda P: [[
        _rows(P, (1, 1), (1, 2), (100, 3)), P.barrier(1)]], 0),
    "recovery": _wm_filter(lambda P: [
        [_rows(P, (50, 1)), P.barrier(1)],
        [_rows(P, (10, 9)), P.barrier(2)]], 0, recover=True),
}


def _eowc(msgs_of, stateful=False):
    def run(P):
        store = P.state.MemoryStateStore()
        trace = []
        for msgs in msgs_of(P):
            st = (P.state.StateTable(store, 7, [P.T.INT64, P.T.BYTEA], [0])
                  if stateful else None)
            agg = P.ops.HashAggExecutor(P.feed(KV, msgs), [0],
                                        [P.agg("count")], state_table=st,
                                        emit_on_window_close=True,
                                        window_col_in_group=0)
            trace += drive_exec(P, agg, [store])
        return trace
    return run


WM_CASES.update({
    "eowc_rows_before_watermark": _eowc(lambda P: [[
        _rows(P, (1, 1), (1, 2), (2, 3)), P.barrier(1),
        P.watermark(0, 2), P.barrier(2)]]),
    "eowc_late_rows_dropped": _eowc(lambda P: [[
        _rows(P, (1, 1)), P.watermark(0, 5), P.barrier(1),
        _rows(P, (1, 99)), P.barrier(2)]]),
    "eowc_open_windows_recovery": _eowc(lambda P: [
        [_rows(P, (8, 1), (8, 2)), P.barrier(1)],
        [P.watermark(0, 9), P.barrier(2)]], stateful=True),
})


@pytest.mark.parametrize("case", list(WM_CASES))
def test_watermark_eowc(case):
    both(WM_CASES[case])


def test_eowc_requires_window_col():
    both_raise(lambda P: P.ops.HashAggExecutor(
        P.feed(KV, []), [0], [P.agg("count")], emit_on_window_close=True))


# ---------------------------------------------------------------------------
# exchange (test_exchange.py)
# ---------------------------------------------------------------------------


def _kv_chunks(P, seed, n_chunks=6, rows=64, keys=10):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_chunks):
        ks, vs = rng.integers(0, keys, rows), rng.integers(0, 100, rows)
        out.append(P.chunk(KV, [(I, (int(k), int(v)))
                                for k, v in zip(ks, vs)]))
    return out


def _parallel_agg(P, n_actors):
    """source -> hash dispatch -> n agg fragments -> merge."""
    inj = P.ops.BarrierInjector()
    src = P.ops.SourceExecutor(P.schema(KV), P.ListReader(_kv_chunks(P, 5)),
                               inj)
    mids = [P.ops.Channel(capacity=1 << 20) for _ in range(n_actors)]
    disp = P.ops.DispatchExecutor(src, mids, kind="hash", key_indices=[0])
    outs, agg_disps, store = [], [], P.state.MemoryStateStore()
    for i in range(n_actors):
        merge_in = P.ops.MergeExecutor([mids[i]], P.schema(KV), pumps=[disp])
        agg = P.ops.HashAggExecutor(
            merge_in, [0], [P.agg("count"), P.agg("sum", 1)],
            state_table=P.state.StateTable(store, 10 + i,
                                           [P.T.INT64, P.T.BYTEA], [0]))
        out_ch = P.ops.Channel(capacity=1 << 20)
        outs.append(out_ch)
        agg_disps.append(P.ops.DispatchExecutor(agg, [out_ch],
                                                kind="simple"))
    final = P.ops.MergeExecutor(outs, None, pumps=agg_disps)
    inj.inject()
    inj.inject_stop()
    return drive_exec(P, final, [store])


@pytest.mark.parametrize("n_actors", [1, 2, 4])
def test_parallel_agg(fixed_epochs, n_actors):
    trace = both(_parallel_agg, n_actors)
    assert sum(m[0] == "barrier" for m in trace) == 2


class _OneShot:
    def __init__(self, P, chunks):
        self.schema, self.chunks = P.schema(KV), chunks

    def execute(self):
        yield from self.chunks


def _drain(P, chans):
    out = []
    for ch in chans:
        m = ch.recv()
        while m is not None:
            out.append(norm_msg(P, m))
            m = ch.recv()
        out.append("|")
    return out


def _update_pair_split(P):
    chans = [P.ops.Channel(), P.ops.Channel()]
    vn, n = P.vnode.vnode_of_row, P.vnode.VNODE_COUNT
    k1 = next(k for k in range(1, 100)
              if (vn([k]) * 2) // n != (vn([0]) * 2) // n)
    chunk = P.chunk(KV, [(UD, (0, 1)), (UI, (k1, 2))])
    P.ops.DispatchExecutor(_OneShot(P, [chunk]), chans, kind="hash",
                           key_indices=[0]).pump_until_barrier()
    return _drain(P, chans)


def _broadcast_round_robin(P):
    chunk = P.chunk(KV, [(I, (1, 1))])
    out = []
    for kind in ("broadcast", "round_robin"):
        chans = [P.ops.Channel(), P.ops.Channel()]
        P.ops.DispatchExecutor(_OneShot(P, [chunk, chunk]), chans,
                               kind=kind).pump_until_barrier()
        out += [kind, len(chans[0]), len(chans[1])] + _drain(P, chans)
    return out


def _merge_min_watermark(P):
    a, b = P.ops.Channel(), P.ops.Channel()
    m = P.ops.MergeExecutor([a, b], P.schema(KV))
    bk = P.msg.BarrierKind.CHECKPOINT
    b1 = P.msg.Barrier(P.msg.EpochPair(2, 1), bk)
    stop = P.msg.Barrier(P.msg.EpochPair(3, 2), bk)
    stop.mutation = P.msg.Mutation(P.msg.MutationKind.STOP)
    for ch, w in ((a, 10), (b, 5)):
        ch.send(P.watermark(0, w))
        ch.send(b1)
        ch.send(stop)
    return drive_exec(P, m)


EXCHANGE_CASES = {"update_pair_split": _update_pair_split,
                  "broadcast_round_robin": _broadcast_round_robin,
                  "merge_min_watermark": _merge_min_watermark}


@pytest.mark.parametrize("case", list(EXCHANGE_CASES))
def test_exchange(case):
    both(EXCHANGE_CASES[case])


DEADLINE_S = 60.0


def _threaded_pump(P):
    """A fragment (HashAgg) pumped by a thread of its own into a
    two-chunk `ThreadedChannel`, merged on this thread: the producer
    blocks on the channel's capacity and its stalls reach the pressure
    board. The merge's idle hook fails the case past its deadline. The
    store is read on the producer's thread as each barrier leaves the
    fragment, before the fragment reads the next epoch: read on the
    merge's side it could already hold a later epoch's commit."""
    store = P.state.MemoryStateStore()
    e = P.epoch.epoch_from_physical
    msgs = []
    for k, c in enumerate(_kv_chunks(P, 7, n_chunks=12, rows=32)):
        msgs += [c, c.project([0, 1])]
        if k % 3 == 2:
            msgs.append(P.msg.Barrier(P.msg.EpochPair(e(10 + k), e(9 + k))))
    stop = P.msg.Barrier(P.msg.EpochPair(e(99), e(98)))
    stop.mutation = P.msg.Mutation(P.msg.MutationKind.STOP)
    src = P.feed(KV, msgs + [stop])
    agg = P.ops.HashAggExecutor(
        src, [0], [P.agg("count"), P.agg("sum", 1)],
        state_table=P.state.StateTable(store, 10, [P.T.INT64, P.T.BYTEA],
                                       [0]))
    ch = P.mod("ops.exchange").ThreadedChannel(capacity=2)
    pump = P.ops.FragmentPump(agg, ch)
    errors, stores = [], []

    def produce():
        try:
            while pump.pump_until_barrier() is not None:
                stores.append(dump_store(store))
        except Exception as exc:        # noqa: BLE001 — reported below
            errors.append(exc)
            ch.close()
    t = threading.Thread(target=produce, daemon=True)
    merge = P.ops.MergeExecutor([ch], agg.schema)
    deadline = time.monotonic() + DEADLINE_S

    def health():
        if time.monotonic() > deadline:
            ch.close()
            raise TimeoutError("threaded pump: deadline reached")
    merge.health_check = health
    P.mod("utils.overload").PRESSURE.reset()
    t.start()
    trace = []
    for m in merge.execute():
        health()
        trace.append(norm_msg(P, m))
    t.join(timeout=DEADLINE_S)
    assert not t.is_alive(), "threaded pump: producer thread still running"
    assert not errors, errors
    assert len(stores) == sum(m[0] == "barrier" for m in trace) > 0
    return trace + [("stores", s) for s in stores]


def test_threaded_channel_fragment_pump():
    both(_threaded_pump)


# ---------------------------------------------------------------------------
# Union / ProjectSet watermarks (test_union_watermark.py)
# ---------------------------------------------------------------------------


def _union(script_a, script_b):
    def run(P):
        def msgs(script):
            return [P.watermark(0, x) if kind == "wm" else P.barrier(x)
                    for kind, x in script]
        return drive_exec(P, P.ops.UnionExecutor(
            [P.feed(KV, msgs(script_a)), P.feed(KV, msgs(script_b))]))
    return run


UNION_CASES = {
    "min_across_inputs": _union([("wm", 10), ("b", 1), ("wm", 30), ("b", 2)],
                                [("wm", 20), ("b", 1), ("wm", 25), ("b", 2)]),
    "no_emission_until_all": _union([("wm", 10), ("b", 1), ("b", 2)],
                                    [("b", 1), ("wm", 5), ("b", 2)]),
    "release_on_input_death": _union([("b", 1)],
                                     [("wm", 10), ("b", 1), ("wm", 20),
                                      ("b", 2)]),
    "non_decreasing": _union([("wm", 10), ("b", 1), ("wm", 11), ("b", 2)],
                             [("wm", 40), ("b", 1), ("b", 2)]),
}


@pytest.mark.parametrize("case", list(UNION_CASES))
def test_union_watermark(case):
    both(UNION_CASES[case])


def test_union_chunks_and_rows(fixed_epochs, fixed_row_ids):
    """Union of two ListReader sources under a RowIdGen, as the planner's
    UNION ALL branches come out of tables without a primary key."""
    def run(P):
        store = P.state.MemoryStateStore()
        inj = P.ops.BarrierInjector()
        readers, srcs = sources(P, inj, [KV, KV])
        u = P.ops.UnionExecutor(srcs)
        rid = P.ops.RowIdGenExecutor(
            P.ops.ProjectExecutor(u, [P.ref(0, "INT64"), P.ref(1, "INT64"),
                                      P.lit(None, "INT64")]), 2)
        table = P.state.StateTable(store, 1, rid.schema.dtypes, [2])
        mat = P.ops.MaterializeExecutor(rid, table)
        feeds = [[[P.chunk(KV, [(I, (k, k * 10)) for k in range(e, e + 3)])],
                  [P.chunk(KV, [(I, (k, -k)) for k in range(e, e + 2)])]]
                 for e in range(3)]
        return drive_job(P, mat, inj, [store], readers, feeds)
    both(run)


def test_project_set_watermark_carry():
    def run(P):
        tf = P.ops.BoundTableFunction(
            "generate_series", [P.lit(1, "INT64"), P.ref(1, "INT64")],
            P.T.INT64)
        src = P.feed(KV, [P.watermark(0, 42), P.barrier(1)])
        return drive_exec(P, P.ops.ProjectSetExecutor(
            src, [("tf", tf)], ["g"], carry=[0, 1]))
    trace = both(run)
    assert ("wm", 1) == trace[0][:2]


# ---------------------------------------------------------------------------
# ASOF join (test_asof_join.py), one level down
# ---------------------------------------------------------------------------

TRADES = ["VARCHAR", "INT64", "INT64", "INT64"]     # tk, tt, qty, _row_id
QUOTES = ["VARCHAR", "INT64", "INT64", "INT64"]     # qk, qt, px, _row_id


def _store(P, tmp, store=None):
    """A fresh MemoryStateStore, or (given a directory) a SpillStateStore
    of this package's own subdirectory — opened anew on a restart, as a
    restarted process opens its data directory."""
    if tmp is None:
        return store or P.state.MemoryStateStore()
    d = tmp / P.root
    d.mkdir(exist_ok=True)
    return P.state.SpillStateStore(str(d))


def _asof_job(P, store, op, left_outer, epochs, readers_out, tid=10):
    """Trades ASOF [LEFT] JOIN quotes ON tk = qk AND tt <op> qt, as
    `_plan_asof_join` builds it (both sides' state tables keyed by the
    whole row), projected to (tk, tt, qty, qt, px) + the trade's row id
    (the MV's stream key)."""
    inj = P.ops.BarrierInjector()
    readers, (l, r) = sources(P, inj, [TRADES, QUOTES])
    readers_out += readers
    ls = P.state.StateTable(store, tid, [P.dt(k) for k in TRADES], [0, 1, 2, 3])
    rs = P.state.StateTable(store, tid + 1, [P.dt(k) for k in QUOTES],
                            [0, 1, 2, 3])
    j = P.ops.AsOfJoinExecutor(l, r, [0], [0], 1, 1, op,
                               left_outer=left_outer, left_pk=[3],
                               right_pk=[3], left_state=ls, right_state=rs)
    out = [P.ref(0, "VARCHAR"), P.ref(1, "INT64"), P.ref(2, "INT64"),
           P.ref(5, "INT64"), P.ref(6, "INT64"), P.ref(3, "INT64")]
    p = P.ops.ProjectExecutor(j, out)
    mv = P.state.StateTable(store, tid + 2, p.schema.dtypes, [5])
    return P.ops.MaterializeExecutor(p, mv), inj


def _trade(tk, tt, qty, rid, op=I):
    return (op, (tk, tt, qty, rid))


def _asof_case(op, left_outer, epochs, restart_after=None):
    """epochs: per barrier, (trade rows, quote rows)."""
    def run(P, tmp=None):
        store = _store(P, tmp)
        cut = len(epochs) if restart_after is None else restart_after
        trace = []
        for part in (epochs[:cut], epochs[cut:]):
            if not part:
                continue
            store = _store(P, tmp, store)
            readers = []
            mat, inj = _asof_job(P, store, op, left_outer, part, readers)
            feeds = [[[P.chunk(TRADES, t)] if t else [],
                      [P.chunk(QUOTES, q)] if q else []] for t, q in part]
            trace += drive_job(P, mat, inj, [store], readers, feeds)
        return trace
    return run


ASOF_CASES = {
    "picks_latest": _asof_case(">=", False, [
        ([_trade("a", 25, 1, 0)], [_trade("a", 10, 100, 0),
                                   _trade("a", 20, 200, 1),
                                   _trade("a", 30, 300, 2)])]),
    "no_match": _asof_case(">=", False, [
        ([_trade("a", 25, 1, 0), _trade("b", 99, 2, 1)],
         [_trade("a", 50, 500, 0)])]),
    "better_quote_displaces": _asof_case(">=", False, [
        ([_trade("a", 25, 1, 0)], [_trade("a", 10, 100, 0)]),
        ([], [_trade("a", 20, 200, 1)]),
        ([], [_trade("a", 20, 200, 1, D)])]),
    "trade_delete_retracts": _asof_case(">=", False, [
        ([_trade("a", 25, 1, 0)], [_trade("a", 10, 100, 0)]),
        ([_trade("a", 25, 1, 0, D)], [])]),
    "strict_inequality": _asof_case(">", False, [
        ([_trade("a", 25, 9, 0)], [_trade("a", 25, 1, 0),
                                   _trade("a", 10, 2, 1)])]),
    "forward_direction": _asof_case("<=", False, [
        ([_trade("a", 25, 9, 0)], [_trade("a", 40, 1, 0),
                                   _trade("a", 30, 2, 1),
                                   _trade("a", 10, 3, 2)])]),
    "left_null_padding_then_match": _asof_case(">=", True, [
        ([_trade("a", 25, 1, 0)], []),
        ([], [_trade("a", 20, 200, 0)]),
        ([], [_trade("a", 20, 200, 0, D)])]),
    "left_multiple_keys": _asof_case(">=", True, [
        ([_trade("a", 25, 1, 0), _trade("b", 3, 2, 1),
          _trade("c", 7, 3, 2)],
         [_trade("a", 10, 100, 0), _trade("b", 5, 50, 1)])]),
}


@pytest.mark.parametrize("case", list(ASOF_CASES))
def test_asof_join(fixed_epochs, case):
    both(ASOF_CASES[case])


def test_asof_join_recovery(fixed_epochs, tmp_path):
    """TestAsOfRecovery: a second job over the same spill store picks the
    join's state up and keeps maintaining it."""
    both(_asof_case(">=", False, [
        ([_trade("a", 25, 1, 0)], [_trade("a", 10, 100, 0)]),
        ([], [_trade("a", 20, 200, 1)])], restart_after=1), tmp_path)


# ---------------------------------------------------------------------------
# temporal join (test_project_set_temporal.py), one level down
# ---------------------------------------------------------------------------

FACT = ["INT64", "INT64", "INT64"]           # k, v, _row_id
DIM = ["INT64", "VARCHAR"]                   # k (primary key), name


def _temporal_case(outer, epochs, restart_after=None):
    """fact JOIN dim FOR SYSTEM_TIME AS OF PROCTIME() ON f.k = d.k, as
    `_plan_temporal_join` builds it (the version table's state keyed by
    its pk), projected to (v, name) + fact row id + dim pk."""
    def run(P, tmp=None):
        store = _store(P, tmp)
        cut = len(epochs) if restart_after is None else restart_after
        trace = []
        for part in (epochs[:cut], epochs[cut:]):
            if not part:
                continue
            store = _store(P, tmp, store)
            inj = P.ops.BarrierInjector()
            readers, (l, r) = sources(P, inj, [FACT, DIM])
            rs = P.state.StateTable(store, 10, [P.dt(k) for k in DIM], [0])
            j = P.ops.TemporalJoinExecutor(l, r, [0], [0], outer=outer,
                                           right_pk=[0], right_state=rs)
            p = P.ops.ProjectExecutor(j, [P.ref(1, "INT64"),
                                          P.ref(4, "VARCHAR"),
                                          P.ref(2, "INT64"),
                                          P.ref(3, "INT64")])
            mv = P.state.StateTable(store, 11, p.schema.dtypes, [2, 3])
            feeds = [[[P.chunk(FACT, f)] if f else [],
                      [P.chunk(DIM, d)] if d else []] for f, d in part]
            trace += drive_job(P, P.ops.MaterializeExecutor(p, mv), inj,
                               [store], readers, feeds)
        return trace
    return run


TEMPORAL_CASES = {
    "inner_lookup": _temporal_case(False, [
        ([], [(I, (1, "one")), (I, (2, "two"))]),
        ([(I, (1, 100, 0)), (I, (3, 300, 1))], [])]),
    "no_retraction_on_version_change": _temporal_case(False, [
        ([], [(I, (1, "one")), (I, (2, "two"))]),
        ([(I, (1, 100, 0))], []),
        ([], [(UD, (1, "one")), (UI, (1, "uno"))]),
        ([(I, (1, 101, 1))], []),
        ([], [(D, (1, "uno"))]),
        ([(I, (1, 102, 2))], [])]),
    "left_outer": _temporal_case(True, [
        ([], [(I, (1, "one")), (I, (2, "two"))]),
        ([(I, (1, 100, 0)), (I, (3, 300, 1))], [])]),
}


@pytest.mark.parametrize("case", list(TEMPORAL_CASES))
def test_temporal_join(fixed_epochs, case):
    both(TEMPORAL_CASES[case])


def test_temporal_join_recovery(fixed_epochs, tmp_path):
    both(_temporal_case(False, [
        ([], [(I, (1, "one"))]),
        ([(I, (1, 100, 0))], []),
        ([(I, (1, 200, 1))], [])], restart_after=2), tmp_path)


# ---------------------------------------------------------------------------
# project set / table functions (test_project_set_temporal.py)
# ---------------------------------------------------------------------------


def _series_scan(args):
    """FROM generate_series(...) / unnest(ARRAY[...]): the planner's
    TableFunctionScan over a barrier source, into an MV keyed by the
    hidden row ordinal."""
    def run(P):
        store = P.state.MemoryStateStore()
        inj = P.ops.BarrierInjector()
        name, vals = args(P)
        rt = vals[0].return_type if name == "unnest" else \
            P.mod("ops.project_set").series_return_type(
                [v.return_type for v in vals])
        tf = P.ops.BoundTableFunction(name, vals, rt)
        scan = P.ops.TableFunctionScanExecutor(tf, name,
                                               P.ops.BarrierSource(inj))
        mv = P.state.StateTable(store, 1, scan.schema.dtypes, [1])
        return drive_job(P, P.ops.MaterializeExecutor(scan, mv), inj,
                         [store], max_barriers=4)
    return run


def _ints(*vs):
    return lambda P: ("generate_series", [P.lit(v, "INT64") for v in vs])


def _ts_series(P):
    iv = P.mod("core.dtypes").parse_interval
    t0 = 1704067200000000
    return ("generate_series", [P.lit(t0, "TIMESTAMP"),
                                P.lit(t0 + 7_200_000_000, "TIMESTAMP"),
                                P.expr.Literal(iv("1 hour"),
                                               P.T.INTERVAL)])


def _date_series(P):
    iv = P.mod("core.dtypes").parse_interval
    d0, day = 1704067200000000, 86_400_000_000
    return ("generate_series", [P.lit(d0, "TIMESTAMP"),
                                P.lit(d0 + 3 * day, "TIMESTAMP"),
                                P.expr.Literal(iv("1 day"), P.T.INTERVAL)])


SERIES_CASES = {
    "series_1_5": _series_scan(_ints(1, 5)),
    "series_step_3": _series_scan(_ints(1, 10, 3)),
    "series_negative_step": _series_scan(_ints(5, 1, -2)),
    "series_empty": _series_scan(_ints(5, 1)),
    "series_mv_2_6_2": _series_scan(_ints(2, 6, 2)),
    "series_timestamps": _series_scan(_ts_series),
    "series_date_bounds": _series_scan(_date_series),
    "unnest": _series_scan(lambda P: ("unnest", [P.lit(v, "INT64")
                                                for v in (7, 7, 8)])),
}


@pytest.mark.parametrize("case", list(SERIES_CASES))
def test_table_function_scan(fixed_epochs, case):
    both(SERIES_CASES[case])


def test_generate_series_zero_step_raises(fixed_epochs):
    both_raise(_series_scan(_ints(1, 5, 0)))


T2 = ["INT64", "INT64", "INT64"]             # a, b, _row_id


def _project_set(items, epochs):
    """SELECT <items> FROM t: ProjectSet over the table's changes, the
    upstream row id carried, into an MV keyed by (row id, projected row
    id) — `_plan_project_set`."""
    def run(P):
        store = P.state.MemoryStateStore()
        inj = P.ops.BarrierInjector()
        readers, (src,) = sources(P, inj, [T2])
        its, names = items(P)
        ps = P.ops.ProjectSetExecutor(src, its, names, carry=[2])
        n = len(its)
        mv = P.state.StateTable(store, 1, ps.schema.dtypes, [n, n + 1])
        feeds = [[[P.chunk(T2, rows)]] for rows in epochs]
        return drive_job(P, P.ops.MaterializeExecutor(ps, mv), inj, [store],
                         readers, feeds)
    return run


def _gs(P, a, b):
    return P.ops.BoundTableFunction("generate_series", [a, b], P.T.INT64)


PROJECT_SET_CASES = {
    "expands_and_retracts": _project_set(
        lambda P: ([("s", P.ref(0, "INT64")),
                    ("tf", _gs(P, P.ref(0, "INT64"), P.ref(1, "INT64")))],
                   ["a", "g"]),
        [[(I, (1, 3, 0)), (I, (10, 11, 1))],
         [(D, (1, 3, 0)), (I, (20, 20, 2))],
         [(UD, (10, 11, 1)), (UI, (10, 12, 1))]]),
    "zip_null_padding": _project_set(
        lambda P: ([("s", P.ref(0, "INT64")),
                    ("tf", _gs(P, P.lit(1, "INT64"), P.lit(2, "INT64"))),
                    ("tf", P.ops.BoundTableFunction(
                        "unnest", [P.ref(0, "INT64"), P.ref(1, "INT64"),
                                   P.lit(99, "INT64")], P.T.INT64))],
                   ["a", "g", "u"]),
        [[(I, (10, 11, 0))]]),
    "empty_expansion_drops_row": _project_set(
        lambda P: ([("tf", _gs(P, P.ref(0, "INT64"), P.ref(1, "INT64")))],
                   ["g"]),
        [[(I, (5, 1, 0)), (I, (1, 2, 1))]]),
}


@pytest.mark.parametrize("case", list(PROJECT_SET_CASES))
def test_project_set(fixed_epochs, case):
    both(PROJECT_SET_CASES[case])


# ---------------------------------------------------------------------------
# lookup (delta) join (test_lookup_join.py), one level down
# ---------------------------------------------------------------------------

USERS = ["INT64", "VARCHAR"]                 # uid (pk), name
ORDERS = ["INT64", "INT64", "INT64"]         # oid (pk), uid, amt


class _Tables:
    """users and orders as the Database keeps them: each table's
    materialize job over its state table (users pk uid; orders pk oid)
    and the index orders_by_uid (the table's rows, pk (uid, oid);
    `_create_index`) — the arrangements a
    lookup join probes, each run to its barrier before the join's."""

    def __init__(self, P, store, tid=10):
        self.P, self.store = P, store
        self.jobs, self.readers = [], []
        dt = lambda ks: [P.dt(k) for k in ks]          # noqa: E731
        self.users = P.state.StateTable(store, tid, dt(USERS), [0])
        self.orders = P.state.StateTable(store, tid + 1, dt(ORDERS), [0])
        self.by_uid = P.state.StateTable(store, tid + 2, dt(ORDERS), [1, 0])
        for kinds, table in ((USERS, self.users), (ORDERS, self.orders),
                             (ORDERS, self.by_uid)):
            inj = P.ops.BarrierInjector()
            (reader,), (src,) = sources(P, inj, [kinds])
            self.jobs.append(P.StreamJob(P.ops.MaterializeExecutor(
                src, table), inj, store))
            self.readers.append(reader)
        for j in self.jobs:
            j.run_until_barrier()

    def apply(self, users, orders):
        for reader, kinds, rows in ((self.readers[0], USERS, users),
                                    (self.readers[1], ORDERS, orders),
                                    (self.readers[2], ORDERS, orders)):
            if rows:
                reader.push(self.P.chunk(kinds, rows))
        for j in self.jobs:
            j.run_until_barrier()


def _lookup_case(epochs, restart_after=None, hash_join=False):
    """SELECT o.amt, u.name FROM orders o JOIN users u ON o.uid = u.uid:
    the join's inputs are the tables' change streams, its arrangements
    the index and the users table (`_try_lookup_join`); with
    `hash_join`, the HashJoin the planner falls back to."""
    def run(P, tmp=None):
        store = _store(P, tmp)
        tables = _Tables(P, store)
        cut = len(epochs) if restart_after is None else restart_after
        trace = []
        for part in (epochs[:cut], epochs[cut:]):
            if not part:
                continue
            inj = P.ops.BarrierInjector()
            readers, (o, u) = sources(P, inj, [ORDERS, USERS])
            if hash_join:
                j = P.ops.HashJoinExecutor(o, u, [1], [0], P.ops.JoinType.INNER)
            else:
                j = P.mod("ops.lookup_join").LookupJoinExecutor(
                    o, u, [1], [0], tables.by_uid,
                                             tables.users)
            p = P.ops.ProjectExecutor(j, [P.ref(2, "INT64"),
                                          P.ref(4, "VARCHAR"),
                                          P.ref(0, "INT64"),
                                          P.ref(3, "INT64")])
            mv = P.state.StateTable(store, 20, p.schema.dtypes, [2, 3])
            job = P.StreamJob(P.ops.MaterializeExecutor(p, mv), inj, store)
            job.collect_output = True
            job.run_until_barrier()
            for users, orders in part:
                tables.apply(users, orders)
                for r, kinds, rows in ((readers[0], ORDERS, orders),
                                       (readers[1], USERS, users)):
                    if rows:
                        r.push(P.chunk(kinds, rows))
                b = job.run_until_barrier()
                trace.append((norm_msg(P, b),
                              [norm_chunk(c) for c in job.output_chunks],
                              dump_store(store)))
                job.output_chunks.clear()
            trace.append(("name", type(j).__name__))
        return trace
    return run


_DRIVE = [([(I, (1, "ann")), (I, (2, "bo"))],
           [(I, (10, 1, 100)), (I, (11, 2, 200)), (I, (12, 3, 300))])]
LOOKUP_CASES = {
    "parity_with_hash_join": _lookup_case(_DRIVE),
    "hash_join_fallback": _lookup_case(_DRIVE, hash_join=True),
    "updates_both_sides": _lookup_case(_DRIVE + [
        ([(I, (3, "cy"))], []),
        ([(D, (1, "ann"))], []),
        ([], [(D, (11, 2, 200))])]),
    "same_epoch_both_sides": _lookup_case([
        ([(I, (7, "zed"))], [(I, (70, 7, 700))])]),
}


@pytest.mark.parametrize("case", list(LOOKUP_CASES))
def test_lookup_join(fixed_epochs, case):
    both(LOOKUP_CASES[case])


def test_lookup_join_non_indexed_key_raises():
    """A join key that is no pk prefix of the arrangement: the planner
    falls back to the hash join because the executor refuses it."""
    def run(P):
        store = P.state.MemoryStateStore()
        tables = _Tables(P, store)
        inj = P.ops.BarrierInjector()
        _, (o, u) = sources(P, inj, [ORDERS, USERS])
        P.mod("ops.lookup_join").LookupJoinExecutor(
            o, u, [2], [0], tables.orders, tables.users)
    both_raise(run)


def test_lookup_join_recovery_is_stateless(fixed_epochs, tmp_path):
    both(_lookup_case([
        ([(I, (1, "ann"))], [(I, (10, 1, 100))]),
        ([], [(I, (11, 1, 111))])], restart_after=1), tmp_path)


def test_lookup_join_matches_hash_join(fixed_epochs):
    """TestLookupJoin.test_parity_with_hash_join: in each package the
    lookup join's MV equals the hash join's."""
    for P in PKGS:
        mvs = []
        for hj in (False, True):
            trace = _lookup_case(_DRIVE, hash_join=hj)(P)
            mvs.append([rows for tid, rows in trace[-2][2] if tid == 20])
        assert mvs[0] == mvs[1] and len(mvs[0][0]) == 2, mvs


# ---------------------------------------------------------------------------
# the stateless executors no reference test above drives at this level
# ---------------------------------------------------------------------------


def _stateless(build, pk):
    """source -> build -> Materialize(pk), a barrier after each chunk of
    inserts, updates and deletes."""
    def run(P):
        store = P.state.MemoryStateStore()
        inj = P.ops.BarrierInjector()
        readers, (src,) = sources(P, inj, [KV])
        node = build(P, src, inj)
        mv = P.state.StateTable(store, 1, node.schema.dtypes, pk)
        feeds = [[[P.chunk(KV, rows)]] for rows in (
            [(I, (1, 10)), (I, (2, 20)), (I, (3, 30))],
            [(UD, (2, 20)), (UI, (2, 25)), (D, (1, 10))],
            [(I, (4, 40)), (UD, (3, 30)), (UI, (3, 5))])]
        return drive_job(P, P.ops.MaterializeExecutor(
            node, mv, P.ops.ConflictBehavior.OVERWRITE), inj, [store],
            readers, feeds)
    return run


STATELESS_CASES = {
    "filter_update_pairs": _stateless(lambda P, src, inj: P.ops.FilterExecutor(
        src, P.func("greater_than", P.ref(1, "INT64"), P.lit(15, "INT64"))),
        [0]),
    "project_arith": _stateless(lambda P, src, inj: P.ops.ProjectExecutor(
        src, [P.ref(0, "INT64"), P.func("multiply", P.ref(1, "INT64"),
                                       P.lit(3, "INT64"))]), [0]),
    "expand_subsets": _stateless(lambda P, src, inj: P.ops.ExpandExecutor(
        src, [[0], [1], [0, 1]]), [0, 1, 2]),
    "stateless_simple_agg": _stateless(
        lambda P, src, inj: P.ops.StatelessSimpleAggExecutor(
            src, [P.agg("count"), P.agg("sum", 1)]), []),
    "values_union": _stateless(lambda P, src, inj: P.ops.UnionExecutor([
        src, P.ops.ValuesExecutor(P.schema(KV), [(7, 70), (8, 80)],
                                  P.ops.BarrierSource(inj))]), [0]),
}


@pytest.mark.parametrize("case", list(STATELESS_CASES))
def test_stateless_executors(fixed_epochs, case):
    both(STATELESS_CASES[case])
