"""The port's host executors against the JAX package's: HashAgg,
SimpleAgg, HashJoin, TopN, Dedup, HopWindow and OverWindow, one case for
each case of the reference's tests/test_stateful_ops.py.

Each case builds the same graph in both packages — ListReader-fed
`SourceExecutor`s -> the executor under test -> `MaterializeExecutor`
under a `StreamJob` over a `MemoryStateStore` — and feeds it the same
chunks, all in one epoch as the reference test does (`one_epoch`) or a
barrier after each chunk (`per_chunk`). After every barrier the MV's
input chunks (ops, visibility, values, validity) and every state table's
rows must be equal, exactly: floats by their bits, a host agg's pickled
group state by its unpickled fields (tests/host_parity.py)."""
import numpy as np
import pytest

from host_parity import (D, I, PKGS, UD, UI, assert_same, drive_job,
                         epoch_feeds, fixed_epochs, sources)  # noqa: F401

KV = ["INT64", "INT64"]
AB = ["INT64", "VARCHAR"]
FEEDS = pytest.mark.parametrize("per_chunk", [False, True],
                                ids=["one_epoch", "per_chunk"])


def pipeline(P, specs, chunk_lists, build, pk, per_chunk,
             conflict="OVERWRITE"):
    """sources -> build(P, store, *sources) -> Materialize(pk)."""
    store = P.state.MemoryStateStore()
    inj = P.ops.BarrierInjector()
    readers, srcs = sources(P, inj, specs)
    node = build(P, store, *srcs)
    table = P.state.StateTable(store, 1, node.schema.dtypes, list(pk))
    mat = P.ops.MaterializeExecutor(node, table,
                                    getattr(P.ops.ConflictBehavior, conflict))
    return drive_job(P, mat, inj, [store], readers,
                     epoch_feeds(P, specs, chunk_lists, per_chunk))


def both(fn, *args):
    """The trace of `fn(P, *args)` in each package, held equal."""
    ref, port = (fn(P, *args) for P in PKGS)
    assert_same(ref, port)
    return ref


def agg_state(P, store, tid=10):
    return P.state.StateTable(store, tid, [P.T.INT64, P.T.BYTEA], [0])


# ---------------------------------------------------------------------------
# HashAgg / SimpleAgg
# ---------------------------------------------------------------------------


AGG_CASES = {
    # test_count_sum_grouped
    "count_sum_grouped": (
        [[(I, (1, 10)), (I, (1, 20)), (I, (2, 5))],
         [(I, (2, 7)), (D, (1, 10))]],
        lambda P, st, src: P.ops.HashAggExecutor(
            src, [0], [P.agg("count"), P.agg("sum", 1), P.agg("min", 1)],
            state_table=agg_state(P, st))),
    # test_group_deletion_emits_delete
    "group_deletion": (
        [[(I, (1, 10))], [(D, (1, 10))]],
        lambda P, st, src: P.ops.HashAggExecutor(src, [0],
                                                 [P.agg("count")])),
    # test_updates_collapse
    "updates_collapse": (
        [[(I, (1, 10))], [(UD, (1, 10)), (UI, (1, 99))]],
        lambda P, st, src: P.ops.HashAggExecutor(
            src, [0], [P.agg("sum", 1), P.agg("max", 1)])),
    # test_distinct_agg
    "distinct_agg": (
        [[(I, (1, 7)), (I, (1, 7)), (I, (1, 9))]],
        lambda P, st, src: P.ops.HashAggExecutor(
            src, [0], [P.agg("count", 1, distinct=True), P.agg("count")],
            state_table=agg_state(P, st))),
}


@FEEDS
@pytest.mark.parametrize("case", list(AGG_CASES))
def test_hash_agg(fixed_epochs, case, per_chunk):
    chunks, build = AGG_CASES[case]
    both(pipeline, [KV], [chunks], build, (0,), per_chunk)


def _recovery(P):
    """test_agg_state_recovery: a second job over the same store resumes
    from the first's group states."""
    store = P.state.MemoryStateStore()
    trace = []
    for rows in ([(I, (1, 10)), (I, (1, 5))], [(I, (1, 1))]):
        inj = P.ops.BarrierInjector()
        readers, (src,) = sources(P, inj, [KV])
        agg = P.ops.HashAggExecutor(src, [0], [P.agg("sum", 1)],
                                    state_table=agg_state(P, store))
        table = P.state.StateTable(store, 1, agg.schema.dtypes, [0])
        mat = P.ops.MaterializeExecutor(agg, table,
                                        P.ops.ConflictBehavior.OVERWRITE)
        trace += drive_job(P, mat, inj, [store], readers,
                           [[[P.chunk(KV, rows)]]])
    return trace


def test_hash_agg_state_recovery(fixed_epochs):
    both(_recovery)


SIMPLE_CASES = {
    # test_global_count_empty_and_updates
    "global_count": ([[(I, (1, 10)), (I, (2, 20))]],
                     lambda P, st, src: P.ops.SimpleAggExecutor(
                         src, [P.agg("count"), P.agg("sum", 1)])),
    # test_zero_rows_emits_initial
    "zero_rows": ([], lambda P, st, src: P.ops.SimpleAggExecutor(
        src, [P.agg("count")])),
}


@FEEDS
@pytest.mark.parametrize("case", list(SIMPLE_CASES))
def test_simple_agg(fixed_epochs, case, per_chunk):
    chunks, build = SIMPLE_CASES[case]
    both(pipeline, [KV], [chunks], build, (), per_chunk)


# ---------------------------------------------------------------------------
# HashJoin
# ---------------------------------------------------------------------------


def join_build(jt, cond=None, stateful=False, max_chunk_size=1024):
    """HashJoin(left, right) on column 0; with `stateful`, both sides'
    state tables as the planner lays them out (row + degree, pk = the
    row; sql/planner.py `_plan_join`)."""
    def build(P, store, l, r):
        kw = {}
        if stateful:
            kw = {side: P.state.StateTable(store, tid,
                                           [P.T.INT64, P.T.VARCHAR,
                                            P.T.INT64], [0, 1])
                  for side, tid in (("left_state", 20),
                                    ("right_state", 21))}
        c = cond(P) if cond is not None else None
        return P.ops.HashJoinExecutor(l, r, [0], [0],
                                      getattr(P.ops.JoinType, jt),
                                      condition=c,
                                      max_chunk_size=max_chunk_size, **kw)
    return build


def _ne_cond(P):
    return P.func("not_equal", P.ref(1, "VARCHAR"), P.ref(3, "VARCHAR"))


JOIN_CASES = {
    # TestHashJoin
    "inner": ([[(I, (1, "l1")), (I, (2, "l2"))]],
              [[(I, (1, "r1")), (I, (3, "r3"))]], "INNER", (0, 1, 2, 3),
              None),
    "inner_retraction": ([[(I, (1, "l1"))], [(D, (1, "l1"))]],
                         [[(I, (1, "r1"))]], "INNER", (0, 1, 2, 3), None),
    "left_outer": ([[(I, (1, "l1")), (I, (2, "l2"))]], [[(I, (1, "r1"))]],
                   "LEFT_OUTER", (0, 1, 2, 3), None),
    "full_outer": ([[(I, (1, "l1"))]], [[(I, (2, "r2"))]], "FULL_OUTER",
                   (0, 1, 2, 3), None),
    "left_semi": ([[(I, (1, "l1")), (I, (2, "l2"))]],
                  [[(I, (1, "r1")), (I, (1, "r1b"))]], "LEFT_SEMI", (0, 1),
                  None),
    "left_anti_flip": ([[(I, (1, "l1")), (I, (2, "l2"))]],
                       [[(I, (1, "r1"))], [(D, (1, "r1"))]], "LEFT_ANTI",
                       (0, 1), None),
    "condition": ([[(I, (1, "x")), (I, (1, "y"))]], [[(I, (1, "x"))]],
                  "INNER", (0, 1, 2, 3), _ne_cond),
    # TestNullJoinKeys
    "null_inner": ([[(I, (None, "l1")), (I, (1, "l2"))]],
                   [[(I, (None, "r1")), (I, (1, "r2"))]], "INNER",
                   (0, 1, 2, 3), None),
    "null_left_outer": ([[(I, (None, "l1"))]], [[(I, (None, "r1"))]],
                        "LEFT_OUTER", (0, 1, 2, 3), None),
    "null_anti": ([[(I, (None, "l1"))]], [[(I, (None, "r1"))]],
                  "LEFT_ANTI", (0, 1), None),
    "null_delete_roundtrip": ([[(I, (None, "l1"))], [(D, (None, "l1"))]],
                              [[(I, (1, "r1"))]], "LEFT_OUTER",
                              (0, 1, 2, 3), None),
}


@FEEDS
@pytest.mark.parametrize("stateful", [False, True],
                         ids=["no_state", "state_tables"])
@pytest.mark.parametrize("case", list(JOIN_CASES))
def test_hash_join(fixed_epochs, case, stateful, per_chunk):
    lc, rc, jt, pk, cond = JOIN_CASES[case]
    both(pipeline, [AB, AB], [lc, rc], join_build(jt, cond, stateful), pk,
         per_chunk)


def test_join_fanout_exceeds_chunk_size(fixed_epochs):
    """TestChunkOverflow: 40 x 40 matches through 16-row chunks."""
    n = 40
    lc = [[(I, (1, f"l{i}")) for i in range(n)]]
    rc = [[(I, (1, f"r{i}")) for i in range(n)]]
    trace = both(pipeline, [AB, AB], [lc, rc],
                 join_build("INNER", max_chunk_size=16), (0, 1, 2, 3),
                 False)
    assert len(trace[-1][2][0][0][1]) == n * n      # the MV's rows


# ---------------------------------------------------------------------------
# TopN / Dedup / HopWindow / OverWindow
# ---------------------------------------------------------------------------


TOPN_CASES = {
    # test_top2
    "top2": (KV, [[(I, (1, 50)), (I, (2, 30)), (I, (3, 70))],
                  [(I, (4, 90))], [(D, (3, 70))]],
             lambda P, st, src: P.ops.TopNExecutor(
                 src, order_by=[(1, True)], limit=2,
                 state_table=P.state.StateTable(st, 10, src.schema.dtypes,
                                                [0, 1])), (0,)),
    # test_topn_offset
    "offset": (KV, [[(I, (i, i * 10)) for i in range(1, 6)]],
               lambda P, st, src: P.ops.TopNExecutor(
                   src, order_by=[(1, True)], limit=2, offset=1), (0,)),
    # test_group_topn
    "group": (["INT64"] * 3, [[(I, (1, 1, 10)), (I, (1, 2, 30)),
                               (I, (1, 3, 20)), (I, (2, 4, 5))]],
              lambda P, st, src: P.ops.TopNExecutor(
                  src, order_by=[(2, True)], limit=1, group_key=[0]),
              (0, 1)),
    # TestDedup.test_append_only_dedup
    "dedup": (KV, [[(I, (1, 10)), (I, (1, 99)), (I, (2, 20))]],
              lambda P, st, src: P.ops.AppendOnlyDedupExecutor(
                  src, [0], state_table=P.state.StateTable(
                      st, 10, src.schema.dtypes, [0])), (0,)),
}


@FEEDS
@pytest.mark.parametrize("case", list(TOPN_CASES))
def test_topn_dedup(fixed_epochs, case, per_chunk):
    kinds, chunks, build, pk = TOPN_CASES[case]
    both(pipeline, [kinds], [chunks], build, pk, per_chunk)


def _hop(P, st, src):
    iv = P.mod("core.dtypes").parse_interval
    return P.ops.HopWindowExecutor(src, 1, iv("5 seconds"),
                                   iv("10 seconds"))


@FEEDS
def test_hop_window(fixed_epochs, per_chunk):
    """TestHopWindow.test_expansion, plus a second chunk across windows."""
    both(pipeline, [["INT64", "TIMESTAMP"]],
         [[[(I, (1, 7_000_000))], [(I, (2, 12_500_000)),
                                   (D, (1, 7_000_000))]]],
         _hop, (0, 2), per_chunk)


def _over(calls):
    def build(P, st, src):
        return P.ops.OverWindowExecutor(
            src, partition_by=[0], order_by=[(1, False)],
            calls=[P.ops.WindowFuncCall(k, None if a is None
                                        else P.ref(a, "INT64"))
                   for k, a in calls])
    return build


OVER_CASES = {
    # test_row_number_rank
    "row_number_rank": ([[(I, (1, 30)), (I, (1, 10)), (I, (1, 30)),
                          (I, (2, 5))]],
                        [("row_number", None), ("rank", None), ("sum", 1)],
                        (0, 1, 2)),
    # test_lag_and_retraction
    "lag_retraction": ([[(I, (1, 10)), (I, (1, 20)), (I, (1, 30))],
                        [(D, (1, 20))]], [("lag", 1)], (0, 1)),
}


@FEEDS
@pytest.mark.parametrize("case", list(OVER_CASES))
def test_over_window(fixed_epochs, case, per_chunk):
    chunks, calls, pk = OVER_CASES[case]
    both(pipeline, [KV], [chunks], _over(calls), pk, per_chunk)


# ---------------------------------------------------------------------------
# TestMvParityOracle: random streams
# ---------------------------------------------------------------------------


def _agg_stream(seed=0):
    rng = np.random.default_rng(seed)
    live, ops = [], []
    for _ in range(500):
        if live and rng.random() < 0.3:
            ops.append((D, live.pop(int(rng.integers(0, len(live))))))
        else:
            r = (int(rng.integers(0, 10)), int(rng.integers(0, 100)))
            live.append(r)
            ops.append((I, r))
    return [ops[i:i + 97] for i in range(0, len(ops), 97)]


@FEEDS
def test_agg_parity_random_stream(fixed_epochs, per_chunk):
    both(pipeline, [KV], [_agg_stream()],
         lambda P, st, src: P.ops.HashAggExecutor(
             src, [0], [P.agg("count"), P.agg("sum", 1), P.agg("min", 1),
                        P.agg("max", 1)], state_table=agg_state(P, st)),
         (0,), per_chunk)


def _join_streams(seed=1):
    rng = np.random.default_rng(seed)
    l_live, r_live, l_ops, r_ops, seen = [], [], [], [], set()
    for _ in range(300):
        side = bool(rng.random() < 0.5)
        live, ops = (l_live, l_ops) if side else (r_live, r_ops)
        if live and rng.random() < 0.25:
            row = live.pop(int(rng.integers(0, len(live))))
            seen.discard((side, row))
            ops.append((D, row))
        else:
            r = (int(rng.integers(0, 8)), f"s{int(rng.integers(0, 1000))}")
            if (side, r) in seen:
                continue
            seen.add((side, r))
            live.append(r)
            ops.append((I, r))
    return ([l_ops[i:i + 53] for i in range(0, len(l_ops), 53)],
            [r_ops[i:i + 53] for i in range(0, len(r_ops), 53)])


@FEEDS
@pytest.mark.parametrize("stateful", [False, True],
                         ids=["no_state", "state_tables"])
def test_join_parity_random_stream(fixed_epochs, stateful, per_chunk):
    lc, rc = _join_streams()
    both(pipeline, [AB, AB], [lc, rc], join_build("INNER",
                                                  stateful=stateful),
         (0, 1, 2, 3), per_chunk)
