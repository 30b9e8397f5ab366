"""The port's sharded per-operator engines (`parallel/sharded_agg.py`,
`parallel/sharded_join.py`, `parallel/rescale.py`) on an 8-shard CPU mesh
against the JAX package's on `make_mesh(8)`: every state leaf (stacked to
the reference's [n, C] layout) and every change-set leaf after every
epoch, bit for bit, float sums included; growth and multisets; a port
started from the reference's state after one epoch (`state_io`); the
rescale sequence 2 -> 4 -> 4 -> 3 -> 3; and both SQL executors with
`mesh=` and `rescale_mesh` under a `StreamJob` against the reference's."""
import numpy as np
import pytest

import jax

from risingwave_tpu.device.agg_step import DeviceAggSpec as JSpec
from risingwave_tpu.parallel import make_mesh as jmake_mesh
from risingwave_tpu.parallel.sharded_agg import ShardedHashAgg as JAgg
from risingwave_tpu.parallel.sharded_join import ShardedHashJoin as JJoin
from risingwave_tpu_torch.device.agg_step import DeviceAggSpec as PSpec
from risingwave_tpu_torch.device.state_io import (shards_from_numpy,
                                                  shards_to_numpy)
from risingwave_tpu_torch.parallel import make_mesh
from risingwave_tpu_torch.parallel.sharded_agg import ShardedHashAgg as PAgg
from risingwave_tpu_torch.parallel.sharded_join import \
    ShardedHashJoin as PJoin
from test_torch_ops_device import (D, I, Graph, Pkg, Source, Table, UD, UI,
                                   agg_exec, assert_outputs, assert_tables,
                                   join_exec)
from torch_parity import assert_same


def pmesh(n):
    return make_mesh(n, devices=["cpu"])


def agg_pair(kinds, dtypes, n, capacity, append_only=True):
    """The same spec and engine in both packages (min(x) / max(x) of one
    column share a multiset when retractable)."""
    arg_ids = [("ref", 0)] * len(kinds)
    js = JSpec.build(kinds, dtypes, append_only=append_only, arg_ids=arg_ids)
    ps = PSpec.build(kinds, dtypes, append_only=append_only, arg_ids=arg_ids)
    return (JAgg(js, jmake_mesh(n), capacity=capacity),
            PAgg(ps, pmesh(n), capacity=capacity))


def assert_agg_state(p, j):
    assert_same(shards_to_numpy(p.state), jax.device_get(j.state))
    assert len(p.minputs) == len(j.minputs)
    for pm, jm in zip(p.minputs, j.minputs):
        assert_same(shards_to_numpy(pm), jax.device_get(jm))


def agg_epochs(seed, n_epochs, n_keys, retract, float_col=False):
    rng = np.random.default_rng(seed)
    live = []
    for _ in range(n_epochs):
        n = int(rng.integers(200, 600))
        keys = rng.integers(0, n_keys, n).astype(np.int64)
        vals = (rng.normal(0, 1e3, n) if float_col
                else rng.integers(-100, 100, n).astype(np.int64))
        valid = rng.random(n) > 0.05
        signs = np.ones(n, np.int32)
        if retract and live:
            # retract a few rows pushed earlier (exact rows: multisets)
            k = min(len(live), 40)
            idx = rng.choice(len(live), k, replace=False)
            old = [live[i] for i in idx]
            keys = np.concatenate([keys, [o[0] for o in old]])
            vals = np.concatenate([vals, [o[1] for o in old]])
            valid = np.concatenate([valid, [o[2] for o in old]])
            signs = np.concatenate([signs, -np.ones(k, np.int32)])
            live = [r for i, r in enumerate(live) if i not in set(idx)]
        live += [(keys[i], vals[i], valid[i]) for i in range(n)]
        yield keys, signs, vals, valid


@pytest.mark.parametrize("kinds,retract,float_col", [
    (["count_star", "sum", "max"], False, False),
    (["count_star", "sum", "count"], True, False),
    (["count_star", "sum", "avg"], True, True),
    (["min", "max", "count_star"], True, False),      # multisets
])
def test_sharded_agg_matches_reference(kinds, retract, float_col):
    dt = np.float64 if float_col else np.int64
    j, p = agg_pair(kinds, [dt] * len(kinds), 8, 16,
                    append_only=not retract)
    for keys, signs, vals, valid in agg_epochs(7, 5, 300, retract,
                                               float_col):
        ins = [(vals, valid)] * len(kinds)
        j.push_rows(keys, signs, ins)
        p.push_rows(keys, signs, ins)
        assert_same(p.flush_epoch(), jax.device_get(j.flush_epoch()))
        assert_agg_state(p, j)
    assert p.capacity == j.capacity > 16             # grew
    if j.minputs:
        assert p.minputs[0][0].capacity > 16


def test_sharded_agg_from_reference_state():
    """The port starts from the reference's sharded state after one epoch
    (state_io) and both take the next epochs the same way."""
    kinds = ["min", "max", "count_star"]
    j, p = agg_pair(kinds, [np.int64] * 3, 8, 16, append_only=False)
    epochs = list(agg_epochs(5, 3, 100, True))
    keys, signs, vals, valid = epochs[0]
    j.push_rows(keys, signs, [(vals, valid)] * 3)
    j.flush_epoch()
    p.state = shards_from_numpy("sorted", jax.device_get(j.state), p.mesh)
    p.minputs = tuple(shards_from_numpy("multiset", jax.device_get(m),
                                        p.mesh) for m in j.minputs)
    assert_agg_state(p, j)
    for keys, signs, vals, valid in epochs[1:]:
        ins = [(vals, valid)] * 3
        j.push_rows(keys, signs, ins)
        p.push_rows(keys, signs, ins)
        assert_same(p.flush_epoch(), jax.device_get(j.flush_epoch()))
        assert_agg_state(p, j)


def test_rescale_matches_reference():
    """tests/test_sharded_agg.py:79 — 2 -> 4 -> 4 -> 3 -> 3 shards
    mid-stream, the reference's sequence: same states after each rescale
    and each epoch, and the same outputs as an unrescaled run."""
    kinds = ["count_star", "sum"]
    j, p = agg_pair(kinds, [np.int64] * 2, 2, 16)
    fixed = PAgg(PSpec.build(kinds, [np.int64] * 2), pmesh(2), capacity=16)
    rng = np.random.default_rng(11)
    for n_shards in [2, 4, 4, 3, 3]:
        if n_shards != p.n:
            j.rescale(jmake_mesh(n_shards))
            p.rescale(pmesh(n_shards))
            assert_agg_state(p, j)
        n = 300
        keys = rng.integers(0, 50, size=n).astype(np.int64)
        vals = rng.integers(-20, 20, size=n).astype(np.int64)
        ins = [(vals, np.ones(n, bool))] * 2
        for agg in (j, p, fixed):
            agg.push_rows(keys, np.ones(n, np.int32), ins)
        assert_same(p.flush_epoch(), jax.device_get(j.flush_epoch()))
        fixed.flush_epoch()
        assert_agg_state(p, j)
    assert p.n == 3 and len(p.state) == 3
    k1, v1 = p.live_main()
    k2, v2 = fixed.live_main()
    o1, o2 = np.argsort(k1), np.argsort(k2)
    assert np.array_equal(k1[o1], k2[o2])
    for a, b in zip(v1, v2):
        assert np.array_equal(a[o1], b[o2])


def join_rows(rng, n, keys, start):
    jk = rng.integers(0, keys, n).astype(np.int64)
    pk = np.arange(start, start + n, dtype=np.int64) * 7919 - (1 << 40)
    return jk, pk


def test_sharded_join_matches_reference():
    n_shards = 8
    j = JJoin([np.int64, np.float64], [np.int64], jmake_mesh(n_shards),
              capacity=16, pair_capacity=32)
    p = PJoin([np.int64, np.float64], [np.int64], pmesh(n_shards),
              capacity=16, pair_capacity=32)
    rng = np.random.default_rng(3)
    hist = {"a": [], "b": []}
    start = 0
    for epoch in range(5):
        for side, nv in (("a", 2), ("b", 1)):
            n = int(rng.integers(50, 300))
            jk, pk = join_rows(rng, n, 60, start)
            start += n
            vals = [rng.integers(-9, 9, n)] + \
                ([rng.normal(0, 10, n)] if nv == 2 else [])
            signs = np.ones(n, np.int32)
            if epoch and hist[side]:
                # retract earlier rows of this side
                k = min(20, len(hist[side]))
                old = hist[side][:k]
                hist[side] = hist[side][k:]
                jk = np.concatenate([jk, [o[0] for o in old]])
                pk = np.concatenate([pk, [o[1] for o in old]])
                vals = [np.concatenate([v, [o[2][i] for o in old]])
                        for i, v in enumerate(vals)]
                signs = np.concatenate([signs, -np.ones(k, np.int32)])
            hist[side] += [(jk[i], pk[i], [v[i] for v in vals])
                           for i in range(n)]
            j.push_rows(side, jk, pk, signs, vals)
            p.push_rows(side, jk, pk, signs, vals)
        assert_same(p.flush_epoch(), jax.device_get(j.flush_epoch()))
        for side in ("a", "b"):
            assert_same(shards_to_numpy(getattr(p, side)),
                        jax.device_get(getattr(j, side)))
        if epoch == 1:
            # carry the reference's state across (state_io)
            p.a = shards_from_numpy("side", jax.device_get(j.a), p.mesh)
            p.b = shards_from_numpy("side", jax.device_get(j.b), p.mesh)
    assert p.m == j.m > 32 and p.a[0].jk.shape[0] == j.a.jk.shape[1] > 16
    for side in ("a", "b"):
        pj, pp = p.live_side(side)
        jj, jp = j.live_side(side)
        assert np.array_equal(pj, jj) and np.array_equal(pp, jp)


# ---------------------------------------------------------------------------
# the executors' mesh arms under a StreamJob
# ---------------------------------------------------------------------------


def mesh_pkgs(n):
    return (Pkg("risingwave_tpu", mesh=jmake_mesh(n)),
            Pkg("risingwave_tpu_torch", device="cpu", mesh=pmesh(n)))


def _rescale(rg, pg, n):
    rg.node.rescale_mesh(jmake_mesh(n) if n > 1 else None)
    pg.node.rescale_mesh(pmesh(n) if n > 1 else None)


T_KINDS = ["INT32", "VARCHAR", "INT64", "FLOAT64"]


def t_epochs(seed, n_epochs):
    rng = np.random.default_rng(seed)
    t = Table(rng)

    def make():
        v = None if rng.random() < 0.15 else int(rng.integers(0, 100))
        return (int(rng.integers(0, 30)), f"c{int(rng.integers(0, 4))}", v,
                round(float(rng.random()), 3))
    for _ in range(n_epochs):
        rows = t.inserts(make, 60)
        kd = int(rng.integers(0, 30))
        rows += t.deletes(5, lambda r: r[0] == kd and (r[2] or 0) < 30)
        rows += t.updates(4, lambda r: (r[0], r[1],
                                        None if r[2] is None else r[2] + 1,
                                        r[3]))
        yield (rows,)


@pytest.mark.parametrize("specs,gk", [
    ([("count", None), ("count", 2), ("sum", 2), ("avg", 2)], [0]),
    ([("min", 2), ("max", 2), ("sum", 3)], [0]),
    ([("sum", 3), ("count", None)], [1]),
])
def test_agg_executor_mesh_and_rescale(specs, gk):
    """DeviceHashAggExecutor(mesh=8) then `rescale_mesh` 8 -> 3 -> None
    -> 4 between barriers: outputs and state tables equal the
    reference's after every barrier."""
    R, P = mesh_pkgs(8)

    def build(Pk, store, inj):
        src = Source(Pk, T_KINDS, inj)
        return agg_exec(Pk, store, src.exec, gk, specs, T_KINDS,
                        capacity=8), [src]
    rg, pg = Graph(R, build), Graph(P, build)
    plan = {2: 3, 4: 1, 5: 4}
    for e, batches in enumerate(t_epochs(13, 7)):
        if e in plan:
            _rescale(rg, pg, plan[e])
        assert_outputs(pg.epoch(*batches), rg.epoch(*batches))
        assert_tables(pg, rg)
    assert pg.node.mesh.n == 4


def test_join_executor_mesh_and_rescale():
    """DeviceHashJoinExecutor(mesh=8) with a rescale to 3 shards: outputs
    and state tables equal the reference's after every barrier."""
    R, P = mesh_pkgs(8)
    lk = ["INT64", "INT64", "VARCHAR"]
    rk = ["INT64", "INT64"]

    def build(Pk, store, inj):
        left = Source(Pk, lk, inj)
        right = Source(Pk, rk, inj)
        return join_exec(Pk, store, left.exec, right.exec, [0], [0],
                         capacity=8, pair_capacity=8), [left, right]
    rg, pg = Graph(R, build), Graph(P, build)
    rng = np.random.default_rng(17)
    lt, rt = Table(rng), Table(rng)
    for e in range(6):
        if e == 3:
            _rescale(rg, pg, 3)
        lrows = lt.inserts(lambda: (int(rng.integers(0, 12)),
                                    int(rng.integers(0, 1000)),
                                    f"s{int(rng.integers(0, 5))}"), 30)
        rrows = rt.inserts(lambda: (int(rng.integers(0, 12)),
                                    int(rng.integers(0, 1000))), 10)
        if e:
            lrows += lt.deletes(4)
            rrows += rt.updates(2, lambda r: (r[0], r[1] + 1))
        assert_outputs(pg.epoch(lrows, rrows), rg.epoch(lrows, rrows))
        assert_tables(pg, rg)
    assert pg.node.mesh.n == 3
    assert (D, I, UD, UI) == (1, 0, 2, 3)
