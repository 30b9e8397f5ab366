"""The bucket exchange of the sharded paths against the JAX package's:
`bucket_exchange_plain` (the CPU side of the `bucket_exchange` kernel)
and the port's `shard_exec._exchange_local` against the reference's
`_exchange_local(make_mesh(8), node, xi, d, abstract=True, ...)` — the
send buffers without the collective — on the reference's own AggNode
(plain and pre-combined) and JoinNode (both inputs, row identity
carried), under uniform and rebalanced vnode bounds, hot keys broadcast
and salted (negative pks), and a bucket that overflows; and against
`parallel/sharded_agg._bucketize` over every column type with its fill.
Every comparison is bit-exact."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import risingwave_tpu.device.fused as JF
import risingwave_tpu.device.shard_exec as JSE
from risingwave_tpu.config import DeviceConfig
from risingwave_tpu.core.vnode import compute_vnodes_jnp
from risingwave_tpu.parallel.mesh import make_mesh as jmake_mesh
from risingwave_tpu.parallel.mesh import shard_of_vnode as jshard_of_vnode
from risingwave_tpu.parallel.sharded_agg import _bucketize
from risingwave_tpu.sql import Database
from risingwave_tpu_torch.device import fused as PF
from risingwave_tpu_torch.device import shard_exec as PSE
from risingwave_tpu_torch.device.skew_stats import SK_KEY_MASK
from risingwave_tpu_torch.kernels import bucket_exchange
from risingwave_tpu_torch.kernels.exchange import (HOT_BCAST, HOT_NONE,
                                                   HOT_SALT,
                                                   bucket_exchange_plain)
from risingwave_tpu_torch.parallel.mesh import make_mesh
from torch_parity import EMPTY, assert_same, port_job

N_SHARDS = 8
BID_SRC = ("CREATE SOURCE bid (auction BIGINT, bidder BIGINT, price BIGINT,"
           " channel VARCHAR, url VARCHAR, date_time TIMESTAMP,"
           " extra VARCHAR) WITH (connector='nexmark',"
           " nexmark.table='bid', nexmark.max.events='4096',"
           " nexmark.chunk.size='32')")
AUCTION_SRC = ("CREATE SOURCE auction (id BIGINT, item_name VARCHAR,"
               " description VARCHAR, initial_bid BIGINT, reserve BIGINT,"
               " date_time TIMESTAMP, expires TIMESTAMP, seller BIGINT,"
               " category BIGINT, extra VARCHAR) WITH (connector='nexmark',"
               " nexmark.table='auction', nexmark.max.events='4096',"
               " nexmark.chunk.size='32')")
Q4 = ("CREATE MATERIALIZED VIEW q4 AS SELECT auction, count(*) AS c,"
      " sum(price) AS s, max(price) AS m FROM bid GROUP BY auction")
Q3A = ("CREATE MATERIALIZED VIEW q3a AS SELECT b.auction, b.price,"
       " a.seller, a.category FROM bid b JOIN auction a"
       " ON b.auction = a.id WHERE b.price > 500")
BOUNDS = (0, 0, 17, 17, 90, 200, 200, 255, 256)   # empty blocks included

_NODES = {}


def _ref_job(mv, name, precombine, join=False):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RW_AGG_PRECOMBINE", precombine)
        db = Database(device=DeviceConfig(capacity=64, aot_compile=False))
        db.run(BID_SRC)
        if join:
            db.run(AUCTION_SRC)
        db.run(mv)
        return db._fused[name]


def nodes(which):
    """(reference node, port node) of the reference's own jobs: q4's
    agg (raw or pre-combined input) and q3a's join."""
    if which not in _NODES:
        if which == "join":
            ref = _ref_job(Q3A, "q3a", "0", join=True)
            cls = (JF.JoinNode, PF.JoinNode)
        else:
            ref = _ref_job(Q4, "q4", "1" if which == "combined" else "0")
            cls = (JF.AggNode, PF.AggNode)
        port = port_job(ref, 64)
        rn = [n for n in ref.program.nodes if isinstance(n, cls[0])][0]
        pn = [n for n in port.program.nodes if isinstance(n, cls[1])][0]
        assert rn.combined == pn.combined if which != "join" else True
        _NODES[which] = (rn, pn)
    return _NODES[which]


def _n_cols(node, xi):
    if isinstance(node, JF.JoinNode):
        return len((node.l_val_dtypes, node.r_val_dtypes)[xi])
    if node.combined:
        return 2 + len(node.spec.kinds)
    return max(node.group_idx
               + [c.arg.index for c in node.calls if c.arg is not None]) + 2


def delta_pair(rng, rnode, xi, b, dead=False):
    """The same input delta in both packages: key columns inside the
    node's proven pack ranges (a few keys, so buckets share keys), the
    rest random, some rows masked or of sign 0, pks of both signs."""
    n = _n_cols(rnode, xi)
    cols = [rng.integers(-(1 << 40), 1 << 40, b) for _ in range(n)]
    ex = rnode.shard_spec().exchanges[xi]
    if ex.packed:
        cols[0] = rng.integers(0, 50, b)
    else:
        for f, i in zip(rnode.pack.fields, ex.key_idx):
            cols[i] = f.offset + f.stride * rng.integers(
                0, min(40, 1 << f.bits), b)
    sign = rng.choice(np.array([-1, 0, 1, 1, 1], np.int32), b)
    mask = rng.random(b) < (0.0 if dead else 0.85)
    pk = rng.integers(-(1 << 50), 1 << 50, b)
    rd = JF.Delta([jnp.asarray(c) for c in cols], jnp.asarray(sign),
                  jnp.asarray(mask), pk=jnp.asarray(pk))
    pd = PF.Delta([torch.from_numpy(c) for c in cols],
                  torch.from_numpy(sign), torch.from_numpy(mask),
                  pk=torch.from_numpy(pk))
    return rd, pd


def hot_of(rnode, xi, rd, k=3):
    """k hot keys (40-bit) drawn from the delta's live rows."""
    ex = rnode.shard_spec().exchanges[xi]
    key = rd.cols[ex.key_idx[0]] if ex.packed \
        else rnode.pack.pack([rd.cols[i] for i in ex.key_idx])
    key = np.asarray(key)[np.asarray(rd.mask) & (np.asarray(rd.sign) != 0)]
    return tuple(int(v) & SK_KEY_MASK for v in np.unique(key)[:k])


CASES = [
    # (node, input, rows, exch, bounds, hot, hot_side, dead)
    ("agg", 0, 1000, 512, None, False, 1, False),
    ("agg", 0, 1000, 512, BOUNDS, False, 1, False),
    ("agg", 0, 1000, 4, None, False, 1, False),          # overflow
    ("agg", 0, 300, 64, None, True, 1, False),           # hot: broadcast
    ("agg", 0, 100, 64, None, False, 1, True),           # all rows dead
    ("combined", 0, 777, 256, None, False, 1, False),
    ("combined", 0, 777, 256, BOUNDS, False, 1, False),
    ("join", 0, 900, 512, None, False, 1, False),
    ("join", 1, 900, 512, BOUNDS, False, 1, False),
    ("join", 0, 600, 256, None, True, 1, False),         # hot: salted
    ("join", 1, 600, 256, None, True, 1, False),         # hot: broadcast
    ("join", 1, 600, 16, BOUNDS, True, 0, False),        # salted, overflow
]


@pytest.mark.parametrize("which,xi,b,exch,bounds,hot,side,dead", CASES)
def test_exchange_local_matches_reference(which, xi, b, exch, bounds, hot,
                                          side, dead):
    rnode, pnode = nodes(which)
    rng = np.random.default_rng(b * 7 + xi + exch)
    rd, pd = delta_pair(rng, rnode, xi, b, dead)
    hot_keys = hot_of(rnode, xi, rd) if hot else ()
    rnode.exch = pnode.exch = exch
    want, wneed = JSE._exchange_local(jmake_mesh(N_SHARDS), rnode, xi, rd,
                                      True, bounds, hot_keys, side)
    got, gneed = PSE._exchange_local(make_mesh(N_SHARDS, devices=["cpu"]),
                                     pnode, xi, pd, True, bounds, hot_keys,
                                     side)
    assert_same(got, want)
    assert gneed.dtype == torch.int64 and int(gneed) == int(wneed)
    if exch == 4 or exch == 16:
        assert int(gneed) > exch            # the overflow signal
    if dead:
        assert int(gneed) == 0 and not bool(got.mask.any())


@pytest.mark.parametrize("n", [1, 3, 8, 11])
@pytest.mark.parametrize("b", [1, 100, 2049])
def test_bucketize_matches_reference(n, b):
    """Every column type with its fill (keys EMPTY_KEY, signs 0, values 0,
    valid False), as the sharded engines ship them."""
    rng = np.random.default_rng(n * 1000 + b)
    keys = rng.integers(-(1 << 62), 1 << 62, b)
    keys[: b // 3] = rng.integers(0, 9, b // 3)        # repeated keys
    mask = rng.random(b) < 0.8
    arrays = [keys, rng.choice(np.array([-1, 1], np.int32), b),
              rng.normal(0, 1e3, b), rng.random(b) < 0.5,
              rng.integers(-5, 5, b).astype(np.int32)]
    fills = [EMPTY, 0, 0.0, False, 0]
    dest = jshard_of_vnode(compute_vnodes_jnp(jnp.asarray(keys)), n
                           ).astype(jnp.int32)
    want = _bucketize(dest, jnp.asarray(mask), n,
                      [jnp.asarray(a) for a in arrays], fills)
    t = [torch.from_numpy(a) for a in arrays]
    got, counts, need = bucket_exchange_plain(torch.from_numpy(keys),
                                              torch.from_numpy(mask), n, b,
                                              t, fills)
    assert_same(got, want)
    live_dest = np.asarray(dest)[mask]
    assert np.array_equal(counts.numpy(),
                          np.bincount(live_dest, minlength=n))
    assert int(need) == int(np.bincount(live_dest, minlength=n).max()) \
        if mask.any() else int(need) == 0
    # the dispatch takes the plain version on CPU tensors, `out` included
    out = [torch.empty((n, b), dtype=a.dtype) for a in t]
    got2, _, _ = bucket_exchange(torch.from_numpy(keys),
                                 torch.from_numpy(mask), n, b, t, fills,
                                 out=out)
    assert all(g is o for g, o in zip(got2, out))
    assert_same(got2, want)


def test_salt_is_floor_mod():
    """A salted hot row goes to pk floor-mod n (negative pks too), at its
    rank among the rows bound there."""
    n, b = 3, 12
    keys = torch.full((b,), 5, dtype=torch.int64)
    pk = torch.arange(-6, 6, dtype=torch.int64)
    mask = torch.ones(b, dtype=torch.bool)
    bufs, counts, need = bucket_exchange_plain(
        keys, mask, n, 8, [pk], [EMPTY], pk=pk, hot_keys=(5,),
        hot_mode=HOT_SALT, hot_mask=SK_KEY_MASK)
    want = {d: [v for v in range(-6, 6) if v % n == d] for d in range(n)}
    for d in range(n):
        assert bufs[0][d, :4].tolist() == want[d]
        assert bufs[0][d, 4:].tolist() == [EMPTY] * 4
    assert counts.tolist() == [4, 4, 4] and int(need) == 4


def test_broadcast_ranks_per_bucket():
    """A broadcast row takes a slot in every bucket, after the rows bound
    there before it."""
    n = 4
    keys = torch.tensor([1, 2, 3, 99, 4, 5], dtype=torch.int64)
    mask = torch.ones(6, dtype=torch.bool)
    vals = torch.arange(6, dtype=torch.int64) * 10
    bufs, counts, need = bucket_exchange_plain(
        keys, mask, n, 8, [vals], [-1], hot_keys=(99,), hot_mode=HOT_BCAST,
        hot_mask=SK_KEY_MASK)
    from risingwave_tpu_torch.core.vnode import vnodes_i64_plain
    from risingwave_tpu_torch.parallel.mesh import shard_of_vnode
    dest = shard_of_vnode(vnodes_i64_plain(keys.numpy()).astype(np.int64), n)
    for d in range(n):
        before = [10 * i for i in range(3) if dest[i] == d]
        after = [10 * i for i in (4, 5) if dest[i] == d]
        row = bufs[0][d].tolist()
        assert row[:len(before) + 1 + len(after)] == before + [30] + after
        assert counts[d] == len(before) + 1 + len(after)
    assert int(need) == int(counts.max())
    with pytest.raises(ValueError):
        bucket_exchange_plain(keys, mask, n, 8, [vals], [0], hot_keys=(99,),
                              hot_mode=HOT_SALT)       # salt needs pk
    with pytest.raises(ValueError):
        bucket_exchange_plain(keys, mask, 65, 8, [vals], [0])
    assert HOT_NONE == 0


DELTA_CASES = [
    # (node, input, rows per shard, exch, bounds, hot, hot_side)
    ("agg", 0, 300, 512, None, False, 1),
    ("agg", 0, 300, 512, BOUNDS, False, 1),
    ("agg", 0, 300, 8, BOUNDS, False, 1),                # overflow
    ("combined", 0, 200, 256, BOUNDS, True, 1),         # broadcast
    ("join", 0, 250, 512, BOUNDS, True, 1),             # salted
    ("join", 1, 250, 512, None, True, 1),               # broadcast
    ("join", 1, 250, 64, BOUNDS, True, 0),              # salted, overflow
]


@pytest.mark.parametrize("which,xi,b,exch,bounds,hot,side", DELTA_CASES)
def test_exchange_delta_matches_reference_collective(which, xi, b, exch,
                                                     bounds, hot, side):
    """The port's `exchange_delta` (every source shard at once, the
    program's bounds, the node's hot keys and side) against the
    reference's own collective `exchange_delta` — its `shard_map`'d
    all_to_all over eight devices, run under `torch_ref_mesh.ref_mesh()`
    — on the same eight per-shard deltas: every shard's received rows
    and the fullest bucket."""
    from torch_ref_mesh import ref_mesh
    rnode, pnode = nodes(which)
    rng = np.random.default_rng(b * 11 + xi + exch)
    pairs = [delta_pair(rng, rnode, xi, b) for _ in range(N_SHARDS)]
    hot_keys = tuple(sorted(set(
        k for rd, _ in pairs[:2] for k in hot_of(rnode, xi, rd, k=2)))) \
        if hot else ()
    stacked = JF.Delta(
        [jnp.stack([rd.cols[i] for rd, _ in pairs])
         for i in range(len(pairs[0][0].cols))],
        jnp.stack([rd.sign for rd, _ in pairs]),
        jnp.stack([rd.mask for rd, _ in pairs]),
        pk=jnp.stack([rd.pk for rd, _ in pairs]))
    saved = [(n, n.exch, n.hot_keys, n.hot_rep_side)
             for n in (rnode, pnode)]
    try:
        for n in (rnode, pnode):
            n.exch, n.hot_keys, n.hot_rep_side = exch, hot_keys, side
        with ref_mesh():
            want, wneed = JSE.exchange_delta(jmake_mesh(N_SHARDS), rnode,
                                             xi, stacked, bounds=bounds)
            want = jax.device_get(want)
            wneed = int(wneed)
        got, needs = PSE.exchange_delta(
            make_mesh(N_SHARDS, devices=["cpu"]), pnode, xi,
            [pd for _, pd in pairs], bounds=bounds)
    finally:
        for n, e, hk, sd in saved:
            n.exch, n.hot_keys, n.hot_rep_side = e, hk, sd
    assert len(got) == N_SHARDS
    for d in range(N_SHARDS):
        assert_same(got[d], jax.tree_util.tree_map(lambda x: x[d], want))
    assert max(int(x) for x in needs) == wneed
    if exch in (8, 64):
        assert wneed > exch                 # the overflow signal
