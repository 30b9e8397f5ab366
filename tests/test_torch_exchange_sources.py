"""The one-call exchange over every source shard against the JAX
package's per-source exchange: `bucket_exchange_sources_plain` (the CPU
side of the `bucket_exchange` kernel, receiver-major [n_dst, n_src, cap]
buffers) against the reference's `_bucketize` of each source stacked
receiver-major, and the port's `shard_exec.exchange_apply` over all 8
shards' deltas against the reference's `_exchange_local(..., abstract=True)`
of each source, transposed, on the reference's own q4 AggNode (raw and
pre-combined) and q3a JoinNode. Cases: B = 1 and 2049 (off a 2048-row
tile), one source overflowing alone, one source with every row dead, hot
keys broadcast and salted across sources (negative pks), bounds with
empty blocks, int64 / f64 / int32 / bool columns with their fills. A
one-device mesh makes one call of the kernel's entry per exchange. Every
comparison is bit-exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import risingwave_tpu.device.fused as JF
import risingwave_tpu.device.shard_exec as JSE
from risingwave_tpu.core.vnode import compute_vnodes_jnp
from risingwave_tpu.parallel.mesh import make_mesh as jmake_mesh
from risingwave_tpu.parallel.mesh import shard_of_vnode as jshard_of_vnode
from risingwave_tpu.parallel.sharded_agg import _bucketize
from risingwave_tpu_torch.device import fused as PF
from risingwave_tpu_torch.device import shard_exec as PSE
from risingwave_tpu_torch.kernels import exchange as KX
from risingwave_tpu_torch.parallel import sharded_agg as PSA
from risingwave_tpu_torch.parallel.mesh import make_mesh
from test_torch_exchange import BOUNDS, N_SHARDS, _n_cols, hot_of, nodes
from torch_parity import EMPTY, assert_same

torch.set_num_threads(1)

FILLS = [EMPTY, 0.0, -7, True]


def source_arrays(rng, b, dead=False, one_key=False):
    """One source's rows: int64 keys (a third repeated; one key only when
    `one_key`), a mask (none live when `dead`), and int64 / f64 / int32 /
    bool columns."""
    keys = rng.integers(-(1 << 62), 1 << 62, b)
    keys[: b // 3] = rng.integers(0, 9, b // 3)
    if one_key:
        keys[:] = 5
    mask = rng.random(b) < (0.0 if dead else 0.8)
    cols = [keys, rng.normal(0, 1e3, b),
            rng.integers(-(1 << 31), 1 << 31, b).astype(np.int32),
            rng.random(b) < 0.5]
    return keys, mask, cols


@pytest.mark.parametrize("n_src,n", [(1, 1), (3, 3), (8, 8), (1, 8)])
@pytest.mark.parametrize("b", [1, 2049])
def test_sources_plain_matches_stacked_bucketize(n_src, n, b):
    """Receiver-major buffers equal the reference's per-source `_bucketize`
    (cap = B) stacked on axis 1; counts and need per source; source 1 all
    dead where there is one."""
    rng = np.random.default_rng(n_src * 100 + n * 10 + b)
    srcs = [source_arrays(rng, b, dead=(s == 1)) for s in range(n_src)]
    want = []
    for keys, mask, cols in srcs:
        dest = jshard_of_vnode(compute_vnodes_jnp(jnp.asarray(keys)), n
                               ).astype(jnp.int32)
        want.append(_bucketize(dest, jnp.asarray(mask), n,
                               [jnp.asarray(c) for c in cols], FILLS))
    stacked = [np.stack([np.asarray(w[j]) for w in want], 1)
               for j in range(len(FILLS))]
    tk = [torch.from_numpy(k) for k, _, _ in srcs]
    tm = [torch.from_numpy(m) for _, m, _ in srcs]
    tc = [[torch.from_numpy(c) for c in cols] for _, _, cols in srcs]
    got, counts, need = KX.bucket_exchange_sources_plain(tk, tm, n, b, tc,
                                                         FILLS)
    assert_same(got, stacked)
    assert counts.shape == (n_src, n) and need.shape == (n_src,)
    for s, (keys, mask, _) in enumerate(srcs):
        dest = np.asarray(jshard_of_vnode(
            compute_vnodes_jnp(jnp.asarray(keys)), n))[mask]
        assert counts[s].tolist() == np.bincount(dest, minlength=n).tolist()
        assert int(need[s]) == int(counts[s].max())
    if n_src > 1:
        assert int(need[1]) == 0                     # source 1: all dead
    # the dispatch takes the plain version on CPU tensors, `out` included
    out = [torch.empty((n, n_src, b), dtype=g.dtype) for g in got]
    got2, counts2, need2 = KX.bucket_exchange_sources(tk, tm, n, b, tc,
                                                      FILLS, out=out)
    assert all(g is o for g, o in zip(got2, out))
    assert_same(got2, stacked)
    assert torch.equal(counts2, counts) and torch.equal(need2, need)


def test_sources_refuse_ragged_and_too_many():
    """Every source has one row count; at most EXCH_MAX_SOURCES sources."""
    k = [torch.zeros(4, dtype=torch.int64), torch.zeros(5, dtype=torch.int64)]
    m = [torch.ones(4, dtype=torch.bool), torch.ones(5, dtype=torch.bool)]
    with pytest.raises(ValueError, match="same row count"):
        KX.bucket_exchange_sources_plain(k, m, 2, 4, [[k[0]], [k[1]]], [0])
    many = [torch.zeros(2, dtype=torch.int64)] * 65
    with pytest.raises(ValueError, match="source shards"):
        KX.bucket_exchange_sources_plain(
            many, [torch.ones(2, dtype=torch.bool)] * 65, 2, 2,
            [[x] for x in many], [0])


def source_deltas(rnode, xi, b, seed, dead=(), one_key=()):
    """N_SHARDS source deltas in both packages: keys inside the node's
    proven pack ranges (a few keys, so buckets share keys; one key only
    for the sources in `one_key`), some rows masked or of sign 0 (none
    live for the sources in `dead`), pks of both signs."""
    rng = np.random.default_rng(seed)
    ncols = _n_cols(rnode, xi)
    ex = rnode.shard_spec().exchanges[xi]
    rds, pds = [], []
    for s in range(N_SHARDS):
        cols = [rng.integers(-(1 << 40), 1 << 40, b) for _ in range(ncols)]
        if ex.packed:
            cols[0] = rng.integers(0, 50, b)
            if s in one_key:
                cols[0][:] = 7
        else:
            for f, i in zip(rnode.pack.fields, ex.key_idx):
                cols[i] = f.offset + f.stride * rng.integers(
                    0, 1 if s in one_key else min(40, 1 << f.bits), b)
        sign = rng.choice(np.array([-1, 0, 1, 1, 1], np.int32), b)
        mask = rng.random(b) < (0.0 if s in dead else 0.85)
        pk = rng.integers(-(1 << 50), 1 << 50, b)
        rds.append(JF.Delta([jnp.asarray(c) for c in cols],
                            jnp.asarray(sign), jnp.asarray(mask),
                            pk=jnp.asarray(pk)))
        pds.append(PF.Delta([torch.from_numpy(c) for c in cols],
                            torch.from_numpy(sign), torch.from_numpy(mask),
                            pk=torch.from_numpy(pk)))
    return rds, pds


APPLY_CASES = [
    # (node, input, rows, exch, bounds, hot, hot_side, dead, one_key)
    ("agg", 0, 1, 4, None, False, 1, (), ()),
    ("agg", 0, 2049, 512, None, False, 1, (3,), ()),
    ("agg", 0, 900, 384, BOUNDS, False, 1, (), (5,)),     # 5 overflows
    ("agg", 0, 300, 64, None, True, 1, (0,), ()),         # broadcast
    ("combined", 0, 2049, 512, BOUNDS, False, 1, (7,), ()),
    ("combined", 0, 900, 256, None, False, 1, (), (2,)),  # 2 overflows
    ("join", 0, 600, 256, None, True, 1, (), ()),         # salted
    ("join", 1, 600, 256, BOUNDS, True, 1, (4,), ()),     # broadcast
    ("join", 0, 2049, 1024, BOUNDS, False, 1, (), (6,)),  # 6 overflows
    ("join", 1, 1, 2, None, False, 1, (), ()),
]


@pytest.mark.parametrize("which,xi,b,exch,bounds,hot,side,dead,one_key",
                         APPLY_CASES)
def test_exchange_apply_matches_reference_transposed(which, xi, b, exch,
                                                     bounds, hot, side,
                                                     dead, one_key):
    """Shard d receives, source-major, what each source's reference
    exchange placed in its bucket d; need per source equal."""
    rnode, pnode = nodes(which)
    rds, pds = source_deltas(rnode, xi, b, b * 7 + xi + exch, dead, one_key)
    hot_keys = hot_of(rnode, xi, rds[1]) if hot else ()
    rnode.exch = pnode.exch = exch
    jmesh = jmake_mesh(N_SHARDS)
    want = [JSE._exchange_local(jmesh, rnode, xi, rd, True, bounds,
                                hot_keys, side) for rd in rds]
    mesh = make_mesh(N_SHARDS, devices=["cpu"])
    got, needs = PSE.exchange_apply(mesh, pnode, xi, pds, bounds, hot_keys,
                                    side)
    assert len(got) == N_SHARDS and len(needs) == N_SHARDS
    for s, (_, wn) in enumerate(want):
        assert needs[s].dtype == torch.int64 and int(needs[s]) == int(wn)
    for s in one_key:
        assert int(needs[s]) > exch                      # the overflow
    others = [int(needs[s]) for s in range(N_SHARDS) if s not in one_key]
    if one_key:
        assert max(others) <= exch                       # it alone
    for s in dead:
        assert int(needs[s]) == 0
    for d in range(N_SHARDS):
        def part(x):
            return np.concatenate([np.asarray(x(w[0]))[d * exch:
                                                       (d + 1) * exch]
                                   for w in want])
        ref = JF.Delta([part(lambda o, i=i: o.cols[i])
                        for i in range(len(want[0][0].cols))],
                       part(lambda o: o.sign), part(lambda o: o.mask),
                       pk=None if want[0][0].pk is None
                       else part(lambda o: o.pk))
        assert_same(got[d], ref)


def test_one_device_mesh_one_entry_call_per_exchange(monkeypatch):
    """On one device an exchange is one call of the kernel's entry with
    every source (both seams: the fused programs' `exchange_apply` and
    the engines' `_exchange`); over two device names, one call per
    source."""
    calls = []
    entry = KX.bucket_exchange_sources

    def counted(keys, *a, **kw):
        calls.append(len(keys))
        return entry(keys, *a, **kw)
    monkeypatch.setattr(KX, "bucket_exchange_sources", counted)
    rnode, pnode = nodes("join")
    _, pds = source_deltas(rnode, 0, 300, 11)
    pnode.exch = 128
    one = make_mesh(N_SHARDS, devices=["cpu"])
    PSE.exchange_apply(one, pnode, 0, pds)
    assert calls == [N_SHARDS]
    rng = np.random.default_rng(12)
    srcs = [source_arrays(rng, 64) for _ in range(N_SHARDS)]
    keys = [torch.from_numpy(k) for k, _, _ in srcs]
    masks = [torch.from_numpy(m) for _, m, _ in srcs]
    arrays = [[torch.from_numpy(c) for c in cols] for _, _, cols in srcs]
    recv = PSA._exchange(one, keys, masks, arrays, FILLS)
    assert calls == [N_SHARDS, N_SHARDS] and len(recv) == N_SHARDS
    assert recv[0][0].shape == (N_SHARDS * 64,)
    two = make_mesh(N_SHARDS, devices=[torch.device("cpu"),
                                       torch.device("cpu", 0)])
    recv2 = PSA._exchange(two, keys, masks, arrays, FILLS)
    assert calls[2:] == [1] * N_SHARDS
    for a, b in zip(recv, recv2):
        assert_same(a, b)
