"""The per-operator join engine of the port (`DeviceHashJoin` over
`join_epoch_step`) against the JAX package's: the four cases of the
reference's tests/test_device_join.py fed to both engines, both pair
change sets of every flush compared leaf by leaf (dtype included),
pair-capacity growth forced from a small `pair_capacity`, and the
recovery install / state-cleaning pull (`load_side` / `live_side`)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import risingwave_tpu.device.join_step as JJ
import risingwave_tpu_torch.device.join_step as PJ
from torch_parity import assert_same


def engines(capacity=8, pair_capacity=8, dtypes=(np.int64,)):
    return (JJ.DeviceHashJoin([jnp.dtype(d) for d in dtypes],
                              [jnp.dtype(d) for d in dtypes],
                              capacity=capacity, pair_capacity=pair_capacity),
            PJ.DeviceHashJoin(list(dtypes), list(dtypes), capacity=capacity,
                              pair_capacity=pair_capacity, device="cpu"))


def flush_both(jj, pj):
    jo, po = jj.flush_epoch(), pj.flush_epoch()
    assert isinstance(po, tuple) and len(po) == 2
    assert all(isinstance(v, np.ndarray) for o in po for k, v in o.items()
               if k not in ("a_vals", "b_vals"))
    assert_same(po, jo)
    assert pj.m == jj.m
    for s in ("a", "b"):
        assert_same(getattr(pj, s), getattr(jj, s))
    return po


def run_epochs(epochs, **kw):
    jj, pj = engines(**kw)
    for a_batch, b_batch in epochs:
        for side, batch in (("a", a_batch), ("b", b_batch)):
            for jk, pk, sign, v in batch:
                for e in (jj, pj):
                    e.push_rows(side, [jk], [pk], [sign], [[v]])
        flush_both(jj, pj)
    return pj


def test_basic_insert_matching():
    run_epochs([
        ([(1, 100, 1, 10), (2, 101, 1, 20)], [(1, 200, 1, 77)]),
        ([(1, 102, 1, 11)], [(2, 201, 1, 88), (1, 202, 1, 99)]),
    ])


def test_delete_retracts_pairs():
    run_epochs([
        ([(1, 100, 1, 10)], [(1, 200, 1, 77), (1, 201, 1, 78)]),
        ([(1, 100, -1, 10)], []),
    ])


def test_same_epoch_both_sides_no_double_count():
    pj = run_epochs([([(5, 1, 1, 50)], [(5, 2, 1, 60)])])
    assert int(pj.a.count) == int(pj.b.count) == 1


@pytest.mark.parametrize("pair_capacity", [8, 64])
def test_randomized_matches_reference(pair_capacity):
    """The reference's `test_randomized_vs_oracle` drive (eight epochs of
    inserts and deletes on both sides, join keys in [0, 12)), with an
    int64 and a float64 payload; from 8 pair slots the pair buffer must
    grow."""
    rng = np.random.default_rng(3)
    jj, pj = engines(pair_capacity=pair_capacity,
                     dtypes=(np.int64, np.float64))
    tables = {"a": {}, "b": {}}
    next_pk = [0]
    for _ in range(8):
        for side in ("a", "b"):
            jks, pks, signs, vs, fs = [], [], [], [], []
            for _ in range(40):
                if tables[side] and rng.random() < 0.3:
                    pk = list(tables[side])[int(rng.integers(
                        0, len(tables[side])))]
                    if pk in pks:
                        continue
                    jk, v, f = tables[side].pop(pk)
                    sign = -1
                else:
                    jk = int(rng.integers(0, 12))
                    v = int(rng.integers(0, 1000))
                    f = float(rng.normal())
                    pk = next_pk[0]
                    next_pk[0] += 1
                    tables[side][pk] = (jk, v, f)
                    sign = 1
                jks.append(jk)
                pks.append(pk)
                signs.append(sign)
                vs.append(v)
                fs.append(f)
            for e in (jj, pj):
                e.push_rows(side, jks, pks, signs,
                            [np.asarray(vs, np.int64),
                             np.asarray(fs, np.float64)])
        flush_both(jj, pj)
    assert int(pj.a.count) == len(tables["a"])
    assert int(pj.b.count) == len(tables["b"])
    if pair_capacity == 8:
        assert pj.m > 8 and pj.growth_replays >= 1


def test_one_sided_and_empty_epochs():
    """An epoch with rows on one side only, then one with none."""
    jj, pj = engines()
    for e in (jj, pj):
        e.push_rows("a", [3, 3], [1, 2], [1, 1], [[5, 6]])
    flush_both(jj, pj)
    flush_both(jj, pj)


def test_load_and_live_side():
    """Recovery installs (unsorted rows, a key at the sentinel, more rows
    than the capacity) then an epoch against them; `live_side` pulls."""
    rng = np.random.default_rng(21)
    jj, pj = engines(capacity=64, pair_capacity=1 << 12,
                     dtypes=(np.int64,))
    n = 200
    jk = rng.integers(0, 30, n)
    pk = rng.permutation(n).astype(np.int64)
    pk[0] = np.iinfo(np.int64).max
    v = rng.integers(0, 100, n)
    for e in (jj, pj):
        e.load_side("a", jk, pk, [v])
        e.load_side("b", jk[:50], pk[:50] + 1000, [v[:50]])
    assert_same(pj.live_side("a"), jj.live_side("a"))
    assert_same(pj.live_side("b"), jj.live_side("b"))
    assert_same((pj.a, pj.b), (jj.a, jj.b))
    for e in (jj, pj):
        e.push_rows("b", [1, 2, 3], [5000, 5001, 5002], [1, 1, 1],
                    [[7, 8, 9]])
        e.push_rows("a", jk[:5], pk[:5], [-1] * 5, [v[:5]])
    flush_both(jj, pj)


def test_device_none_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is cuda:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PJ.DeviceHashJoin([], [])


def test_join_epoch_step_matches_reference():
    """The eager step against the jitted one, on sides grown by a first
    epoch and a pair capacity too small (needed reports it)."""
    rng = np.random.default_rng(8)
    ja = JJ.make_side(64, [jnp.int64])
    pa = PJ.make_side(64, [torch.int64], "cpu")
    jb = JJ.make_side(64, [jnp.int64])
    pb = PJ.make_side(64, [torch.int64], "cpu")
    b = 64

    def rows():
        jk = rng.integers(0, 6, b).astype(np.int64)
        pk = rng.permutation(1000)[:b].astype(np.int64)
        sg = np.ones(b, np.int32)
        mk = rng.random(b) > 0.2
        vv = rng.integers(0, 9, b).astype(np.int64)
        return jk, pk, sg, mk, vv
    for m in (4096, 16):
        A, B = rows(), rows()
        jout = JJ.join_epoch_step(ja, jb, *map(jnp.asarray, A[:4]),
                                  (jnp.asarray(A[4]),),
                                  *map(jnp.asarray, B[:4]),
                                  (jnp.asarray(B[4]),), m=m)
        pout = PJ.join_epoch_step(pa, pb, *map(torch.from_numpy, A[:4]),
                                  (torch.from_numpy(A[4]),),
                                  *map(torch.from_numpy, B[:4]),
                                  (torch.from_numpy(B[4]),), m=m)
        assert_same(pout, jout)
        ja, jb, pa, pb = jout[0], jout[1], pout[0], pout[1]
    assert int(pout[4]["pairs"]) > 16
