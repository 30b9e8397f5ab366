"""The port's shard mesh (`risingwave_tpu_torch/parallel/mesh.py`): the
vnode-block layout against the JAX package's, the collectives' semantics
over per-shard tensors, and no CPU fallback when no device is given."""
import numpy as np
import pytest
import torch

import risingwave_tpu.parallel.mesh as JM
from risingwave_tpu_torch.core.vnode import VNODE_COUNT
from risingwave_tpu_torch.kernels import exchange as KX
from risingwave_tpu_torch.parallel import mesh as PM

torch.set_num_threads(1)


@pytest.mark.parametrize("n", range(1, 12))
def test_block_layout_matches_reference(n):
    assert np.array_equal(PM.vnode_block_bounds(n),
                          JM.vnode_block_bounds(n))
    vn = np.arange(VNODE_COUNT, dtype=np.int64)
    want = JM.shard_of_vnode(vn, n)
    assert np.array_equal(PM.shard_of_vnode(vn, n), want)
    # the same arithmetic on torch tensors (the exchange's plain version)
    got = PM.shard_of_vnode(torch.from_numpy(vn), n)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    # the boundary-exact inverse: shard k owns [bounds[k], bounds[k + 1])
    b = PM.vnode_block_bounds(n)
    for k in range(n):
        assert (want[b[k]:b[k + 1]] == k).all()


def _mesh_of(n, layout):
    """n shards on one CPU device, or dealt over two distinct CPU device
    names (so the cross-device form of each collective runs)."""
    devs = ["cpu"] if layout == "one" else [torch.device("cpu"),
                                            torch.device("cpu", 0)]
    return PM.Mesh(n, devs)


@pytest.mark.parametrize("layout", ["one", "two"])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_all_to_all_is_source_major(n, layout, monkeypatch):
    mesh = _mesh_of(n, layout)
    assert mesh.single_device == (layout == "one" or n == 1)
    rng = np.random.default_rng(n)
    send = [torch.from_numpy(rng.integers(0, 1 << 40, (n, 5)))
            .to(mesh.devices[s]) for s in range(n)]
    recv = mesh.all_to_all(send)
    assert len(recv) == n
    for d in range(n):
        assert recv[d].shape == (n, 5)
        for s in range(n):
            assert torch.equal(recv[d][s].cpu(), send[s][d].cpu())
    # the bucket exchange: every source's rows bucketed and handed to
    # their owners, flattened per receiver, source-major — one call of the
    # kernel's entry over every source on one device (its receiver-major
    # buffers as they stand), one per source and `all_to_all` otherwise
    b, cap = 40, 16
    keys = [torch.from_numpy(rng.integers(0, 1 << 40, b))
            .to(mesh.devices[s]) for s in range(n)]
    masks = [torch.from_numpy(rng.random(b) < 0.8).to(mesh.devices[s])
             for s in range(n)]
    cols = [[keys[s], torch.from_numpy(rng.normal(0, 1, b))
             .to(mesh.devices[s])] for s in range(n)]
    fills = [-1, 0.5]
    calls = []
    entry = KX.bucket_exchange_sources

    def counted(ks, *a, **kw):
        calls.append(len(ks))
        return entry(ks, *a, **kw)
    monkeypatch.setattr(KX, "bucket_exchange_sources", counted)
    got, need = mesh.exchange(keys, masks, cap, cols, fills)
    assert calls == ([n] if mesh.single_device else [1] * n)
    want = [KX.bucket_exchange_plain(keys[s].cpu(), masks[s].cpu(), n, cap,
                                     [c.cpu() for c in cols[s]], fills)
            for s in range(n)]
    assert [int(x) for x in need] == [int(w[2]) for w in want]
    for d in range(n):
        assert len(got[d]) == 2
        for j in range(2):
            assert torch.equal(got[d][j].cpu(), torch.cat(
                [want[s][0][j][d] for s in range(n)]))


@pytest.mark.parametrize("layout", ["one", "two"])
def test_psum_pmax_gather(layout):
    n = 5
    mesh = _mesh_of(n, layout)
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.integers(-100, 100, 7)).to(mesh.devices[s])
          for s in range(n)]
    stacked = np.stack([x.cpu().numpy() for x in xs])
    assert np.array_equal(mesh.psum(xs).numpy(), stacked.sum(0))
    assert np.array_equal(mesh.pmax(xs).numpy(), stacked.max(0))
    assert np.array_equal(mesh.gather(xs).numpy(), stacked.reshape(-1))
    scal = [torch.tensor(i * 3 - 5) for i in range(n)]
    assert int(mesh.psum(scal)) == sum(i * 3 - 5 for i in range(n))
    assert int(mesh.pmax(scal)) == (n - 1) * 3 - 5
    with pytest.raises(ValueError):
        mesh.psum(xs[:-1])


def test_shards_laid_round_robin_on_devices():
    mesh = PM.make_mesh(8, devices=["cpu"])
    assert PM.data_shards(mesh) == 8 and PM.mesh_replicas(mesh) == 1
    assert mesh.devices == [torch.device("cpu")] * 8
    assert mesh.layout() == "8 shards on cpu"
    two = PM.Mesh(3, [torch.device("cpu"), torch.device("cpu", 0)])
    assert two.devices == [torch.device("cpu"), torch.device("cpu", 0),
                           torch.device("cpu")]
    assert PM.make_mesh(devices=["cpu"]).n == 1


def test_make_mesh_without_gpu_raises(monkeypatch):
    """No device given and no GPU: an error, never CPU shards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PM.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PM.make_mesh(8)


def test_replica_slots_in_reference_order():
    """Serving replicas lay their `n * r` device slots out in the
    reference's order (`devices.reshape(n, r)`: slot [d, k] is data shard
    d of replica column k) and name the reference's axes; the data shards
    are column 0. A mesh of no shards is still refused."""
    devs = [f"cpu:{i}" for i in range(8)]
    for n, r in ((4, 2), (2, 4), (8, 1), (3, 2)):
        m = PM.make_mesh(n, devices=devs[:n * r], replicas=r)
        ref = JM.make_mesh(n, replicas=r)
        ids = np.asarray([d.id for d in ref.devices.reshape(-1)])
        assert [[d.index for d in row] for row in m.slots] \
            == ids.reshape(n, r).tolist()
        assert m.devices == [row[0] for row in m.slots]
        assert m.column(r - 1) == [row[r - 1] for row in m.slots]
        assert PM.data_shards(m) == JM.data_shards(ref) == n
        assert PM.mesh_replicas(m) == JM.mesh_replicas(ref) == r
        assert m.axis_names == tuple(ref.axis_names)
    # one device given: every slot shares it
    m = PM.make_mesh(2, devices=["cpu"], replicas=2)
    assert m.replicas == 2 and {d for row in m.slots for d in row} \
        == {torch.device("cpu")}
    with pytest.raises(ValueError):
        PM.Mesh(0, ["cpu"])
