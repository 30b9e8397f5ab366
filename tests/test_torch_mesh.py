"""The port's shard mesh (`risingwave_tpu_torch/parallel/mesh.py`): the
vnode-block layout against the JAX package's, the collectives' semantics
over per-shard tensors, and no CPU fallback when no device is given."""
import numpy as np
import pytest
import torch

import risingwave_tpu.parallel.mesh as JM
from risingwave_tpu_torch.core.vnode import VNODE_COUNT
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
def test_all_to_all_is_source_major(n, layout):
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
    # the bucket exchange's collective: the same swap, flattened per
    # receiver, whether the sources wrote into one stacked allocation (one
    # device) or buffers of their own
    placed = []

    def place(s, out):
        placed.append(out is None)
        if out is None:
            return [send[s].clone()]
        out[0].copy_(send[s])
        return out
    got = mesh.exchange(place, [send[0].dtype], 5)
    assert placed == [not mesh.single_device] * n
    for d in range(n):
        assert len(got[d]) == 1
        assert torch.equal(got[d][0].cpu(), recv[d].reshape(-1).cpu())


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


def test_mesh_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        PM.make_mesh(2, devices=["cpu"], replicas=2)
    with pytest.raises(ValueError):
        PM.Mesh(0, ["cpu"])
