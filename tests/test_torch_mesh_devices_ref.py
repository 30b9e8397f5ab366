"""The fused mesh over several devices against the JAX package's own
8-device runs: reference mesh cases run through the mirror harness
(`sql_mirror.py`) with fusion kept, under `torch_ref_mesh.ref_mesh()`,
with the port's `Database` given the eight CPU device names `cpu:0` ..
`cpu:7` as its device set (`run_case(..., devices=...)`). The port then
lays its 8 shards one a device, as the reference lays its shards over
its eight virtual CPU devices, so every exchange takes the cross-device
form (one `bucket_exchange` call a source, then `all_to_all`), every
reduction gathers from eight devices, and a (4 x 2) mesh puts each
replica column on devices of its own. Every call's rows (in order), the
catalogs and each fused job's counters, replays, policies, tier counters
and stats totals must equal the reference's.

The cases: q1, q3 and q5 sharded against 1 shard, an exchange bucket
that overflows and grows, the device marker and a reopen
(`test_mesh_fused.py`); the skew policy's rebalance
(`test_skew_ops.py`); per-shard host feeds (`test_ingest.py`); per-shard
cold stores (`test_tiering.py`); q1 on a (4 x 2) replica mesh
(`test_serving.py`).

On the CPU every tensor lies on `cpu` whatever its device's name, so
what these cases hold is the cross-device code's arithmetic and order;
the copies, streams and events between a card and the CPU run on the
card (`chip_smoke.py --mesh-devices`)."""
import pytest
import torch

from sql_mirror import cases, run_case
from torch_ref_mesh import ref_mesh

DEVICES = [torch.device("cpu", i) for i in range(8)]

CASES = (cases("test_mesh_fused.py", only={
    "test_q1_agg_bit_identity", "test_q3_join_bit_identity",
    "test_q5_hop_agg_join_bit_identity",
    "test_exchange_overflow_grows_and_replays",
    "test_mesh_marker_and_recovery"})
    + cases("test_skew_ops.py",
            only={"test_q1_mesh_defenses_bit_identity_and_rebalance"})
    + cases("test_ingest.py", only={"test_mesh_host_fed_bit_identity"})
    + cases("test_tiering.py", only={"test_agg_demotion_bit_identity_mesh"})
    + cases("test_serving.py", only={"test_replica_mesh_bit_identity"},
            mirror={"test_replica_mesh_bit_identity"}, named_ids=True,
            keep=lambda cid: cid.endswith("[q1]")))


@pytest.fixture(scope="module")
def reference_mesh():
    """The shim around this module's cases together: the reference's
    traced mesh programs stay cached from one case to the next, so a
    case reuses what an earlier one traced; pytest ends the block before
    it runs a test of another module in the same process."""
    with ref_mesh():
        yield


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case_over_8_devices(case, reference_mesh, tmp_path,
                                       monkeypatch, capsys):
    _cid, ref_file, qual, kw, mode = case
    assert mode == "mirror"
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch, fuse=True,
             capsys=capsys, devices=DEVICES)
