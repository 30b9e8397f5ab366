"""The mesh skew defenses and the serving replicas against the JAX
package's own 8-shard runs: the mesh-marked cases of
`tests/test_skew_ops.py` and `tests/test_serving.py` run through the
mirror harness (`sql_mirror.py`) with fusion kept, under
`torch_ref_mesh.ref_mesh()`. Both packages' jobs rebalance their vnode
blocks and replicate a join's hot key at the same checkpoint
(`sql_mirror._sync_policy` holds the port's adoption to the
reference's), and every call's rows, `rw_key_skew` rows (`shard_load`,
`shard_skew`, `hot_policy`), catalogs and fused-job state must agree —
through the policy switch, a restart that restores the policy, `risectl
skew` on a dead directory, the merged pull's host fallback, and on a
(shard x replica) mesh.

`test_replica_reads_round_robin_over_replica_columns` also runs against
the port alone (`@port`): its asserts read the job's pulls and
`PULL_STATS`, which in mirror mode are the reference's.

Left out: `test_skew_ops.py::test_rebalance_switch_is_zero_fresh_compile`,
which counts the reference's compile service's compiles and its
ahead-of-time exchange executables across the switch; the port has no
compile service and compiles nothing per route (the exchange kernel
takes the bounds and hot keys as arguments).

Marked `slow`, as the reference marks it:
`test_serving.py::test_replica_mesh_bit_identity_q5` (q5 on a 4 x 2
mesh in both packages: ~90 s alone, ~230 s beside two copies of itself;
in one whole-suite run its worker process died of a segmentation fault
in a native thread, after that process had run the process-placement
tests). It passes alone; run it with the file."""
import pytest

from sql_mirror import cases, marks_of, run_case
from torch_ref_mesh import ref_mesh

NO_COMPILE_SERVICE = {"test_rebalance_switch_is_zero_fresh_compile"}
ROUND_ROBIN = "test_replica_reads_round_robin_over_replica_columns"
# they build their Database in `_fused`, called from `_rows`
REPLICAS = {"test_replica_mesh_bit_identity",
            "test_replica_mesh_bit_identity_q5"}
SLOW = {"test_replica_mesh_bit_identity_q5"}


def _mesh_marked(ref_file):
    def keep(cid):
        qual = cid.split("::", 1)[1].split("[")[0].split("@")[0]
        return "mesh" in marks_of(ref_file, qual)
    return keep


CASES = (cases("test_skew_ops.py", skip=NO_COMPILE_SERVICE,
               keep=_mesh_marked("test_skew_ops.py"))
         + cases("test_serving.py", keep=_mesh_marked("test_serving.py"),
                 mirror=REPLICAS, named_ids=True)
         + cases("test_serving.py", only={ROUND_ROBIN}, port={ROUND_ROBIN}))


@pytest.mark.parametrize("case", [
    pytest.param(c, id=c[0], marks=[pytest.mark.slow] if c[2] in SLOW
                 else []) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch, capsys):
    _cid, ref_file, qual, kw, mode = case
    with ref_mesh():
        run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch, fuse=True,
                 capsys=capsys)
