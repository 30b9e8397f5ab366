"""The JAX package's 8-shard fused runs as the port's oracle: every case
of `tests/test_mesh_fused.py` and the mesh-marked cases of
`tests/test_ingest.py`, `tests/test_tiering.py` and
`tests/test_flow_telemetry.py` run through the mirror harness
(`sql_mirror.py`) with fusion kept, under `torch_ref_mesh.ref_mesh()`
(the reference's `shard_map` made traceable under the installed jax for
the case's duration only). Both packages run the sharded fused program —
the reference over its eight virtual CPU devices, the port over an
8-shard `Mesh` on the CPU — and every call's rows (in order), the
catalogs and each fused job's counters, replays, node capacities and
stats totals must agree: the bit-identity of the sharded program with
the 1-shard one, a cadence that does not divide the shards, an exchange
bucket that overflows and grows, the profiler's shards, the device
marker and a reopen; host-fed jobs whose windows are cut into the
shards' event blocks; a tiered group-by whose per-shard cold stores
demote and promote; the flow totals' shard invariance.

The three cases of `test_mesh_fused.py` that build no `Database` (the
vnode-block edges) run against the port alone.

Left out: `test_mesh_fused.py::test_offline_compile_status_dead_dir`,
which reads the reference's compile service's manifest through `risectl
compile-status --offline`; the port has no compile service (its kernels
are built once per process), so its command answers `"aot": false` and
exits 1 offline.

Each case runs the reference's 8-device programs and the port's 8-shard
programs on the CPU; the file takes about five minutes alone."""
import pytest

from sql_mirror import cases, marks_of, run_case
from torch_ref_mesh import ref_mesh

NO_COMPILE_SERVICE = {"test_offline_compile_status_dead_dir"}


def _mesh_marked(ref_file):
    def keep(cid):
        qual = cid.split("::", 1)[1].split("[")[0].split("@")[0]
        return "mesh" in marks_of(ref_file, qual)
    return keep


CASES = (cases("test_mesh_fused.py", skip=NO_COMPILE_SERVICE)
         + cases("test_ingest.py", keep=_mesh_marked("test_ingest.py"))
         + cases("test_tiering.py", keep=_mesh_marked("test_tiering.py"))
         + cases("test_flow_telemetry.py",
                 keep=_mesh_marked("test_flow_telemetry.py")))


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch, capsys):
    _cid, ref_file, qual, kw, mode = case
    with ref_mesh():
        run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch, fuse=True,
                 capsys=capsys)
