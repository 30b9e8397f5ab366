"""The port's SQL front end where it differs from the JAX package's by
design: it takes an explicit torch device and never falls back to one
quietly.

* A device policy with no `torch_device` resolves to `cuda:0`, which
  raises with no GPU; a host-only `Database` needs none.
* `DeviceConfig(fuse=True)` without a mesh lowers a materialized view
  through `try_fuse` (ROADMAP queue 1 item 2c, ported): a plan over a
  DML table is outside the fused subset, so it plans per operator on the
  device, as the reference does; with a mesh it plans per operator too.
* `SET streaming_placement = 'process'` with parallelism > 1 (item 8's
  runtime half, ported) places an aggregation and a join in worker
  processes, whose rows equal the local placement's.
* The device marker (`device_mode.json`) reads the same in both
  packages, and a marked mesh directory reopens on the port's device.
* `import risingwave_tpu_torch.sql` in a fresh interpreter leaves
  neither `jax` nor any `risingwave_tpu` module in `sys.modules`."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from risingwave_tpu_torch.config import DeviceConfig
from risingwave_tpu_torch.ops import DeviceHashAggExecutor, HashAggExecutor
from risingwave_tpu_torch.parallel import make_mesh
from risingwave_tpu_torch.sql import Database
from risingwave_tpu_torch.sql.database import _walk_executors

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
MV = "CREATE MATERIALIZED VIEW m AS SELECT k, sum(v) AS s FROM t GROUP BY k"


def plan_classes(db, name):
    return [type(e).__name__ for e in _walk_executors(
        db.catalog.get(name).runtime["shared"].upstream)]


@pytest.mark.parametrize("device", [DeviceConfig(fuse=False), "on", 2])
def test_device_policy_without_torch_device_raises(device):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour with no GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Database(device=device)


@pytest.mark.parametrize("device", [None, "off"])
def test_host_only_database_needs_no_device(device):
    db = Database(device=device)
    assert db.device is None and db.torch_device is None
    db.run("CREATE TABLE t (k INT, v BIGINT)")
    db.run(MV)
    db.run("INSERT INTO t VALUES (1, 2), (1, 3)")
    assert db.query("SELECT * FROM m") == [(1, 5)]
    assert "HashAggExecutor" in plan_classes(db, "m")


@pytest.mark.parametrize("device", ["on", DeviceConfig(),
                                    DeviceConfig(fuse=True, capacity=64)])
def test_fused_policy_over_dml_table_plans_per_operator(device):
    """Item 2c is ported: a fused policy no longer raises. A DML table is
    no replayable source, so `try_fuse` refuses the plan and the MV plans
    per operator on the device."""
    db = Database(device=device, torch_device="cpu")
    db.run("CREATE TABLE t (k INT, v BIGINT)")
    db.run(MV)
    assert "m" not in db._fused
    assert (db.catalog.get("m").runtime or {}).get("fused_job") is None
    assert "DeviceHashAggExecutor" in plan_classes(db, "m")
    db.run("INSERT INTO t VALUES (1, 2), (1, 3)")
    db.flush()
    assert db.query("SELECT * FROM m") == [(1, 5)]


def test_fused_policy_with_mesh_plans_per_operator():
    """A `DeviceConfig` that carries a mesh never fuses, in the reference
    either: it plans per operator over the mesh."""
    mesh = make_mesh(2, devices=[CPU])
    db = Database(device=DeviceConfig(mesh=mesh), torch_device="cpu")
    db.run("CREATE TABLE t (k INT, v BIGINT)")
    db.run(MV)
    db.run("INSERT INTO t VALUES (1, 2), (2, 3), (1, 4)")
    assert sorted(db.query("SELECT * FROM m")) == [(1, 6), (2, 3)]
    aggs = [e for e in _walk_executors(db.catalog.get("m")
                                       .runtime["shared"].upstream)
            if isinstance(e, DeviceHashAggExecutor)]
    assert len(aggs) == 1 and aggs[0].mesh is mesh


@pytest.mark.parametrize("mv", [
    MV,
    "CREATE MATERIALIZED VIEW m AS SELECT t.k, u.w FROM t JOIN u "
    "ON t.k = u.k",
])
def test_process_placement_rows_equal_local(mv):
    """Item 8's runtime half is ported: process placement no longer
    raises. The MV plans a remote worker set (an owned-group agg or a
    hash join in worker processes) and its rows equal the local
    placement's."""
    rows = {}
    for placement in ("local", "process"):
        db = Database()
        db.run("CREATE TABLE t (k INT, v BIGINT)")
        db.run("CREATE TABLE u (k INT, w BIGINT)")
        db.run("SET streaming_parallelism TO 2")
        db.run(f"SET streaming_placement TO '{placement}'")
        db.run(mv)
        db.run("INSERT INTO t VALUES " + ", ".join(
            f"({i % 7}, {i})" for i in range(40)))
        db.run("INSERT INTO u VALUES (1, 10), (3, 30), (3, 31), (9, 90)")
        db.run("DELETE FROM t WHERE v < 5")
        db.flush()
        rows[placement] = sorted(db.query("SELECT * FROM m"))
        sets = [r for _name, r in db._remote_sets()]
        try:
            if placement == "process":
                assert [type(r).__name__ for r in sets] == \
                    ["RemoteStatefulSet"]
                assert len(sets[0].workers) == 2
                assert all(w.proc.poll() is None for w in sets[0].workers)
            else:
                assert sets == []
        finally:
            for r in sets:
                r.shutdown()
    assert rows["process"] == rows["local"] and rows["local"]


def test_local_parallel_agg_is_ported():
    db = Database()
    db.run("CREATE TABLE t (k INT, v BIGINT)")
    db.run("SET streaming_parallelism TO 3")
    db.run(MV)
    db.run("INSERT INTO t VALUES " + ", ".join(f"({i % 5}, {i})"
                                               for i in range(40)))
    assert sorted(db.query("SELECT * FROM m")) == sorted(
        db.query("SELECT k, sum(v) FROM t GROUP BY k"))
    assert "MergeExecutor" in plan_classes(db, "m")
    assert plan_classes(db, "m").count("FragmentPump") == 3


def _marker(d):
    with open(os.path.join(d, "device_mode.json")) as f:
        return json.load(f)["mode"]


@pytest.mark.parametrize("arm", ["off", "single", "single_minmax_off",
                                 "mesh8"])
def test_device_marker_reads_the_same(tmp_path, arm):
    from risingwave_tpu.config import DeviceConfig as RDC
    from risingwave_tpu.parallel import make_mesh as rmake_mesh
    from risingwave_tpu.sql import Database as RDB
    ref_dev, port_dev = {
        "off": ("off", "off"),
        "single": (RDC(fuse=False), DeviceConfig(fuse=False)),
        "single_minmax_off": (RDC(fuse=False, minmax=False),
                              DeviceConfig(fuse=False, minmax=False)),
        "mesh8": (RDC(fuse=False, mesh=rmake_mesh(8)),
                  DeviceConfig(fuse=False,
                               mesh=make_mesh(8, devices=[CPU]))),
    }[arm]
    RDB(data_dir=str(tmp_path / "ref"), device=ref_dev)
    Database(data_dir=str(tmp_path / "port"), device=port_dev,
             torch_device="cpu")
    assert _marker(tmp_path / "port") == _marker(tmp_path / "ref")


def test_marked_mesh_directory_reopens_on_the_torch_device(tmp_path):
    d = str(tmp_path)
    db = Database(data_dir=d, device=4, torch_device="cpu")
    assert db.device.mesh.n == 4 and db.device.mesh.devices == [CPU] * 4
    assert _marker(d) == "mesh:4:minmax"
    db.run("CREATE TABLE t (k INT, v BIGINT)")
    db.run(MV)
    db.run("INSERT INTO t VALUES (1, 2), (9, 3)")
    rows = sorted(db.query("SELECT * FROM m"))
    del db
    # "auto" adopts the marker's policy, its mesh on the given device
    db2 = Database(data_dir=d, device="auto", torch_device="cpu")
    assert db2.device.mesh.n == 4 and db2.torch_device == CPU
    assert sorted(db2.query("SELECT * FROM m")) == rows
    with pytest.raises(ValueError, match="reopened with device='single"):
        Database(data_dir=d, device=DeviceConfig(fuse=False),
                 torch_device="cpu")


def test_alter_parallelism_meshes_on_the_torch_device():
    db = Database(device=DeviceConfig(fuse=False), torch_device="cpu")
    db.run("CREATE TABLE t (k INT, v BIGINT)")
    db.run(MV)
    db.run("INSERT INTO t VALUES " + ", ".join(f"({i}, {i})"
                                               for i in range(20)))
    before = sorted(db.query("SELECT * FROM m"))
    assert db.run("ALTER MATERIALIZED VIEW m SET PARALLELISM 3") == \
        ["ALTER_PARALLELISM_1"]
    (agg,) = [e for e in _walk_executors(db.catalog.get("m")
                                         .runtime["shared"].upstream)
              if isinstance(e, DeviceHashAggExecutor)]
    assert agg.mesh.n == 3 and set(agg.mesh.devices) == {CPU}
    assert sorted(db.query("SELECT * FROM m")) == before


def test_host_only_alter_parallelism_makes_no_mesh():
    db = Database()
    db.run("CREATE TABLE t (k INT, v BIGINT)")
    db.run(MV)
    assert db.run("ALTER MATERIALIZED VIEW m SET PARALLELISM 4") == \
        ["ALTER_PARALLELISM_0"]
    assert not any(isinstance(e, DeviceHashAggExecutor)
                   for e in _walk_executors(db.catalog.get("m")
                                            .runtime["shared"].upstream))
    assert any(isinstance(e, HashAggExecutor)
               for e in _walk_executors(db.catalog.get("m")
                                        .runtime["shared"].upstream))


def test_sql_imports_neither_jax_nor_reference():
    code = ("import sys\n"
            "import risingwave_tpu_torch.sql\n"
            "import risingwave_tpu_torch.batch\n"
            "import risingwave_tpu_torch.connectors\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'risingwave_tpu' or "
            "m.startswith('risingwave_tpu.'))\n"
            "print(len(bad), bad[:5])\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "0", out.stdout
