"""`risectl` of the port (`python -m risingwave_tpu_torch.ctl`) against
the JAX package's `tests/test_ctl.py`, through the mirror harness
(`sql_mirror.py`).

Each reference case runs twice:
- "mirror": the case's `Database` is a `MirrorDatabase`, and each
  `ctl.main` call runs both packages' `risectl`, each against the data
  directory its own package wrote. Exit codes and output must be equal
  (exact; the wall-clock fields of `trace` / `profile` / `blackbox` /
  `compile-status` masked, `metrics` compared by its two gauges: each
  package's registry is process-wide).
- "port": every import of the JAX package is the port's, so the case's
  own asserts hold the port alone (its Database and `risectl` on the
  CPU).

Beside them: the commands a user runs on a data directory of the port
that the reference cases do not reach — `compile-status` (no compile
service: `"aot": false`, `--offline` finds no manifest) and
`failpoints`, which lists the port's declared points in a process that
never imports the JAX package."""
import json
import os
import subprocess
import sys

import pytest
import torch

from sql_mirror import cases, run_case

CASES = [pytest.param(c[:4] + (mode,), id=f"{c[0]}@{mode}")
         for c in cases("test_ctl.py") for mode in ("mirror", "port")]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, tmp_path, monkeypatch, capsys):
    _cid, ref_file, qual, kw, mode = case
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch, capsys=capsys,
             twins=True)


def _fused_dir(d):
    from risingwave_tpu_torch.config import DeviceConfig
    from risingwave_tpu_torch.sql import Database
    db = Database(data_dir=d, device=DeviceConfig(capacity=64),
                  torch_device="cpu")
    db.run("CREATE SOURCE bid (auction BIGINT, bidder BIGINT, price BIGINT,"
           " channel VARCHAR, url VARCHAR, date_time TIMESTAMP,"
           " extra VARCHAR) WITH (connector='nexmark',"
           " nexmark.table='bid', nexmark.max.events='2048',"
           " nexmark.chunk.size='32')")
    db.run("CREATE MATERIALIZED VIEW q4 AS SELECT auction, count(*) AS c,"
           " max(price) AS m FROM bid GROUP BY auction")
    job = db._fused["q4"]
    while not job.drained:
        db.tick()
    db.tick()
    db.store.close()


def test_compile_status_reports_profiler_events(tmp_path, capsys):
    """No compile service in the port: a fused job answers as the
    reference's does with aot_compile=False, its signatures the compile
    and retrace events the recovered job's profiler holds."""
    from risingwave_tpu_torch import ctl
    d = str(tmp_path / "d")
    _fused_dir(d)
    assert ctl.main(["compile-status", "--data-dir", d,
                     "--torch-device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    rep = out["q4"]
    assert rep["aot"] is False and rep["plan_hash"]
    assert all(r["state"] == "ready" and r["cache_hit"] is False
               for r in rep["signatures"])
    assert rep["counts"]["ready"] == len(rep["signatures"])
    assert rep["counts"]["pending"] == rep["counts"]["failed"] == 0
    with pytest.raises(SystemExit, match="no fused job 'nope'"):
        ctl.main(["compile-status", "nope", "--data-dir", d,
                  "--torch-device", "cpu"])
    assert ctl.main(["compile-status", "--data-dir", d, "--offline"]) == 1
    assert "no compile manifest" in capsys.readouterr().out


def test_fused_stats_and_jobs_of_a_fused_dir(tmp_path, capsys):
    from risingwave_tpu_torch import ctl
    d = str(tmp_path / "d")
    _fused_dir(d)
    assert ctl.main(["jobs", "--data-dir", d]) == 0
    out = capsys.readouterr().out
    assert "SOURCE" in out and "MATERIALIZED VIEW  q4" in out
    assert ctl.main(["fused-stats", "--data-dir", d,
                     "--torch-device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out)["q4"]
    assert rep["committed_events"] == 2048 and rep["growth_replays"] >= 1


def test_failpoints_lists_port_points_without_jax():
    """`python -m risingwave_tpu_torch.ctl failpoints` in a fresh process:
    the fused, spill-store, sink and process-placement (worker, exchange,
    fragment spawn) points listed, neither `jax` nor the JAX package
    imported."""
    code = ("import runpy, sys\n"
            "sys.argv = ['ctl', 'failpoints']\n"
            "try:\n"
            "    runpy.run_module('risingwave_tpu_torch.ctl',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'"
            " or m.startswith('jax.') or m == 'risingwave_tpu'"
            " or m.startswith('risingwave_tpu.'))\n"
            "print('IMPORTED', bad)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "IMPORTED []" in r.stdout
    for point in ("fused.dispatch", "fused.device_sync",
                  "fused.growth_replay", "fused.checkpoint_commit",
                  "state.spill_write", "state.manifest_commit",
                  "worker.crash", "worker.poison_pill",
                  "overload.slow_worker", "exchange.connect",
                  "exchange.send_frame", "exchange.recv_frame",
                  "fragment.spawn", "fragment.drain"):
        assert point in r.stdout, point


def test_card_dir_does_not_fall_back_to_the_cpu(tmp_path):
    """A directory whose marker names the device path opens on `cuda:0`
    unless `--torch-device` says otherwise: with no GPU, the commands
    that open a Database raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("holds the behaviour of a host with no GPU")
    from risingwave_tpu_torch import ctl
    d = str(tmp_path / "d")
    _fused_dir(d)
    for argv in (["fused-stats"], ["dump", "q4"], ["metrics"],
                 ["compile-status"], ["tiering"], ["serving"]):
        with pytest.raises(RuntimeError):
            ctl.main(argv + ["--data-dir", d])
