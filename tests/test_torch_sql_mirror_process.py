"""The JAX package's process-placement tests (`tests/test_remote_fragments.py`)
and its failpoint tests (`tests/test_failpoints.py`) run against the port
through the mirror harness (`sql_mirror.py`): worker OS processes over
the credit-flow socket exchange, the 2-phase partial agg, the
owned-group agg and the remote hash join, inner and outer.

The cases that only drive SQL run in "mirror" mode: a `MirrorDatabase`
holds the port's `Database` (on the CPU, its workers running
`risingwave_tpu_torch.runtime.worker`) to the reference's call by call,
executor trees included, query rows as multisets (`run_case`'s
`unordered`: a row id's fake-clock tick depends on the workers'
timing). The cases that kill a worker process run in
"port" mode (`PORT_MODE`): every `risingwave_tpu` import gives the port's
module, so the case's own asserts (its oracle, `RemoteWorkerDied`, the
restart that re-seeds fresh workers) hold the port alone — a mirror case
reaches only the reference's worker set, and a kill of one package's
worker cannot be twinned exactly in the other's. The failpoint cases
build no `Database` and run in port mode as well. Every worker a case
spawns is killed, and the pressure boards cleared, when it ends
(`process_case`).

Left out: `test_process_placement_wall_clock_overhead_bounded`, marked
`slow` in the reference (the tier-1 lane runs `not slow`)."""
import pytest

from sql_mirror import cases, marks_of, process_case, run_case

PORT_MODE = {"test_worker_kill_detected_and_recovered",
             "TestRemoteJoin.test_worker_kill_recovers_with_seeded_state",
             "test_heartbeat_detects_quiescent_worker_death",
             "TestRemoteRetractableAgg.test_worker_kill_reseeds_agg_state"}


def _not_slow(ref_file):
    def keep(cid):
        qual = cid.split("::", 1)[1].split("[")[0].split("@")[0]
        return "slow" not in marks_of(ref_file, qual)
    return keep


CASES = (cases("test_remote_fragments.py", port=PORT_MODE,
               keep=_not_slow("test_remote_fragments.py"))
         + cases("test_failpoints.py"))


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch, capsys):
    _cid, ref_file, qual, kw, mode = case
    with process_case():
        run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch,
                 capsys=capsys, twins=True, unordered=True)
