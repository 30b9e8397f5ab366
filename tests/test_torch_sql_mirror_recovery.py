"""The fused cases of the JAX package's fault-tolerance and overload
suites (`tests/test_ft3.py`, `tests/test_overload.py`) run against the port
through the mirror harness (`sql_mirror.py`) with fusion kept: an armed
`fused.*` failpoint fires in both packages at the same hit and each job
heals in place (one recovery, the same job object, the rows of an
undisturbed run), a fault in a growth replay recovers at the grown
capacities, the attempts' bound escalates with the original error, a
fault in a SELECT's sync heals inside the query, the bounded epoch log
spills and reloads, and a burst under the overload ladder's throttle
stays exact — each held to the reference's call by call. Left out: the
compile-count cases (`aot`-marked), which count the JAX package's
background compile service: the port has no compile service (its kernels
are built once per process and nothing is traced per shape)."""
import pytest

from sql_mirror import cases, marks_of, run_case

FT3 = {"test_fused_device_fault_recovers_in_place_bit_identical",
       "test_fused_growth_replay_fault_recovers",
       "test_fused_recovery_attempts_bound_escalates"}
OVERLOAD = {"test_epoch_log_spills_and_reloads",
            "test_burst_under_pressure_is_bit_identical_with_shed_off",
            "test_mv_rows_now_recovers_from_select_path_device_fault"}


def _no_aot(ref_file):
    def keep(cid):
        qual = cid.split("::", 1)[1].split("[")[0].split("@")[0]
        return "aot" not in marks_of(ref_file, qual)
    return keep


CASES = (cases("test_ft3.py", only=FT3, keep=_no_aot("test_ft3.py"))
         + cases("test_overload.py", only=OVERLOAD,
                 keep=_no_aot("test_overload.py")))


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch):
    _cid, ref_file, qual, kw, mode = case
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch, fuse=True)
