"""The JAX package's multi-role chaos tests (`tests/test_chaos_multirole.py`)
run against the port through the mirror harness (`sql_mirror.py`), all
in "port" mode: every `risingwave_tpu` import gives the port's module, so
each case's own asserts hold the port alone — a worker killed mid-stream
under an exactly-once sink, the supervisor's in-place respawn of a
partial-agg, owned-group agg and join worker (re-seeded from the
coordinator's shadows, rows equal to an undisturbed run), the seeded
`fragment.drain` flap, and the crash-looping worker that escalates to
full recovery. Each case kills the port's worker processes, which a
mirror case could not reach (it walks the reference's plan), and a kill
of one package's worker at the same point of the other's stream cannot
be twinned exactly. Every worker a case spawns is killed, and the
pressure boards cleared, when it ends (`process_case`). No case is left
out."""
import pytest

from sql_mirror import cases, process_case, run_case

REF = "test_chaos_multirole.py"
# every case in port mode
CASES = cases(REF, port={c[2] for c in cases(REF)})


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch, capsys):
    _cid, ref_file, qual, kw, mode = case
    with process_case():
        run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch,
                 capsys=capsys, twins=True)
