"""The JAX package's supervision-v2 chaos suite (`tests/test_supervision2.py`)
runs against the port through the mirror harness (`sql_mirror.py`), all
in "port" mode: every `risingwave_tpu` import gives the port's module, so
each case's own asserts hold the port alone — a q3 join worker killed
mid-epoch on either slot and respawned from both sides' shadows, the
seeded `fragment.drain` flap, a SIGSTOPped worker reaped and respawned,
the incremental refresh's changed-groups bound, zero duplicates at a
sink across a respawn (incremental and full refresh), the escalation
reasons' registry read off the port's `remote_fragments` source, and the
failpoint ledger's record and replay. The cases patch the port's input
channels and kill or stop the port's worker processes, which a mirror
case could not reach (it walks the reference's plan). Every worker a
case spawns is killed, and the pressure boards cleared, when it ends
(`process_case`). No case is left out."""
import pytest

from sql_mirror import cases, process_case, run_case

REF = "test_supervision2.py"
# every case in port mode
CASES = cases(REF, port={c[2] for c in cases(REF)})


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch, capsys):
    _cid, ref_file, qual, kw, mode = case
    with process_case():
        run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch,
                 capsys=capsys, twins=True)
