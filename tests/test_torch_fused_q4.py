"""The port's fused q4 epoch program (on the CPU) against the JAX
package's fused q4 job, built by the reference SQL front end.

The port's node graph is built from the reference job's own node
parameters (generator config, column names, group columns, pack fields,
agg spec, epoch cadence); both jobs are driven barrier by barrier and
must return the same MV rows in the same (key) order.
"""
import ast
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import risingwave_tpu.device.fused as JF
from risingwave_tpu.config import DeviceConfig
from risingwave_tpu.sql import Database
from risingwave_tpu_torch.device import fused as PF
from risingwave_tpu_torch.device import resolve_device
from risingwave_tpu_torch.device.state_io import (states_from_numpy,
                                                  states_to_numpy)
from torch_parity import (assert_same, port_calls, port_job, port_pack,
                          port_spec)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 5_000
CHUNK = 32          # fused epoch = 64 * CHUNK = 2048 events
TICKS = N // (64 * CHUNK) + 3
HALF = 2            # carry-across point: after this many checkpoints
BID_SRC = ("CREATE SOURCE bid (auction BIGINT, bidder BIGINT, price BIGINT,"
           " channel VARCHAR, url VARCHAR, date_time TIMESTAMP,"
           " extra VARCHAR) WITH (connector='nexmark',"
           " nexmark.table='bid', nexmark.max.events='{n}',"
           " nexmark.chunk.size='{c}')")
Q4 = ("CREATE MATERIALIZED VIEW q4 AS SELECT auction, count(*) AS c,"
      " sum(price) AS s, max(price) AS m FROM bid GROUP BY auction")

_RUNS = {}


def reference_run(precombine: str):
    """Drive the reference fused q4 job to the end (capacity 64, so it
    grows and replays); keep its states at the carry-across point. The
    AOT compile service is off: it only moves compiles off the epoch
    loop, and its background compiles would dominate this test's time."""
    if precombine not in _RUNS:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RW_AGG_PRECOMBINE", precombine)
            db = Database(device=DeviceConfig(capacity=64,
                                              aot_compile=False))
            db.run(BID_SRC.format(n=N, c=CHUNK))
            db.run(Q4)
            job = db._fused["q4"]
            half = None
            for t in range(TICKS):
                db.tick()
                if t + 1 == HALF:
                    half = (jax.device_get(job.states), job.counter)
            rows = job.mv_rows_now()
        _RUNS[precombine] = (job, half, rows)
    return _RUNS[precombine]


def port_q4_job(ref_job):
    """The port's q4 job, from the reference job's node parameters."""
    return port_job(ref_job, 64)


def barrier(epoch):
    return SimpleNamespace(is_checkpoint=True,
                           epoch=SimpleNamespace(curr=epoch))


@pytest.mark.parametrize("precombine", ["1", "0"])
def test_q4_rows_match_reference(precombine):
    ref_job, _, want = reference_run(precombine)
    job = port_q4_job(ref_job)
    assert [type(n).__name__ for n in job.program.nodes] == \
        [type(n).__name__ for n in ref_job.program.nodes]
    for t in range(TICKS):
        job.on_barrier(barrier(t + 1))
    got = job.mv_rows_now()
    assert len(got) == len(want) > 0
    assert got == want                       # same rows, same key order
    assert job.growth_replays >= 1           # capacity 64 had to grow
    assert job.committed == ref_job.committed


def test_q4_state_carry_across():
    """Run the reference halfway, carry its states into the port, finish
    both: the same rows."""
    ref_job, (np_states, counter), want = reference_run("1")
    job = port_q4_job(ref_job)
    states = states_from_numpy(job.program, np_states, "cpu")
    for st, ref in zip(states_to_numpy(job.program, states), np_states):
        for a, b in zip(jax.tree_util.tree_leaves(st),
                        jax.tree_util.tree_leaves(ref)):
            assert a.dtype == np.asarray(b).dtype
            assert np.array_equal(a, np.asarray(b))
    job.load_states(states, counter)
    for t in range(HALF, TICKS):
        job.on_barrier(barrier(t + 1))
    assert job.mv_rows_now() == want


@pytest.mark.parametrize("combined,cap,with_pk", [
    (False, 64, False), (True, 64, True), (False, 512, True),
    (True, 512, False)])
def test_agg_node_emit_out(combined, cap, with_pk):
    """AggNode with its change stream on (emit_out, which q4's terminal
    MV never needs): raw and pre-combined arms, with capacity 64 forcing
    the 2 * capacity compaction bound, with and without a pk pack."""
    ref_job, _, _ = reference_run("1")
    jpre, jsrc = ref_job.program.nodes[1], ref_job.program.nodes[2]
    jpk = JF.PackPlan.plan([(1000, 1304, 1), (0, 5000, 1),
                            (0, 50_000_000, 1), (100, 10_099, 1)]) \
        if with_pk else None
    jagg = JF.AggNode(0, jsrc.group_idx, jsrc.calls, jsrc.pack, jsrc.spec,
                      cap, jpk)
    pagg = PF.AggNode(0, jsrc.group_idx, port_calls(jsrc.calls),
                      port_pack(jsrc.pack), port_spec(jsrc.spec, jsrc.calls), cap,
                      port_pack(jpk) if with_pk else None, device="cpu")
    ppre = PF.PrecombineNode(0, jpre.group_idx, port_calls(jpre.calls),
                             port_pack(jpre.pack), port_spec(jpre.spec, jpre.calls),
                             device="cpu")
    if combined:
        jagg.enable_precombine()
        pagg.enable_precombine()
    assert jagg.emit_out and pagg.emit_out
    jst, pst = jagg.init_state(), pagg.init_state()
    rng = np.random.default_rng(cap + 2 * combined + with_pk)
    n = 512
    for _ in range(2):
        auction = rng.integers(1000, 1100, n)
        price = rng.integers(100, 10_100, n)
        mask = rng.random(n) < 0.9
        jd = JF.Delta([jnp.asarray(auction), jnp.asarray(price),
                       jnp.asarray(price)], jnp.ones(n, jnp.int32),
                      jnp.asarray(mask))
        pd = PF.Delta([torch.from_numpy(auction), torch.from_numpy(price),
                       torch.from_numpy(price)],
                      torch.ones(n, dtype=torch.int32),
                      torch.from_numpy(mask))
        if combined:
            _, jd, _, _ = jpre.apply(None, [jd], None, n)
            _, pd, _, _ = ppre.apply(None, [pd], None, n)
        jst, jout, jstats, jaux = jagg.apply(jst, [jd], None, n)
        pst, pout, pstats, paux = pagg.apply(pst, [pd], None, n)
        assert_same((pst, pout, pstats), (jst, jout, jstats))
        assert sorted(paux) == sorted(jaux)
        assert_same(paux, jaux)


def test_packbad_raises_at_sync():
    ref_job, _, _ = reference_run("1")
    job = port_q4_job(ref_job)
    chain = job.program.nodes[0]
    src = chain.chain[0]
    real = src.apply

    def out_of_range(*a):
        st, d, s, aux = real(*a)
        d.cols[0] = d.cols[0] + (1 << 30)    # auction past its proven range
        return st, d, s, aux
    src.apply = out_of_range
    job.on_barrier(SimpleNamespace(is_checkpoint=False,
                                   epoch=SimpleNamespace(curr=1)))
    with pytest.raises(RuntimeError, match="bounds violated"):
        job.mv_rows_now()


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PF.MapNode(0, [])
    else:
        assert resolve_device() == torch.device("cuda", 0)


def _port_modules():
    pkg = ROOT / "risingwave_tpu_torch"
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in pkg.rglob("*.py"))


def test_port_imports_neither_jax_nor_reference():
    """Importing the port and every submodule, in a fresh interpreter,
    leaves `jax` and `risingwave_tpu` out of sys.modules."""
    mods = _port_modules()
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'risingwave_tpu' or "
            "m.startswith('risingwave_tpu.'))\n"
            "print(len(bad), bad[:5])\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "0", out.stdout


def test_no_static_reference_imports():
    """No `import jax` / `risingwave_tpu` in the port or chip_smoke.py."""
    files = list((ROOT / "risingwave_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        tree = ast.parse(f.read_text(), filename=str(f))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for nm in names:
                top = nm.split(".")[0]
                assert top not in ("jax", "jaxlib", "risingwave_tpu"), \
                    f"{f}: imports {nm}"
