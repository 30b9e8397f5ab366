"""Serving-pull accounting (`device/shard_exec.PULL_STATS`,
`reset_pull_stats`, `_count_pull`) in the port against the JAX
package's: a fused job's SELECT pull (`FusedJob.mv_rows_now`, what a
SELECT over a fused MV calls through the read cache) and a sharded
merged pull (`merge_keyed_pull`, `merge_pair_pull`, each on the host
path) raise `device_pulls` by one in both packages, each registry's
`serving_device_pulls_total` with it, and `rw_serving_pulls` then reads
the same rows in both. Pulls over serving replicas (round-robin over
the replica columns) are held in `test_torch_mesh_policy.py` and the
mirror's mesh cases (`test_torch_sql_mirror_mesh_skew.py`)."""
from types import SimpleNamespace as NS

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import risingwave_tpu.device.shard_exec as RSE
import risingwave_tpu.sql.system_catalog as RSC
import risingwave_tpu_torch.device.shard_exec as PSE
import risingwave_tpu_torch.sql.system_catalog as PSC
import test_torch_fused_q4 as F4
from risingwave_tpu.parallel.mesh import make_mesh as rmake_mesh
from risingwave_tpu.utils.metrics import REGISTRY as RREG
from risingwave_tpu_torch.device.sorted_state import EMPTY_KEY
from risingwave_tpu_torch.parallel.mesh import make_mesh
from risingwave_tpu_torch.utils.metrics import REGISTRY as PREG
from torch_parity import port_job

CPU = torch.device("cpu")
N, CAP = 2, 4


def pulls_total(reg):
    return reg.counter("serving_device_pulls_total",
                       "host transfers of MV state for SELECT "
                       "serving").labels().value


@pytest.fixture(autouse=True)
def reset():
    RSE.reset_pull_stats()
    PSE.reset_pull_stats()
    yield
    RSE.reset_pull_stats()
    PSE.reset_pull_stats()


def both_counted(n):
    assert RSE.PULL_STATS == PSE.PULL_STATS == {
        "device_pulls": n, "replica_pulls": {0: n}}
    rows = PSC._serving_pulls(None)
    assert rows == RSC._serving_pulls(None) == [(0, n), (-1, n)]


def test_fused_select_pull_counts_one():
    ref_job, _half, want = F4.reference_run("0")
    job = port_job(ref_job, 64)
    for t in range(F4.TICKS):
        job.on_barrier(F4.barrier(t + 1))
    job.sync()
    RSE.reset_pull_stats()
    PSE.reset_pull_stats()
    r0, p0 = pulls_total(RREG), pulls_total(PREG)
    assert ref_job.mv_rows_now() == want
    assert job.mv_rows_now() == want
    both_counted(1)
    assert pulls_total(RREG) - r0 == pulls_total(PREG) - p0 == 1


# two shards of a keyed MV (one value column) and of a pair MV
KEYS = [[5, 1, EMPTY_KEY, EMPTY_KEY], [4, 2, 3, EMPTY_KEY]]
COUNTS = [2, 3]
VALS = [[10, 20, 0, 0], [30, 40, 50, 0]]
NULLS = [[False, True, False, False], [False, False, True, False]]


def keyed_states():
    ref = NS(keys=jnp.asarray(KEYS, jnp.int64),
             count=jnp.asarray(COUNTS, jnp.int32),
             vals=[jnp.zeros((N, CAP), jnp.int64),
                   jnp.asarray(VALS, jnp.int64),
                   jnp.asarray(NULLS, bool)])
    port = [NS(keys=torch.tensor(KEYS[s]), count=torch.tensor(COUNTS[s]),
               vals=[torch.zeros(CAP, dtype=torch.int64),
                     torch.tensor(VALS[s]), torch.tensor(NULLS[s])])
            for s in range(N)]
    return ref, port


def pair_sides():
    jk = [[7, 3, 0, 0], [3, 9, 1, 0]]
    pk = [[1, 2, 0, 0], [5, 1, 4, 0]]
    ref = NS(jk=jnp.asarray(jk, jnp.int64), pk=jnp.asarray(pk, jnp.int64),
             count=jnp.asarray(COUNTS, jnp.int32),
             vals=[jnp.asarray(VALS, jnp.int64)])
    port = [NS(jk=torch.tensor(jk[s]), pk=torch.tensor(pk[s]),
               count=torch.tensor(COUNTS[s]), vals=[torch.tensor(VALS[s])])
            for s in range(N)]
    return ref, port


def test_merged_keyed_pull_counts_one():
    ref, port = keyed_states()
    r0, p0 = pulls_total(RREG), pulls_total(PREG)
    rk, rc, rn = RSE.merge_keyed_pull(ref, rmake_mesh(N), ["int64"])
    pk, pc, pn = PSE.merge_keyed_pull(port, make_mesh(N, devices=[CPU]),
                                      [torch.int64])
    both_counted(1)
    assert pulls_total(RREG) - r0 == pulls_total(PREG) - p0 == 1
    assert np.asarray(pk).tolist() == np.asarray(rk).tolist() == \
        [1, 2, 3, 4, 5]
    assert [np.asarray(c).tolist() for c in pc] == \
        [np.asarray(c).tolist() for c in rc]
    assert [np.asarray(u).tolist() for u in pn] == \
        [np.asarray(u).tolist() for u in rn]


def test_merged_pair_pull_counts_one():
    ref, port = pair_sides()
    rn, rv = RSE.merge_pair_pull(ref, rmake_mesh(N))
    pn, pv = PSE.merge_pair_pull(port, make_mesh(N, devices=[CPU]))
    both_counted(1)
    assert pn == rn == 5
    assert [np.asarray(v).tolist() for v in pv] == \
        [np.asarray(v).tolist() for v in rv]


def test_pulls_add_up_across_kinds():
    ref, port = keyed_states()
    RSE.merge_keyed_pull(ref, rmake_mesh(N), ["int64"])
    PSE.merge_keyed_pull(port, make_mesh(N, devices=[CPU]), [torch.int64])
    ref, port = pair_sides()
    RSE.merge_pair_pull(ref, rmake_mesh(N))
    PSE.merge_pair_pull(port, make_mesh(N, devices=[CPU]))
    both_counted(2)
