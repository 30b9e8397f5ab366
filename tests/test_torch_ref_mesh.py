"""`torch_ref_mesh.ref_mesh()`, the scoped shim under which the JAX
package's 8-shard fused programs run as the port's oracle, leaves nothing
behind: after the block the reference's `_shard_map`, its exchange
pre-warm, its four program caches, its set of inline-traced exchange keys
and its compile service's entries are as they were before it, and the reference's mesh path fails
again exactly as it does without the shim (the installed jax rejects its
`check_rep` argument) — so the JAX package's own mesh tests meet the same
state in any worker, whatever ran there before."""
import inspect

import pytest

import risingwave_tpu.device.shard_exec as SE
from risingwave_tpu.config import DeviceConfig
from risingwave_tpu.sql import Database
from torch_ref_mesh import CACHES, ref_mesh, snapshot

BID_SRC = ("CREATE SOURCE bid (auction BIGINT, bidder BIGINT, price BIGINT,"
           " channel VARCHAR, url VARCHAR, date_time TIMESTAMP,"
           " extra VARCHAR) WITH (connector='nexmark',"
           " nexmark.table='bid', nexmark.max.events='2048',"
           " nexmark.chunk.size='32')")
Q1_MV = ("CREATE MATERIALIZED VIEW q1a AS SELECT bidder,"
         " count(*) AS n, sum(price) AS dol, max(price) AS top"
         " FROM bid GROUP BY bidder")


def _drive(aot):
    db = Database(device=DeviceConfig(capacity=512, mesh_shards=8,
                                      aot_compile=aot, compile_buckets=0))
    db.run(BID_SRC)
    db.run(Q1_MV)
    for _ in range(3):
        db.tick()
    return db.query("SELECT * FROM q1a")


def _state(snap):
    return (snap["_shard_map"], snap["prewarm_exchange"],
            {n: (id(obj), sorted(map(repr, saved)))
             for n, (obj, saved) in snap["caches"].items()},
            snap["service"][0],
            None if snap["service"][1] is None
            else sorted(map(repr, snap["service"][1])))


@pytest.mark.parametrize("aot", [False, True])
def test_shim_leaves_nothing_behind(aot):
    rejects = "check_rep" not in inspect.signature(
        SE._shard_map).parameters
    before = snapshot()
    with ref_mesh():
        assert SE._shard_map is not before["_shard_map"]
        assert SE.prewarm_exchange is not before["prewarm_exchange"]
        rows = _drive(aot)
        assert len(rows) > 0
        # the sharded programs were traced and kept under the shim
        assert any(len(getattr(SE, n)) for n in CACHES)
    after = snapshot()
    assert SE._shard_map is before["_shard_map"]
    assert SE.prewarm_exchange is before["prewarm_exchange"]
    assert _state(after) == _state(before)
    svc = after["service"][0]
    if svc is not None:
        assert not [k for k, e in svc._entries.items()
                    if e.mesh is not None
                    and (before["service"][0] is not svc
                         or k not in before["service"][1])]
    if rejects:
        # outside the block the reference's mesh path fails as before
        with pytest.raises(TypeError, match="check_rep"):
            _drive(False)
        for n in CACHES:
            getattr(SE, n).clear()
            getattr(SE, n).update(before["caches"][n][1])


def test_shim_restores_after_a_failing_block():
    before = snapshot()
    with pytest.raises(RuntimeError, match="inside"):
        with ref_mesh():
            SE._EXCH_JIT["stray"] = object()
            raise RuntimeError("inside the block")
    assert SE._shard_map is before["_shard_map"]
    assert "stray" not in SE._EXCH_JIT
    assert _state(snapshot()) == _state(before)
