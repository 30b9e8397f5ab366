"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
the same seeded numpy inputs go through the JAX package and the port, and
every output leaf must match, dtype included.

Not a test module itself; pytest puts this directory on sys.path for the
test modules that import it."""
import numpy as np
import torch

import jax.numpy as jnp

import risingwave_tpu.device.fused as JF
import risingwave_tpu.device.fuse_planner as JFP
import risingwave_tpu.device.sorted_state as J
import risingwave_tpu_torch.device.sorted_state as P
from risingwave_tpu.expr import expression as JE
from risingwave_tpu_torch.core import dtypes as PT
from risingwave_tpu_torch.device import fused as PF
from risingwave_tpu_torch.device import fuse_planner as PFP
from risingwave_tpu_torch.device.agg_step import DeviceAggSpec
from risingwave_tpu_torch.device.nexmark_gen import GenCfg
from risingwave_tpu_torch.expr import expression as PE
from risingwave_tpu_torch.expr.functions import build_func, cast

# the port's tests run small CPU ops: one intra-op thread keeps them off
# the cores the other test workers share
torch.set_num_threads(1)

EMPTY = int(J.EMPTY_KEY)
S, MN, MX, R = (J.ReduceKind.SUM, J.ReduceKind.MIN, J.ReduceKind.MAX,
                J.ReduceKind.REPLACE)
ALL_KINDS = [(S, np.int64), (MN, np.int64), (MX, np.int64), (R, np.int64),
             (S, np.int32), (R, np.int32), (S, np.float64), (MN, np.float64),
             (MX, np.float64), (R, np.float64), (R, np.bool_)]
Q4_KINDS = [(S, np.int64)] * 4 + [(MX, np.int64), (S, np.int64)]


def leaves(x):
    """Flatten tensors, arrays, tuples, dicts (by sorted key) and deltas
    (cols, sign, mask, pk, pk2) into numpy leaves."""
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for e in x for t in leaves(e)]
    if hasattr(x, "cols") and hasattr(x, "mask"):
        return leaves([x.cols, x.sign, x.mask, x.pk,
                       getattr(x, "pk2", None)])
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    return [np.asarray(x)]


def assert_same(port, ref, float_rtol=0.0):
    """Every leaf equal and of the same dtype; floats within float_rtol."""
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref)
    p, r = leaves(port), leaves(ref)
    assert len(p) == len(r)
    for i, (a, b) in enumerate(zip(p, r)):
        assert a.dtype == b.dtype, (i, a.dtype, b.dtype)
        assert a.shape == b.shape, (i, a.shape, b.shape)
        if float_rtol and np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=float_rtol, atol=0)
        else:
            assert np.array_equal(a, b), i


def payload(rng, n, dt):
    dt = np.dtype(dt)
    if dt == np.float64:
        return rng.normal(0, 1000, n)
    if dt == np.bool_:
        return rng.random(n) < 0.5
    return rng.integers(-1000, 1000, n).astype(dt)


def state_pair(rng, cap, keys, spec):
    """The same state in both packages: `keys` (sorted unique) live."""
    n = len(keys)
    kk = np.full(cap, EMPTY, np.int64)
    kk[:n] = keys
    vals = []
    for j, (k, dt) in enumerate(spec):
        v = np.full(cap, np.asarray(J._neutral(k, np.dtype(dt))), dt)
        live = payload(rng, n, dt)
        if j == 0:
            live = np.abs(live) + 1 if dt != np.bool_ else np.ones(n, bool)
        v[:n] = live
        vals.append(v)
    cnt = np.int32(n)
    js = J.SortedState(jnp.asarray(kk), jnp.asarray(cnt),
                       tuple(jnp.asarray(v) for v in vals))
    ps = P.SortedState(torch.from_numpy(kk), torch.tensor(cnt),
                       tuple(torch.from_numpy(v) for v in vals))
    return js, ps


def port_dtype(d):
    """A reference DataType as the port's (same kind, precision, scale)."""
    return PT.DataType(PT.TypeKind(d.kind.value), d.precision, d.scale)


def port_pack(p):
    """A reference PackPlan as the port's (same offsets, strides, bits)."""
    return PF.PackPlan(tuple(PF.PackField(f.offset, f.stride, f.bits)
                             for f in p.fields))


def port_expr(e):
    """A reference expression (column refs, literals, function calls and
    casts, CASE, IS [NOT] NULL, COALESCE, the planner's timestamp shift)
    as the port's, rebuilt through the port's own resolver."""
    if isinstance(e, JFP._TsShift):
        return PFP._TsShift(port_expr(e.arg), e.delta)
    if isinstance(e, JE.InputRef):
        return PE.InputRef(e.index, port_dtype(e.return_type))
    if isinstance(e, JE.Literal):
        return PE.Literal(e.value, port_dtype(e.return_type))
    if isinstance(e, JE.FunctionCall):
        if e.name == "cast":
            return cast(port_expr(e.args[0]), port_dtype(e.return_type))
        return build_func(e.name, [port_expr(a) for a in e.args])
    if isinstance(e, JE.Case):
        return PE.Case([(port_expr(c), port_expr(r)) for c, r in e.whens],
                       None if e.else_expr is None
                       else port_expr(e.else_expr),
                       port_dtype(e.return_type))
    if isinstance(e, JE.IsNull):
        return PE.IsNull(port_expr(e.arg), e.negated)
    if isinstance(e, JE.Coalesce):
        return PE.Coalesce([port_expr(a) for a in e.args],
                           port_dtype(e.return_type))
    raise TypeError(f"no port of {type(e).__name__}")


def torch_dtype(d):
    """A numpy / jnp dtype as the torch dtype of the same kind."""
    return torch.from_numpy(np.zeros(0, np.dtype(d))).dtype


def port_calls(calls):
    """Reference agg calls as the port's (kind, argument column)."""
    return [PF.AggCall(c.kind, None if c.arg is None else c.arg.index)
            for c in calls]


def port_spec(spec, calls):
    """A reference DeviceAggSpec rebuilt by the port: the same kinds and
    accumulators, retractable when the reference has multisets, min(x)
    and max(x) sharing one (the planner's arg_ids)."""
    arg_ids = [("call", i) if c.arg is None else ("ref", c.arg.index)
               for i, c in enumerate(calls)]
    return DeviceAggSpec.build([c.kind for c in spec.calls],
                               [c.acc_dtype for c in spec.calls],
                               append_only=not spec.minputs,
                               arg_ids=arg_ids)


def port_job(ref_job, cap, device="cpu", mesh=None):
    """The port's job for a reference fused job, node by node from the
    reference's own parameters, telemetry and tiering arms (chains
    flattened: the port re-chains), every capacity starting at `cap`
    (pairs at 4 x cap). A host-fed reference job gets the port's
    HostIngest (its IngestNodes keep the reference's shipped columns) and
    the port's own tier plans, its memory budget too. With `mesh` (the
    port's), the program runs sharded, its exchanges armed by
    `arm_exchange`, and the job has no tier plans."""
    nodes = []
    at = {}                       # reference node index -> port index

    def ins(n):
        return [at[j] for j in n.inputs]
    for i, n in enumerate(ref_job.program.nodes):
        chain = n.chain if isinstance(n, JF.ChainNode) else [n]
        for k, c in enumerate(chain):
            src = ins(n) if k == 0 else [len(nodes) - 1]
            if isinstance(c, JF.SourceNode):
                nodes.append(PF.SourceNode(
                    c.table, GenCfg(*c.gencfg), c.col_names, c.rowid_pos,
                    c.max_events, [port_dtype(d) for d in c.dtypes],
                    device=device))
            elif isinstance(c, JF.IngestNode):
                nodes.append(PF.IngestNode(
                    c.table, GenCfg(*c.gencfg), c.col_names, c.rowid_pos,
                    c.max_events, [port_dtype(d) for d in c.dtypes],
                    device=device))
                if c.live is not None:
                    nodes[-1].set_live(c.live)
            elif isinstance(c, JF.HopNode):
                nodes.append(PF.HopNode(*src, c.time_col, c.hop, c.size,
                                        device=device))
            elif isinstance(c, JF.FilterNode):
                nodes.append(PF.FilterNode(*src, port_expr(c.pred),
                                           device=device))
            elif isinstance(c, JF.MapNode):
                nodes.append(PF.MapNode(*src, [port_expr(e)
                                               for e in c.exprs],
                                        device=device))
            elif isinstance(c, JF.PrecombineNode):
                nodes.append(PF.PrecombineNode(
                    *src, c.group_idx, port_calls(c.calls),
                    port_pack(c.pack), port_spec(c.spec, c.calls),
                    device=device))
            elif isinstance(c, JF.AggNode):
                agg = PF.AggNode(
                    *src, c.group_idx, port_calls(c.calls),
                    port_pack(c.pack), port_spec(c.spec, c.calls), cap,
                    None if c.pk_pack is None else port_pack(c.pk_pack),
                    device=device)
                if c.combined:
                    agg.enable_precombine()
                nodes.append(agg)
            elif isinstance(c, JF.JoinNode):
                nodes.append(PF.JoinNode(
                    *src, c.l_keys, c.r_keys, port_pack(c.pack),
                    None if c.cond is None else port_expr(c.cond), cap,
                    4 * cap, [torch_dtype(d) for d in c.l_val_dtypes],
                    [torch_dtype(d) for d in c.r_val_dtypes], device=device))
            elif isinstance(c, JF.MVKeyedNode):
                nodes.append(PF.MVKeyedNode(*src, nodes[src[0]], cap,
                                            device=device))
            elif isinstance(c, JF.MVPairNode):
                nodes.append(PF.MVPairNode(
                    *src, [torch_dtype(d) for d in c.val_dtypes], cap,
                    device=device))
            else:
                raise AssertionError(f"no port of {type(c).__name__}")
            # the reference planner's telemetry arms, skew's slots first
            if c.skew:
                nodes[-1].enable_skew()
            if c.flow:
                nodes[-1].enable_flow()
            if c.tier:
                nodes[-1].enable_tiering()
        at[i] = len(nodes) - 1
    p = ref_job.pull
    last = at[p.node_idx]
    pull = PF.MVPull(p.kind, last, [port_dtype(d) for d in p.dtypes],
                     list(p.decoders),
                     agg=nodes[last].agg if p.kind == "keyed" else None,
                     out_map=None if p.out_map is None
                     else list(p.out_map))
    if mesh is not None:
        PFP.arm_exchange(nodes, mesh, ref_job.program.epoch_events)
    prog = PF.FusedProgram(nodes, ref_job.program.epoch_events,
                           device=device, mesh=mesh)
    ingest = None
    if ref_job.ingest is not None:
        ingest = PFP.host_ingest(prog, ref_job.ingest.max_events)
    return PF.FusedJob(ref_job.name, prog, pull, ref_job.max_events,
                       device=device, hbm_budget_mb=ref_job.hbm_budget_mb,
                       ingest=ingest, state_tiering=ref_job.state_tiering,
                       tier_plans=None if mesh is not None
                       else PFP.tier_plans(prog, ingest))


def ref_to_port(ref_job, job):
    """Reference node index -> the port job's node index: `port_job`
    flattens the reference's chains (each chain's last member stands for
    it), then the port's program re-chains (`remap`)."""
    at, flat = {}, 0
    for i, n in enumerate(ref_job.program.nodes):
        flat += len(n.chain) if isinstance(n, JF.ChainNode) else 1
        at[i] = job.program.remap[flat - 1]
    return at


def store_dump(tm, at=None):
    """Canonical image of every cold store of a TieringManager (either
    package): per (node, side), per shard, the sorted (key, row) pairs as
    python scalars — agg rows (vals, touch), MV rows (vals), join rows
    sorted [(pk, vals, touch)]. `at` maps the node indices."""
    def scal(v):
        return v.item() if hasattr(v, "item") else v

    def row(r):
        if isinstance(r, tuple) and len(r) == 2 \
                and isinstance(r[0], tuple):        # agg: (vals, touch)
            return (tuple(scal(v) for v in r[0]), scal(r[1]))
        if isinstance(r, list):                     # join: [(pk, vals, t)]
            return sorted((scal(pk), tuple(scal(v) for v in vs), scal(t))
                          for pk, vs, t in r)
        return tuple(scal(v) for v in r)            # mv: vals tuple

    out = {}
    for (node, side), store in tm.stores.items():
        key = (at[node] if at is not None else node, side)
        out[key] = [sorted((scal(k), row(r)) for k, r in d.items())
                    for d in store.rows]
    return out
