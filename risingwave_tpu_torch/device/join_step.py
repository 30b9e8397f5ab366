"""Streaming hash-join epoch step (inner equi-join) on PyTorch.

Port of `risingwave_tpu/device/join_step.py`. Each side's state is a
SORTED MULTIMAP — rows ordered by (join_key, pk) in fixed-capacity device
tensors — so a probe is a binary-search range lookup and the per-epoch
maintenance is the sort-merge pattern of the agg state. The incremental
join per epoch:

    out  =  dA >< B_old   +   A_new >< dB          (A_new = A_old + dA)

Ragged match output becomes static-shape by a prefix-sum expansion: pair
slot t maps back to its probe row by a search over the running match
counts. The three cores (`batch_reduce_rows`, `merge_side`, `probe`) are
dispatch functions in `risingwave_tpu_torch.kernels`: CUDA tensors run
the hand-written kernels, CPU tensors the plain versions. Nothing in the
step reads a value back to the host: `needed` and `total` stay device
scalars. `DeviceHashJoin`, the per-operator executor's engine, buffers an
epoch's rows on the host, runs the step at the barrier and grows on
overflow.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..kernels import batch_reduce_rows, merge_side, probe  # noqa: F401
from . import resolve_device
from .agg_step import _acc_cast, _bucket, _h2d, _to_host, torch_dtype
from .capacity import predict_capacity
from .sorted_state import EMPTY_KEY, sanitize_keys


class JoinSide(NamedTuple):
    """Sorted-by-(jk, pk) multimap; empty slots hold EMPTY_KEY twice."""
    jk: torch.Tensor                    # int64 (C,) join key
    pk: torch.Tensor                    # int64 (C,) row identity
    count: torch.Tensor                 # int32 scalar
    vals: Tuple[torch.Tensor, ...]      # payload columns (C,)


def make_side(capacity: int, val_dtypes: Sequence[torch.dtype],
              device) -> JoinSide:
    def empty():
        return torch.full((capacity,), EMPTY_KEY, dtype=torch.int64,
                          device=device)
    return JoinSide(empty(), empty(),
                    torch.zeros((), dtype=torch.int32, device=device),
                    tuple(torch.zeros(capacity, dtype=d, device=device)
                          for d in val_dtypes))


def grow_side(side: JoinSide, new_capacity: int) -> JoinSide:
    """Re-pad to a larger capacity (EMPTY_KEY / zero tail)."""
    pad = new_capacity - side.jk.shape[0]
    if pad < 0:
        raise ValueError(f"grow_side: {new_capacity} < capacity "
                         f"{side.jk.shape[0]}")
    dev = side.jk.device

    def grow(a, fill):
        return torch.cat([a, torch.full((pad,), fill, dtype=a.dtype,
                                        device=dev)])
    return JoinSide(grow(side.jk, EMPTY_KEY), grow(side.pk, EMPTY_KEY),
                    side.count, tuple(grow(v, 0) for v in side.vals))


def join_core(a: JoinSide, b: JoinSide,
              a_jk, a_pk, a_sign, a_mask, a_vals,
              b_jk, b_pk, b_sign, b_mask, b_vals, m: int):
    """One epoch of both sides' rows -> (new sides, the two pair change
    sets, capacity needs). Pair change set: each emitted pair carries the
    producing delta's sign, both sides' payloads and both sides' pks."""
    dajk, dapk, dasign, davals = batch_reduce_rows(a_jk, a_pk, a_sign,
                                                   a_mask, a_vals)
    dbjk, dbpk, dbsign, dbvals = batch_reduce_rows(b_jk, b_pk, b_sign,
                                                   b_mask, b_vals)
    # dA >< B_old
    r1, s1, m1, need1 = probe(b, dajk, dasign != 0, m)
    r1 = r1.long()
    out1 = {
        "sign": torch.where(m1, dasign[r1], 0),
        "jk": dajk[r1],
        "a_pk": dapk[r1], "b_pk": b.pk[s1],
        "a_vals": tuple(v[r1] for v in davals),
        "b_vals": tuple(v[s1] for v in b.vals),
        "mask": m1,
    }
    new_a, needed_a = merge_side(a, dajk, dapk, dasign, davals)
    new_b, needed_b = merge_side(b, dbjk, dbpk, dbsign, dbvals)
    # A_new >< dB
    r2, s2, m2, need2 = probe(new_a, dbjk, dbsign != 0, m)
    r2 = r2.long()
    out2 = {
        "sign": torch.where(m2, dbsign[r2], 0),
        "jk": dbjk[r2],
        "a_pk": new_a.pk[s2], "b_pk": dbpk[r2],
        "a_vals": tuple(v[s2] for v in new_a.vals),
        "b_vals": tuple(v[r2] for v in dbvals),
        "mask": m2,
    }
    needed = {"a": needed_a, "b": needed_b,
              "pairs": torch.maximum(need1, need2)}
    return new_a, new_b, out1, out2, needed


def local_join_step(a: JoinSide, b: JoinSide,
                    a_jk, a_pk, a_sign, a_mask, a_vals,
                    b_jk, b_pk, b_sign, b_mask, b_vals, m: int):
    """join_core plus cross-delta pair netting: when both sides change in
    one epoch, dA >< B_old can emit the very pair that A_new >< dB
    retracts, so the two pair sets are netted by (left pk, right pk)
    before emission.

    Returns (new_a, new_b, njk, npk, nsign, nvals, needed): unique pairs
    keyed by (left pk, right pk), payload columns last-write-wins, plus
    the capacity needs of join_core."""
    new_a, new_b, o1, o2, needed = join_core(
        a, b, a_jk, a_pk, a_sign, a_mask, a_vals,
        b_jk, b_pk, b_sign, b_mask, b_vals, m)

    def cat(k):
        return torch.cat([o1[k], o2[k]])

    def catv(k, i):
        return torch.cat([o1[k][i], o2[k][i]])
    sign = cat("sign")
    mask = cat("mask") & (sign != 0)
    pvals = [catv("a_vals", i) for i in range(len(a_vals))] \
        + [catv("b_vals", i) for i in range(len(b_vals))]
    njk, npk, nsign, nvals = batch_reduce_rows(
        cat("a_pk"), cat("b_pk"), sign, mask, pvals)
    return new_a, new_b, njk, npk, nsign, nvals, needed


def join_epoch_step(a: JoinSide, b: JoinSide,
                    a_jk, a_pk, a_sign, a_mask, a_vals,
                    b_jk, b_pk, b_sign, b_mask, b_vals, m: int):
    """The epoch step (`join_core`), eagerly."""
    return join_core(a, b, a_jk, a_pk, a_sign, a_mask, a_vals,
                     b_jk, b_pk, b_sign, b_mask, b_vals, m)


class DeviceHashJoin:
    """Host wrapper: epoch buffering + state/pair-capacity growth."""

    def __init__(self, a_dtypes: Sequence, b_dtypes: Sequence,
                 capacity: int = 1024, pair_capacity: int = 4096,
                 device=None):
        self.device = resolve_device(device)
        self.a = make_side(capacity, [torch_dtype(d) for d in a_dtypes],
                           self.device)
        self.b = make_side(capacity, [torch_dtype(d) for d in b_dtypes],
                           self.device)
        self.m = pair_capacity
        self._buf = {"a": [], "b": []}
        # growth replays made (an epoch re-run on grown state or pairs)
        self.growth_replays = 0

    def live_side(self, side: str) -> Tuple[np.ndarray, np.ndarray]:
        """Host pull of a side's live (jk, pk) rows (state cleaning)."""
        s = self.a if side == "a" else self.b
        n = int(s.count)
        return _to_host((s.jk[:n], s.pk[:n]))

    def load_side(self, side: str, jk, pk, vals=()) -> None:
        """Recovery: install a side's (jk, pk, payload...) rows as current
        state (sorted by (jk, pk))."""
        jk = sanitize_keys(np.asarray(jk, np.int64))
        pk = sanitize_keys(np.asarray(pk, np.int64))
        order = np.lexsort((pk, jk))
        n = len(jk)
        cur = self.a if side == "a" else self.b
        cap = _bucket(max(n, cur.jk.shape[0]))
        gjk = np.full(cap, EMPTY_KEY, np.int64)
        gpk = np.full(cap, EMPTY_KEY, np.int64)
        gjk[:n], gpk[:n] = jk[order], pk[order]
        gvals = []
        for v0, v in zip(cur.vals, vals):
            t = torch.zeros(cap, dtype=v0.dtype)
            t[:n] = torch.from_numpy(np.asarray(v)[order])
            gvals.append(t.to(self.device))
        dev = self.device
        new = JoinSide(_h2d(gjk, dev), _h2d(gpk, dev),
                       _h2d(np.int32(n), dev), tuple(gvals))
        if side == "a":
            self.a = new
        else:
            self.b = new

    def push_rows(self, side: str, jk, pk, signs, vals) -> None:
        self._buf[side].append((sanitize_keys(np.asarray(jk, np.int64)),
                                sanitize_keys(np.asarray(pk, np.int64)),
                                np.asarray(signs, np.int32),
                                [np.asarray(v) for v in vals]))

    @staticmethod
    def _concat(buf, nvals):
        if not buf:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.int32), [np.zeros(0, np.int64)] * nvals)
        jk = np.concatenate([x[0] for x in buf])
        pk = np.concatenate([x[1] for x in buf])
        sg = np.concatenate([x[2] for x in buf])
        vals = [np.concatenate([x[3][i] for x in buf])
                for i in range(nvals)]
        return jk, pk, sg, vals

    def flush_epoch(self):
        """Run the epoch step; returns the two pair change sets (dA ><
        B_old, A_new >< dB) as dicts of host numpy arrays. The capacity
        needs come back in one transfer, and the change sets in one
        synchronised pull."""
        na, nb = len(self.a.vals), len(self.b.vals)
        ajk, apk, asg, avals = self._concat(self._buf["a"], na)
        bjk, bpk, bsg, bvals = self._concat(self._buf["b"], nb)
        self._buf = {"a": [], "b": []}

        def pad(arrs, bsz):
            jk, pk, sg, vals = arrs
            p = bsz - len(jk)
            dev = self.device
            return (_h2d(np.pad(jk, (0, p)), dev),
                    _h2d(np.pad(pk, (0, p)), dev),
                    _h2d(np.pad(sg, (0, p)), dev),
                    _h2d(np.concatenate(
                        [np.ones(len(jk), bool), np.zeros(p, bool)]), dev),
                    tuple(_h2d(np.pad(_acc_cast(v), (0, p)), dev)
                          for v in vals))
        bsz = _bucket(max(len(ajk), len(bjk), 1), lo=64)
        A = pad((ajk, apk, asg, avals), bsz)
        B = pad((bjk, bpk, bsg, bvals), bsz)
        while True:
            new_a, new_b, o1, o2, needed = join_epoch_step(
                self.a, self.b, *A, *B, m=self.m)
            # one transfer for the three capacity needs
            na_, nb_, np_ = torch.stack(
                [needed[k].to(torch.int64) for k in ("a", "b", "pairs")]
            ).cpu().tolist()
            if np_ > self.m:
                # predictive (device/capacity.py): jump past the
                # intermediate pow2 buckets, each an epoch replayed
                self.m = predict_capacity(np_, self.m)
                self.growth_replays += 1
                continue
            grown = False
            if na_ > self.a.jk.shape[0]:
                self.a = grow_side(self.a,
                                   predict_capacity(na_,
                                                    self.a.jk.shape[0]))
                grown = True
            if nb_ > self.b.jk.shape[0]:
                self.b = grow_side(self.b,
                                   predict_capacity(nb_,
                                                    self.b.jk.shape[0]))
                grown = True
            if grown:
                self.growth_replays += 1
                continue
            self.a, self.b = new_a, new_b
            return _to_host((o1, o2))
