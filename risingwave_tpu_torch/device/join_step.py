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
the hand-written kernels, CPU tensors the plain versions. Nothing here
reads a value back to the host: `needed` and `total` stay device scalars.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from ..kernels import batch_reduce_rows, merge_side, probe  # noqa: F401
from .sorted_state import EMPTY_KEY


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
