"""The Xor filter with 8-bit fingerprints that the cold tier's negative
caches use (`device/tiering.py` `ColdStore`).

A copy of `Xor8` from `risingwave_tpu/state/hummock.py`: the same keyed
blake2b hash, the same remix and slot positions, the same peeling and
seed retries. Keeping it bit for bit the same matters beyond
correctness: a filter's false positives depend on the hash, and the
tier's `filter_probes` / `filter_hits` / `filter_fallbacks` counters are
held equal to the reference's.

`build` and `may_contain_many` give the reference's answers but compute
the three slot positions of all keys at once with numpy (the remix is
64-bit wrapping arithmetic, as numpy's uint64 multiply is), leaving only
the keyed hash and the order-dependent peel as per-key Python: the
reference's per-key Python remix dominated the cold tier's host time.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

_C0, _C1, _C2 = (np.uint64(0x9E3779B97F4A7C15), np.uint64(0xC2B2AE3D27D4EB4F),
                 np.uint64(0x165667B19E3779F9))


def _remix_np(x: np.ndarray) -> np.ndarray:
    """`Xor8._remix` over a uint64 array (wrapping multiplies)."""
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _positions_np(h: np.ndarray, seg: int):
    """`Xor8._positions` (layout 1) of a uint64 array of hashes:
    (fingerprints, p0, p1, p2) as int64 arrays."""
    s = np.uint64(seg)
    fp = ((h ^ (h >> np.uint64(32))) & np.uint64(0xFF)).astype(np.int64)
    return (fp, (_remix_np(h ^ _C0) % s).astype(np.int64),
            (_remix_np(h ^ _C1) % s).astype(np.int64) + seg,
            (_remix_np(h ^ _C2) % s).astype(np.int64) + 2 * seg)


class Xor8:
    """Xor filter with 8-bit fingerprints (`src/storage/src/hummock/
    sstable/xor_filter.rs`; Graf & Lemire construction): ~0.39% false
    positives at 9.84 bits/key. A run-level filter lets point reads skip
    runs that cannot contain the key — without it every negative lookup
    pays a block read per run."""

    __slots__ = ("seed", "seg", "fp", "ver")

    def __init__(self, seed: int, seg: int, fp: bytes, ver: int = 1):
        self.seed = seed
        self.seg = seg
        self.fp = fp
        self.ver = ver

    @staticmethod
    def _h(key: bytes, seed: int) -> int:
        import hashlib
        return int.from_bytes(
            hashlib.blake2b(key, digest_size=8,
                            salt=seed.to_bytes(8, "little")).digest(),
            "little")

    _M64 = 0xFFFFFFFFFFFFFFFF

    @classmethod
    def _remix(cls, x: int) -> int:
        """splitmix64 finalizer: full-avalanche 64-bit mix."""
        m = cls._M64
        x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & m
        x = (x ^ (x >> 27)) * 0x94D049BB133111EB & m
        return x ^ (x >> 31)

    @classmethod
    def _positions(cls, h: int, seg: int, ver: int = 1):
        fp = (h ^ (h >> 32)) & 0xFF
        if ver == 0:
            # legacy layout: 20-bit hash slices. Slots >= 2**20 are
            # unreachable, so construction reliably fails once
            # seg > 2**20 (~2.5M keys). Kept only to read old run files.
            p0 = (h & 0xFFFFF) % seg
            p1 = seg + ((h >> 20) & 0xFFFFF) % seg
            p2 = 2 * seg + ((h >> 40) & 0xFFFFF) % seg
            return fp, p0, p1, p2
        # full-width layout: three INDEPENDENTLY remixed 64-bit values
        # (peeling runs at the sharp m = 1.23n threshold, so the three
        # positions must be independent — bit rotations of one hash
        # correlate and reliably fail to peel; the legacy disjoint
        # slices were independent but couldn't address large segments)
        p0 = cls._remix(h ^ 0x9E3779B97F4A7C15) % seg
        p1 = seg + cls._remix(h ^ 0xC2B2AE3D27D4EB4F) % seg
        p2 = 2 * seg + cls._remix(h ^ 0x165667B19E3779F9) % seg
        return fp, p0, p1, p2

    @classmethod
    def build(cls, keys: List[bytes]) -> Optional["Xor8"]:
        """May return None (construction failure) — every caller must
        degrade gracefully (run readers treat the run as unfiltered,
        tiering's negative caches fall back to always-probe). Duplicate
        keys would make the 3-regular peeling unconditionally fail (a
        duplicated key's three slots never reach count 1), burning all
        seed retries for nothing — dedupe first; set semantics are what
        a membership filter means anyway."""
        if len(keys) != len(set(keys)):
            keys = list(dict.fromkeys(keys))
        n = len(keys)
        if n == 0:
            return cls(0, 1, bytes(3))
        seg = (int(1.23 * n) + 32 + 2) // 3
        for seed in range(8):            # retries are vanishingly rare
            hs = [cls._h(k, seed) for k in keys]
            m = 3 * seg
            hu = np.array(hs, dtype=np.uint64)
            f_, p0_, p1_, p2_ = _positions_np(hu, seg)
            allp = np.concatenate([p0_, p1_, p2_])
            count = np.bincount(allp, minlength=m).tolist()
            hx = np.zeros(m, np.uint64)
            np.bitwise_xor.at(hx, allp, np.concatenate([hu, hu, hu]))
            hxor = hx.tolist()
            # each key's slots and fingerprint by its hash: the peel only
            # ever reads a slot's hash while one key is left there
            pos = dict(zip(hs, zip(f_.tolist(), p0_.tolist(), p1_.tolist(),
                                   p2_.tolist())))
            stack = []
            queue = [p for p in range(m) if count[p] == 1]
            while queue:
                p = queue.pop()
                if count[p] != 1:
                    continue
                h = hxor[p]
                stack.append((p, h))
                _, p0, p1, p2 = pos[h]
                for q in (p0, p1, p2):
                    count[q] -= 1
                    hxor[q] ^= h
                    if count[q] == 1:
                        queue.append(q)
            if len(stack) == n:
                fp = bytearray(m)
                for p, h in reversed(stack):
                    f, p0, p1, p2 = pos[h]
                    fp[p] = f ^ fp[p0] ^ fp[p1] ^ fp[p2] ^ fp[p]
                return cls(seed, seg, bytes(fp))
        return None                      # give up: reader treats as absent

    def may_contain_many(self, keys: Sequence[bytes]) -> np.ndarray:
        """`may_contain` of each key, as a bool array."""
        if not len(keys):
            return np.zeros(0, bool)
        h = np.array([self._h(k, self.seed) for k in keys], dtype=np.uint64)
        if self.ver != 1:
            return np.array([self.may_contain(k) for k in keys], bool)
        f, p0, p1, p2 = _positions_np(h, self.seg)
        fp = np.frombuffer(self.fp, dtype=np.uint8).astype(np.int64)
        return (fp[p0] ^ fp[p1] ^ fp[p2]) == f

    def may_contain(self, key: bytes) -> bool:
        h = self._h(key, self.seed)
        f, p0, p1, p2 = self._positions(h, self.seg, self.ver)
        return (self.fp[p0] ^ self.fp[p1] ^ self.fp[p2]) == f
