"""Epochs — the global logical clock advanced by barriers.

Mirrors `src/common/src/util/epoch.rs:31-127`: an epoch is a 64-bit value,
`physical_time_ms << 16`, with the low 16 bits as a sequence number so multiple
barriers can share one millisecond. `EpochPair{curr, prev}` travels in every
barrier; state commits are tagged with `curr`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

EPOCH_PHYSICAL_SHIFT = 16
INVALID_EPOCH = 0


def epoch_from_physical(ms: int, seq: int = 0) -> int:
    return (ms << EPOCH_PHYSICAL_SHIFT) | (seq & 0xFFFF)


def physical_time_ms(epoch: int) -> int:
    return epoch >> EPOCH_PHYSICAL_SHIFT


def now_epoch(prev: int = 0) -> int:
    """A fresh epoch strictly greater than prev."""
    e = epoch_from_physical(int(time.time() * 1000))
    return e if e > prev else prev + 1


@dataclass(frozen=True)
class EpochPair:
    """`EpochPair` (`epoch.rs`): curr = the epoch being opened by this barrier,
    prev = the epoch being sealed."""
    curr: int
    prev: int

    @classmethod
    def new_initial(cls, curr: int) -> "EpochPair":
        return cls(curr=curr, prev=INVALID_EPOCH)

    def next(self, curr: int) -> "EpochPair":
        assert curr > self.curr
        return EpochPair(curr=curr, prev=self.curr)

    def next_seq(self) -> "EpochPair":
        return EpochPair(curr=self.curr + 1, prev=self.curr)
