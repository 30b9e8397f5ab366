"""Host-ingest staging for fused device jobs (the port's copy of
`risingwave_tpu/device/ingest.py`).

The production source path: a fused job's sources are `IngestNode`s fed
from host columns instead of being generated on the device. For Nexmark
the host columns come from `connectors/nexmark.gen_surrogates`, value-
identical to the device generator, so a host-fed job equals the
device-datagen one row for row.

* **Pinned, reused staging** — two sets of pinned host buffers alternate,
  so refilling one never aliases a copy still in flight from the other.
  Each window's ids and columns are packed into the next set with slice
  copies.
* **Asynchronous copy on a side stream** — the host-to-device copy is
  `tensor.to(device, non_blocking=True)` on a side CUDA stream, followed
  by a CUDA event: one stream and one event for each card the feeds go
  to. Each card's consumer stream waits on its event (`ready`) before the
  `IngestNode` reads the feed, and the feed tensors are recorded on the
  consumer's stream so the allocator keeps them until it is done. A
  prefetch thread stages window N+1 while epoch N is dispatched.
* **Fixed capacities** — every feed column holds the epoch cadence's
  rows with the live count masked in.
* **Per-shard feeds** — under a mesh (`mesh`, n shards) each window is
  cut into the contiguous event blocks of `feed_capacity(epoch_events,
  n)` ids that the device generator gives each shard (one
  `searchsorted` over the window's sorted ids), packed into [n, cap]
  staging rows, and shard s's feed is copied to shard s's device (a
  shard on the CPU gets its own copy of its rows out of the staging set,
  which is refilled two windows on). The staging thread waits on those
  copies only.
* **Replay** — every staged window's host arrays are retained until the
  checkpoint that commits them (`trim`); growth replays re-pack the
  retained windows, and committed history re-derives from the sources'
  deterministic range contract (`IngestSource.rows_for`).

* **Admission** — each source may have an admission bucket
  (`utils/overload.AdmissionBucket`, wired by the `Database`): one token
  per barrier authorizes one window, a throttle `factor` below 1 shrinks
  the window, and a source without a token defers the whole multiplexed
  window (the sources share one event clock, so advancing it past one
  would drop that source's rows). Delay, never loss: a deferred window's
  rows stay at the connector.

On the CPU (the tests) the feeds are fresh tensors built from the packed
arrays: nothing is copied, and nothing is shared with a buffer that is
refilled later.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import cuda_devices
from . import resolve_device


def feed_capacity(epoch_events: int, n_shards: int = 1) -> int:
    """Static per-shard row capacity of one staged feed buffer: the
    ceil-div contiguous event block."""
    return -(-int(epoch_events) // max(1, int(n_shards)))


def shard_cuts(ids: np.ndarray, lo: int, epoch_events: int,
               n_shards: int) -> np.ndarray:
    """Where a window's ascending event ids split into the shards'
    contiguous event blocks (shard s: ids in [lo + s * block, lo + (s + 1)
    * block), block = `feed_capacity`, the device generator's split):
    n + 1 offsets, shard s's rows at [cuts[s], cuts[s + 1])."""
    block = feed_capacity(epoch_events, n_shards)
    bounds = lo + block * np.arange(n_shards + 1, dtype=np.int64)
    return np.searchsorted(ids, bounds)


class IngestSource:
    """One connector feeding one IngestNode, multiplexed on the job's
    global event-id clock. `rows_for` is RANGE-REPLAYABLE: calling it
    again for the same id range yields the same rows."""

    name: str = "?"
    table: str = "?"

    def rows_for(self, lo: int, hi: int
                 ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """(ascending event ids, surrogate columns) for this source's
        rows with event id in [lo, hi)."""
        raise NotImplementedError


class NexmarkIngestSource(IngestSource):
    """Host-side Nexmark feed: numpy surrogate columns, equal to
    `device/nexmark_gen.gen_table` over the same ids. With `live`
    (feed-column pruning), only those column positions are generated and
    shipped."""

    def __init__(self, name: str, table: str, gencfg, col_names,
                 rowid_pos: Optional[int], max_events: Optional[int],
                 live=None):
        self.name = name
        self.table = table
        self.gencfg = gencfg
        self.col_names = list(col_names)
        self.rowid_pos = rowid_pos
        self.max_events = max_events
        self.live = tuple(live) if live is not None else None

    @property
    def n_feed_cols(self) -> int:
        return len(self.live) if self.live is not None \
            else len(self.col_names)

    def rows_for(self, lo: int, hi: int):
        from ..connectors.nexmark import _event_kinds, gen_surrogates
        kind = {"person": 0, "auction": 1, "bid": 2}[self.table]
        if self.max_events is not None:
            hi = min(hi, self.max_events)
        ids = np.arange(lo, max(lo, hi), dtype=np.int64)
        ids = ids[_event_kinds(ids) == kind]
        pos = self.live if self.live is not None \
            else range(len(self.col_names))
        names = [self.col_names[i] for i in pos if i != self.rowid_pos]
        cols = gen_surrogates(self.gencfg, self.table, ids, cols=names)
        return ids, [ids if i == self.rowid_pos else cols[self.col_names[i]]
                     for i in pos]


class StagedWindow:
    """One staged epoch window: the device feeds, the events after which
    they may be read (one a card), the staging cost attribution, and the
    wall clock at which its rows were polled (the freshness anchor of the
    commit that covers them)."""

    __slots__ = ("lo", "events", "feeds", "copied", "pack_s", "h2d_s",
                 "ingest_ts")

    def __init__(self, lo: int, events: int, feeds, copied, pack_s: float,
                 h2d_s: float, ingest_ts: Optional[float] = None):
        self.lo = lo
        self.events = events
        self.feeds = feeds              # {node idx: (count, pk, *cols)}
        self.copied = copied            # {card: CUDA event}, or None
        self.pack_s = pack_s
        self.h2d_s = h2d_s
        self.ingest_ts = ingest_ts      # wall when the rows were polled


class HostIngest:
    """The staging pipeline of one fused job: owns the sources, the
    reused pinned staging buffers, the side stream, the prefetch thread
    and the replay retention. `take(lo)` is the dispatch seam: FusedJob
    asks for the window at its event counter and gets back staged device
    feeds; `ready(window)` orders the consumer's stream after their copy."""

    def __init__(self, sources: Sequence[Tuple[int, IngestSource]],
                 epoch_events: int, max_events: Optional[int] = None,
                 device=None, mesh=None):
        self.device = resolve_device(device)
        self.sources = list(sources)          # [(node idx, source)]
        self.epoch_events = int(epoch_events)
        # under a mesh every feed is per shard: [n, cap] staging rows,
        # shard s's copied to mesh.devices[s]
        self.mesh = mesh
        self.n_shards = mesh.n if mesh is not None else 1
        self.cap = feed_capacity(epoch_events, self.n_shards)
        self.max_events = max_events
        # admission buckets by source name (the Database wires them);
        # a source without one is admitted whole
        self.buckets: Dict[str, Any] = {}
        self.source_rows: Dict[str, int] = {s.name: 0
                                            for _, s in self.sources}
        # retained host windows since the last checkpoint:
        # lo -> (events, [(ids, cols) per source], ingest_ts)
        self._retained: Dict[int, Tuple] = {}
        # dispatched window boundaries since the last trim: the exact
        # re-cut schedule for a replay
        self._history: List[Tuple[int, int]] = []
        self._hist_end = 0
        # the last windows dispatched, (lo, events): the throttle's
        # surface (`_history` trims at checkpoints)
        self.recent_windows: Any = deque(maxlen=64)
        # one side stream for each card the feeds go to
        self._streams = {d: torch.cuda.Stream(d)
                         for d in cuda_devices(self._devices())}
        self._cuda = bool(self._streams)
        # two alternating pinned staging sets, each with the events of
        # the last copy out of it; packing is serialized (a replay's
        # re-pack on the dispatch thread can overlap a prefetch)
        self._bufs = [self._alloc_buffers(), self._alloc_buffers()] \
            if self._cuda else None
        self._buf_ev: List[Optional[Dict]] = [None, None]
        self._flip = 0
        self._pack_lock = threading.Lock()
        self._stage_lock = threading.Lock()
        # prefetch plumbing: one staged window ahead, one worker thread
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._staged: Optional[StagedWindow] = None
        self._inflight_lo: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._error: Optional[BaseException] = None
        self.stat = {"windows": 0, "rows": 0, "events": 0,
                     "pack_s": 0.0, "h2d_s": 0.0, "prefetched": 0,
                     "sync_staged": 0, "deferred": 0, "replayed": 0}

    # ---- buffers --------------------------------------------------------
    def _alloc_buffers(self):
        """One reused staging set: per ingest node, a pinned [n, cap] pk
        buffer and one per shipped column (row s: shard s's block).
        Raises when pinned memory cannot be had: there is no unpinned
        path."""
        out = {}
        shape = (self.n_shards, self.cap)
        for idx, src in self.sources:
            ncols = getattr(src, "n_feed_cols", None)
            if ncols is None:
                raise ValueError(f"ingest source {src.name!r} does not "
                                 "declare its shipped column count")
            out[idx] = (torch.zeros(shape, dtype=torch.int64,
                                    pin_memory=True),
                        [torch.zeros(shape, dtype=torch.int64,
                                     pin_memory=True)
                         for _ in range(ncols)])
        return out

    def source_names(self) -> List[str]:
        return [s.name for _, s in self.sources]

    # ---- admission ------------------------------------------------------
    def epoch_refill(self, mult: int = 1) -> None:
        """Barrier-time token refill: one token authorizes one window per
        source, so a barrier that dispatches `mult` epochs needs `mult`."""
        for b in self.buckets.values():
            b.epoch_refill(mult)

    def _admit(self) -> Tuple[bool, float]:
        """(window admitted?, throttle factor: the smallest of the
        sources'). Every bucket is peeked first: the window cuts only when
        every source has a token, so a deferring source never drains the
        willing sources' budgets on an attempt that moves no rows."""
        bs = [b for _, src in self.sources
              for b in [self.buckets.get(src.name)] if b is not None]
        factor = min([1.0] + [float(getattr(b, "factor", 1.0))
                              for b in bs])
        lacking = [b for b in bs if b.tokens <= 0]
        if lacking:
            for b in lacking:
                b.admit()            # records the offer and the deferral
            return False, factor
        for b in bs:
            b.admit()
        return True, factor

    # ---- staging --------------------------------------------------------
    def _cut(self, lo: int) -> Tuple[int, int]:
        """[lo, lo + events) of the next window."""
        ev = self.epoch_events
        ok, factor = self._admit()
        if not ok:
            return lo, 0
        if factor < 1.0:
            ev = max(1, int(ev * factor))
        if self.max_events is not None:
            ev = min(ev, max(0, self.max_events - lo))
        return lo, ev

    def _pack_feeds(self, lo: int, per_source
                    ) -> Tuple[Dict[int, Any], Any, float, float]:
        """Pack the window at `lo`'s host arrays into staging buffers and
        copy them to the device: ({node idx: feed}, event, pack wall, h2d
        wall). A feed is (count, pk, *cols); under a mesh, a list of one
        per shard, each on its shard's device."""
        with self._pack_lock:
            return self._pack_feeds_locked(lo, per_source)

    def _cuts(self, lo: int, ids: np.ndarray) -> np.ndarray:
        if self.n_shards == 1:
            return np.array([0, len(ids)], np.int64)
        return shard_cuts(ids, lo, self.epoch_events, self.n_shards)

    def _devices(self) -> List[torch.device]:
        return list(self.mesh.devices) if self.mesh is not None \
            else [self.device]

    def _as_feed(self, per_shard: List[Tuple]):
        return per_shard if self.mesh is not None else per_shard[0]

    def _pack_feeds_locked(self, lo: int, per_source):
        t0 = time.perf_counter()
        n = self.n_shards
        if not self._cuda:
            feeds = {}
            for (idx, _s), (ids, cols) in zip(self.sources, per_source):
                cuts = self._cuts(lo, ids)
                shards = []
                for s in range(n):
                    a, b_ = int(cuts[s]), int(cuts[s + 1])
                    k = b_ - a
                    pk = torch.zeros(self.cap, dtype=torch.int64)
                    pk[:k] = torch.from_numpy(
                        np.ascontiguousarray(ids[a:b_]))
                    out = []
                    for c in cols:
                        b = torch.zeros(self.cap, dtype=torch.int64)
                        b[:k] = torch.from_numpy(np.ascontiguousarray(
                            c[a:b_], dtype=np.int64))
                        out.append(b)
                    shards.append((torch.tensor(k, dtype=torch.int64), pk,
                                   *out))
                feeds[idx] = self._as_feed(shards)
            return feeds, None, time.perf_counter() - t0, 0.0
        flip = self._flip
        self._flip ^= 1
        # the set's previous copy must be off the buffers before refill
        for ev in (self._buf_ev[flip] or {}).values():
            ev.synchronize()
        bufs = self._bufs[flip]
        counts = {}
        for (idx, _s), (ids, cols) in zip(self.sources, per_source):
            pk_buf, col_bufs = bufs[idx]
            pkn = pk_buf.numpy()
            coln = [b.numpy() for b in col_bufs]
            cuts = self._cuts(lo, ids)
            for s in range(n):
                a, b_ = int(cuts[s]), int(cuts[s + 1])
                pkn[s, :b_ - a] = ids[a:b_]
                for cb, c in zip(coln, cols):
                    cb[s, :b_ - a] = c[a:b_]
            counts[idx] = np.diff(cuts).tolist()
        t1 = time.perf_counter()
        devs = self._devices()
        per = {idx: [None] * n for idx in bufs}
        copied = {}
        for card, stream in self._streams.items():
            with torch.cuda.stream(stream):
                for idx, (pk_buf, col_bufs) in bufs.items():
                    for s, dev in enumerate(devs):
                        if dev == card:
                            per[idx][s] = (
                                torch.full((), counts[idx][s],
                                           dtype=torch.int64, device=dev),
                                pk_buf[s].to(dev, non_blocking=True),
                                *[b[s].to(dev, non_blocking=True)
                                  for b in col_bufs])
                copied[card] = torch.cuda.Event()
                copied[card].record(stream)
        for idx, (pk_buf, col_bufs) in bufs.items():
            for s, dev in enumerate(devs):
                if dev.type != "cuda":
                    per[idx][s] = (torch.tensor(counts[idx][s],
                                                dtype=torch.int64),
                                   pk_buf[s].clone(),
                                   *[b[s].clone() for b in col_bufs])
        feeds = {idx: self._as_feed(p) for idx, p in per.items()}
        self._buf_ev[flip] = copied
        # wait for this copy's own events (never a device-wide sync): paid
        # on the staging thread, where it hides under dispatch; this wall
        # is the h2d cost
        for ev in copied.values():
            ev.synchronize()
        return feeds, copied, t1 - t0, time.perf_counter() - t1

    def _stage(self, lo: int, prefetched: bool) -> StagedWindow:
        with self._stage_lock:
            return self._stage_locked(lo, prefetched)

    def _stage_locked(self, lo: int, prefetched: bool) -> StagedWindow:
        lo, events = self._cut(lo)
        if events <= 0:
            self.stat["deferred"] += 1
            return StagedWindow(lo, 0, {}, None, 0.0, 0.0)
        ingest_ts = time.time()
        per_source = []
        for _idx, src in self.sources:
            ids, cols = src.rows_for(lo, lo + events)
            per_source.append((ids, cols))
            b = self.buckets.get(src.name)
            if b is not None:
                b.note_admitted(len(ids))
            self.source_rows[src.name] += len(ids)
        feeds, ev, pack_s, h2d_s = self._pack_feeds(lo, per_source)
        self._retained[lo] = (events, per_source, ingest_ts)
        self.stat["windows"] += 1
        self.stat["events"] += events
        self.stat["rows"] += sum(len(i) for i, _ in per_source)
        self.stat["pack_s"] += pack_s
        self.stat["h2d_s"] += h2d_s
        self.stat["prefetched" if prefetched else "sync_staged"] += 1
        return StagedWindow(lo, events, feeds, ev, pack_s, h2d_s,
                            ingest_ts)

    # ---- the dispatch seam ---------------------------------------------
    def take(self, lo: int) -> Tuple[StagedWindow, float, float]:
        """The window at event counter `lo`, plus the dispatch-thread walls
        it cost: (window, pack wall, h2d wall). Kicks the prefetch of the
        next window before returning. A failure on the prefetch thread is
        raised here."""
        t0 = time.perf_counter()
        w: Optional[StagedWindow] = None
        with self._cv:
            while self._inflight_lo == lo:
                self._cv.wait(0.05)
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            if self._staged is not None and self._staged.lo == lo:
                w, self._staged = self._staged, None
        pack_s = time.perf_counter() - t0
        h2d_s = 0.0
        if w is None:
            retained = self._retained.get(lo)
            if retained is not None:
                events, per_source, ingest_ts = retained
                feeds, ev, p, h = self._pack_feeds(lo, per_source)
                self.stat["replayed"] += 1
                w = StagedWindow(lo, events, feeds, ev, p, h, ingest_ts)
            else:
                w = self._stage(lo, prefetched=False)
            pack_s += w.pack_s
            h2d_s += w.h2d_s
        if w.events > 0:
            if lo >= self._hist_end:
                self._history.append((lo, w.events))
                self._hist_end = lo + w.events
                self.recent_windows.append((lo, w.events))
            nxt = lo + w.events
            if self.max_events is None or nxt < self.max_events:
                self._prefetch(nxt)
        return w, pack_s, h2d_s

    def ready(self, w: StagedWindow) -> None:
        """Order each card's current stream after the window's copy to
        it, and keep its feed tensors alive for that stream's use."""
        if not w.copied:
            return
        for card, ev in w.copied.items():
            torch.cuda.current_stream(card).wait_event(ev)
        for feed in w.feeds.values():
            for part in (feed if self.mesh is not None else [feed]):
                for t in part:
                    if t.is_cuda:
                        t.record_stream(torch.cuda.current_stream(t.device))

    def _prefetch(self, lo: int) -> None:
        with self._cv:
            if self._stop or self._inflight_lo is not None \
                    or (self._staged is not None and self._staged.lo == lo) \
                    or lo in self._retained:
                return
            self._inflight_lo = lo
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._prefetch_loop, daemon=True,
                    name="rw-ingest-stage")
                self._thread.start()
            self._cv.notify_all()

    def _prefetch_loop(self) -> None:
        while True:
            with self._cv:
                while self._inflight_lo is None and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                lo = self._inflight_lo
            w, err = None, None
            try:
                w = self._stage(lo, prefetched=True)
            except BaseException as e:       # handed to the dispatch thread
                err = e
            with self._cv:
                if w is not None and w.events > 0:
                    self._staged = w
                if err is not None:
                    self._error = err
                self._inflight_lo = None
                self._cv.notify_all()

    def drop_staged(self) -> None:
        """Before an in-place recovery's rebuild: wait out the prefetch in
        flight and drop the staged window (a later `take` re-serves it
        from retention, re-packed after the rebuild)."""
        with self._cv:
            while self._inflight_lo is not None:
                self._cv.wait(0.05)
            self._staged = None

    def close(self) -> None:
        """Stop the prefetch thread."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(5.0)

    # ---- replay ---------------------------------------------------------
    def replay_range(self, lo: int, hi: int):
        """Yield (window lo, events, staged window) covering [lo, hi): the
        growth-replay path. Retained windows replay verbatim (same
        boundaries, same rows); others re-derive from the sources' range
        contract at the recorded boundaries, or at the uniform cadence."""
        sched = [(w, e) for w, e in self._history if lo <= w < hi]
        covered = sched and sched[0][0] == lo \
            and all(sched[i][0] + sched[i][1] == sched[i + 1][0]
                    for i in range(len(sched) - 1)) \
            and sched[-1][0] + sched[-1][1] >= hi
        if not covered:
            sched = []
            c = lo
            while c < hi:
                ev = min(self.epoch_events, hi - c)
                sched.append((c, ev))
                c += ev
        for wlo, ev in sched:
            ev = min(ev, hi - wlo)
            retained = self._retained.get(wlo)
            if retained is not None and retained[0] == ev:
                per_source = retained[1]
            else:
                per_source = [src.rows_for(wlo, wlo + ev)
                              for _, src in self.sources]
            feeds, copied, p, h = self._pack_feeds(wlo, per_source)
            self.stat["pack_s"] += p
            self.stat["h2d_s"] += h
            yield wlo, ev, StagedWindow(wlo, ev, feeds, copied, p, h)

    def host_window(self, lo: int, events: int):
        """The window's host rows, one (ids, cols) per source: what tier
        promotion recomputes its candidate keys from."""
        retained = self._retained.get(lo)
        if retained is not None and retained[0] == events:
            return retained[1]
        return [src.rows_for(lo, lo + events) for _, src in self.sources]

    def trim(self, committed: int) -> None:
        """Checkpoint trim: windows at or past `committed` stay, older ones
        are committed and dropped."""
        for k in list(self._retained):
            if k < committed:
                del self._retained[k]
        self._history = [(w, e) for w, e in self._history
                         if w + e > committed]
        with self._cv:
            if self._staged is not None and self._staged.lo < committed:
                self._staged = None

    # ---- surfaces -------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        out = dict(self.stat)
        out["sources"] = dict(self.source_rows)
        out["retained_windows"] = len(self._retained)
        out["shards"] = self.n_shards
        out["feed_capacity"] = self.cap
        return out
