"""Host-ingest staging for fused device jobs (the port's copy of
`risingwave_tpu/device/ingest.py`, single device).

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
  by a CUDA event. The consumer's stream waits on that event (`ready`)
  before the `IngestNode` reads the feed, and the feed tensors are
  recorded on the consumer's stream so the allocator keeps them until it
  is done. A prefetch thread stages window N+1 while epoch N is
  dispatched.
* **Fixed capacities** — every feed column holds the epoch cadence's
  rows with the live count masked in.
* **Replay** — every staged window's host arrays are retained until the
  checkpoint that commits them (`trim`); growth replays re-pack the
  retained windows, and committed history re-derives from the sources'
  deterministic range contract (`IngestSource.rows_for`).

On the CPU (the tests) the feeds are fresh tensors built from the packed
arrays: nothing is copied, and nothing is shared with a buffer that is
refilled later. Per-shard bucketing and the admission buckets of the
reference wait for the mesh; `_admit` stays as the seam, admitting every
window while `buckets` is empty, as the reference does by default.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import resolve_device


def feed_capacity(epoch_events: int, n_shards: int = 1) -> int:
    """Static per-shard row capacity of one staged feed buffer: the
    ceil-div contiguous event block."""
    return -(-int(epoch_events) // max(1, int(n_shards)))


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
    """One staged epoch window: the device feeds, the event after which
    they may be read, and the staging cost attribution."""

    __slots__ = ("lo", "events", "feeds", "event", "pack_s", "h2d_s")

    def __init__(self, lo: int, events: int, feeds, event, pack_s: float,
                 h2d_s: float):
        self.lo = lo
        self.events = events
        self.feeds = feeds              # {node idx: (count, pk, *cols)}
        self.event = event              # CUDA event after the copy, or None
        self.pack_s = pack_s
        self.h2d_s = h2d_s


class HostIngest:
    """The staging pipeline of one fused job: owns the sources, the
    reused pinned staging buffers, the side stream, the prefetch thread
    and the replay retention. `take(lo)` is the dispatch seam: FusedJob
    asks for the window at its event counter and gets back staged device
    feeds; `ready(window)` orders the consumer's stream after their copy."""

    def __init__(self, sources: Sequence[Tuple[int, IngestSource]],
                 epoch_events: int, max_events: Optional[int] = None,
                 device=None):
        self.device = resolve_device(device)
        self.sources = list(sources)          # [(node idx, source)]
        self.epoch_events = int(epoch_events)
        self.n_shards = 1
        self.cap = feed_capacity(epoch_events)
        self.max_events = max_events
        # admission buckets by source name (the mesh / SQL slice wires
        # them); empty = every window admitted, the reference's default
        self.buckets: Dict[str, Any] = {}
        self.source_rows: Dict[str, int] = {s.name: 0
                                            for _, s in self.sources}
        # retained host windows since the last checkpoint:
        # lo -> (events, [(ids, cols) per source])
        self._retained: Dict[int, Tuple] = {}
        # dispatched window boundaries since the last trim: the exact
        # re-cut schedule for a replay
        self._history: List[Tuple[int, int]] = []
        self._hist_end = 0
        self._cuda = self.device.type == "cuda"
        # two alternating pinned staging sets, each with the event of the
        # last copy out of it; packing is serialized (a replay's re-pack
        # on the dispatch thread can overlap a prefetch)
        self._bufs = [self._alloc_buffers(), self._alloc_buffers()] \
            if self._cuda else None
        self._buf_ev: List[Optional[Any]] = [None, None]
        self._flip = 0
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
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
        """One reused staging set: per ingest node, a pinned pk buffer and
        one pinned buffer per shipped column. Raises when pinned memory
        cannot be had: there is no unpinned path."""
        out = {}
        for idx, src in self.sources:
            ncols = getattr(src, "n_feed_cols", None)
            if ncols is None:
                raise ValueError(f"ingest source {src.name!r} does not "
                                 "declare its shipped column count")
            out[idx] = (torch.zeros(self.cap, dtype=torch.int64,
                                    pin_memory=True),
                        [torch.zeros(self.cap, dtype=torch.int64,
                                     pin_memory=True)
                         for _ in range(ncols)])
        return out

    # ---- admission ------------------------------------------------------
    def _admit(self) -> Tuple[bool, float]:
        """(window admitted?, throttle factor): the seam of the
        reference's per-source admission buckets; with none wired every
        window is admitted whole."""
        if self.buckets:
            raise NotImplementedError("admission buckets are not ported")
        return True, 1.0

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

    def _pack_feeds(self, per_source) -> Tuple[Dict[int, Tuple], Any,
                                                float, float]:
        """Pack host arrays into staging buffers and copy them to the
        device: ({node idx: (count, pk, *cols)}, event, pack wall, h2d
        wall)."""
        with self._pack_lock:
            return self._pack_feeds_locked(per_source)

    def _pack_feeds_locked(self, per_source):
        t0 = time.perf_counter()
        if not self._cuda:
            feeds = {}
            for (idx, _s), (ids, cols) in zip(self.sources, per_source):
                k = len(ids)
                pk = torch.zeros(self.cap, dtype=torch.int64)
                pk[:k] = torch.from_numpy(np.ascontiguousarray(ids))
                out = []
                for c in cols:
                    b = torch.zeros(self.cap, dtype=torch.int64)
                    b[:k] = torch.from_numpy(
                        np.ascontiguousarray(c, dtype=np.int64))
                    out.append(b)
                feeds[idx] = (torch.tensor(k, dtype=torch.int64), pk, *out)
            return feeds, None, time.perf_counter() - t0, 0.0
        flip = self._flip
        self._flip ^= 1
        # the set's previous copy must be off the buffers before refill
        if self._buf_ev[flip] is not None:
            self._buf_ev[flip].synchronize()
        bufs = self._bufs[flip]
        counts = {}
        for (idx, _s), (ids, cols) in zip(self.sources, per_source):
            pk_buf, col_bufs = bufs[idx]
            k = len(ids)
            pk_buf.numpy()[:k] = ids
            for b, c in zip(col_bufs, cols):
                b.numpy()[:k] = c
            counts[idx] = k
        t1 = time.perf_counter()
        feeds = {}
        with torch.cuda.stream(self._stream):
            for idx, (pk_buf, col_bufs) in bufs.items():
                cnt = torch.full((), counts[idx], dtype=torch.int64,
                                 device=self.device)
                feeds[idx] = (cnt, pk_buf.to(self.device, non_blocking=True),
                              *[b.to(self.device, non_blocking=True)
                                for b in col_bufs])
            ev = torch.cuda.Event()
            ev.record(self._stream)
        self._buf_ev[flip] = ev
        # wait for this copy's own event (never a device-wide sync): paid
        # on the staging thread, where it hides under dispatch; this wall
        # is the h2d cost
        ev.synchronize()
        return feeds, ev, t1 - t0, time.perf_counter() - t1

    def _stage(self, lo: int, prefetched: bool) -> StagedWindow:
        with self._stage_lock:
            return self._stage_locked(lo, prefetched)

    def _stage_locked(self, lo: int, prefetched: bool) -> StagedWindow:
        lo, events = self._cut(lo)
        if events <= 0:
            self.stat["deferred"] += 1
            return StagedWindow(lo, 0, {}, None, 0.0, 0.0)
        per_source = []
        for _idx, src in self.sources:
            ids, cols = src.rows_for(lo, lo + events)
            per_source.append((ids, cols))
            self.source_rows[src.name] += len(ids)
        feeds, ev, pack_s, h2d_s = self._pack_feeds(per_source)
        self._retained[lo] = (events, per_source)
        self.stat["windows"] += 1
        self.stat["events"] += events
        self.stat["rows"] += sum(len(i) for i, _ in per_source)
        self.stat["pack_s"] += pack_s
        self.stat["h2d_s"] += h2d_s
        self.stat["prefetched" if prefetched else "sync_staged"] += 1
        return StagedWindow(lo, events, feeds, ev, pack_s, h2d_s)

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
                events, per_source = retained
                feeds, ev, p, h = self._pack_feeds(per_source)
                self.stat["replayed"] += 1
                w = StagedWindow(lo, events, feeds, ev, p, h)
            else:
                w = self._stage(lo, prefetched=False)
            pack_s += w.pack_s
            h2d_s += w.h2d_s
        if w.events > 0:
            if lo >= self._hist_end:
                self._history.append((lo, w.events))
                self._hist_end = lo + w.events
            nxt = lo + w.events
            if self.max_events is None or nxt < self.max_events:
                self._prefetch(nxt)
        return w, pack_s, h2d_s

    def ready(self, w: StagedWindow) -> None:
        """Order the current stream after the window's copy, and keep its
        feed tensors alive for that stream's use."""
        if w.event is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(w.event)
        for feed in w.feeds.values():
            for t in feed:
                t.record_stream(cur)

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
            feeds, event, p, h = self._pack_feeds(per_source)
            self.stat["pack_s"] += p
            self.stat["h2d_s"] += h
            yield wlo, ev, StagedWindow(wlo, ev, feeds, event, p, h)

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
