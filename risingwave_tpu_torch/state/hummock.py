"""SpillStateStore — durable LSM state store with a real disk read path
(the port's own copy of the JAX package's `state/hummock.py`).

Re-design of Hummock (`src/storage/src/hummock/`) scoped to what the
streaming runtime needs from it:

* writes buffer in memtables and become durable ONLY at barrier commit
  (`seal_current_epoch` -> uploader `sync(epoch)` analog,
  `hummock/event_handler/uploader/mod.rs:994`): each commit flushes the
  epoch's per-table delta as one sorted run file, then atomically advances
  the manifest (`HummockManager::commit_epoch` analog,
  `src/meta/src/hummock/manager/commit_epoch.rs:71`);
* run files are block-structured SSTs (`hummock/sstable/{builder,block}.rs`
  analog): sorted (key, row|None) entries split into compressed blocks with
  a sparse first-key index in the footer, so point reads touch one block
  and range reads stream blocks — state larger than RAM stays on disk;
* reads merge the uncommitted epoch deltas (shared-buffer analog) over the
  committed runs newest-first; a bounded LRU block cache
  (`block_cache.rs` / foyer analog) is the only in-memory copy of
  committed data;
* recovery = read the manifest; no data is loaded until referenced
  (uncommitted epochs vanish, exactly the checkpoint contract);
* compaction streams a k-way merge of a table's runs into one base
  snapshot once the run count passes a threshold (`hummock/compactor/`
  analog, trivially tiered); tombstones drop out at the base.

File format: blocks of zlib-compressed pickled (key, row|None) lists, then
a pickled footer ([(first_key, offset, length)], count, filter), then an
8-byte big-endian index offset; the filter is the run's Xor8
(`state/xor8.py`) as its (seed, seg, fp, ver) tuple, a 3-tuple being the
legacy ver-0 layout. The format, the MANIFEST and the run names are the
JAX package's, so each package reads the other's directory for rows of
plain values. The column-aware value encoding (`core/encoding.py`) remains
the parity-tested wire format; spill files are a private on-disk format the
same way the reference's SST blocks are.
"""
from __future__ import annotations

import bisect
import heapq
import json
import os
import pickle
import struct
import zlib
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from ..utils.failpoint import FailpointError, declare, failpoint
from .store import StateStore
from .xor8 import Xor8

declare("state.spill_write",
        "crash before a spill run file becomes durable (finish())")
declare("state.manifest_commit",
        "crash between writing the tmp manifest and the atomic rename")

MANIFEST = "MANIFEST.json"
MANIFEST_HISTORY = "MANIFEST.history.json"
HISTORY_VERSIONS = 8       # retained manifest versions (time travel)
COMPACT_THRESHOLD = 8
MAX_OPEN_READERS = 128  # cap on simultaneously open run fds (LRU-evicted)
BLOCK_ROWS = 256           # entries per block (block.rs targets ~64KB)
DEFAULT_CACHE_BLOCKS = 4096  # LRU capacity (~1M cached entries)

_MISS = object()           # sentinel: key not present in this source


class BlockCache:
    """Bounded LRU over decompressed blocks, keyed (run_name, block_no)."""

    def __init__(self, capacity: int = DEFAULT_CACHE_BLOCKS):
        self.capacity = capacity
        self._blocks: "OrderedDict[Tuple[str, int], List]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: Tuple[str, int]):
        blk = self._blocks.get(key)
        if blk is not None:
            self._blocks.move_to_end(key)
            self.hits += 1
        else:
            self.misses += 1
        return blk

    def put(self, key: Tuple[str, int], block: List) -> None:
        self._blocks[key] = block
        self._blocks.move_to_end(key)
        while len(self._blocks) > self.capacity:
            self._blocks.popitem(last=False)

    def drop_run(self, name: str) -> None:
        for k in [k for k in self._blocks if k[0] == name]:
            del self._blocks[k]

    def __len__(self) -> int:
        return len(self._blocks)


class _RunWriter:
    """Streaming block writer: add() in key order, finish() atomically."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path + ".tmp", "wb")
        self._index: List[Tuple[bytes, int, int]] = []
        self._buf: List[Tuple[bytes, Optional[Tuple]]] = []
        self._off = 0
        self.count = 0
        self._keys: List[bytes] = []     # for the run-level xor filter

    def add(self, key: bytes, row: Optional[Tuple]) -> None:
        self._buf.append((key, row))
        self._keys.append(key)           # tombstones included: a filter
        self.count += 1                  # miss must mean "not in this run"
        if len(self._buf) >= BLOCK_ROWS:
            self._flush_block()

    def _flush_block(self) -> None:
        if not self._buf:
            return
        blob = zlib.compress(pickle.dumps(self._buf, protocol=4), 1)
        self._index.append((self._buf[0][0], self._off, len(blob)))
        self._f.write(blob)
        self._off += len(blob)
        self._buf = []

    def finish(self) -> None:
        if failpoint("state.spill_write"):
            self.abort()
            raise FailpointError("state.spill_write: crashed before the "
                                 "run file became durable")
        self._flush_block()
        xf = Xor8.build(self._keys)
        filt = (xf.seed, xf.seg, xf.fp, xf.ver) if xf is not None else None
        idx_blob = pickle.dumps((self._index, self.count, filt),
                                protocol=4)
        self._f.write(idx_blob)
        self._f.write(struct.pack(">Q", self._off))
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        os.replace(self.path + ".tmp", self.path)

    def abort(self) -> None:
        self._f.close()
        try:
            os.remove(self.path + ".tmp")
        except FileNotFoundError:
            pass


class RunReader:
    """Block-indexed reads from one run file. The index (sparse: one key per
    block) loads on open; blocks load on demand through the cache."""

    def __init__(self, name: str, path: str, cache: BlockCache):
        self.name = name
        self.path = path
        self.cache = cache
        # one long-lived handle per run: cold scans touch every block, and
        # an open/close pair per block would dominate the read path
        self._f = open(path, "rb")
        self._f.seek(-8, os.SEEK_END)
        end = self._f.tell()
        (idx_off,) = struct.unpack(">Q", self._f.read(8))
        self._f.seek(idx_off)
        footer = pickle.loads(self._f.read(end - idx_off))
        if len(footer) == 3:             # filter-bearing format
            self.index, self.count, filt = footer
            # 3-tuple filters predate the full-width position layout
            # (ver 0); 4-tuples carry their version explicitly
            self.filter = None if filt is None else \
                Xor8(*filt) if len(filt) == 4 else Xor8(*filt, ver=0)
        else:                            # pre-filter files stay readable
            self.index, self.count = footer
            self.filter = None
        self._first_keys = [e[0] for e in self.index]

    def close(self) -> None:
        self._f.close()

    def _block(self, i: int) -> List[Tuple[bytes, Optional[Tuple]]]:
        blk = self.cache.get((self.name, i))
        if blk is None:
            _, off, length = self.index[i]
            if self._f.closed:
                # LRU fd eviction (or store.close()) can race a still-live
                # lazy range scan; reopen rather than crash mid-iteration.
                self._f = open(self.path, "rb")
            self._f.seek(off)
            blk = pickle.loads(zlib.decompress(self._f.read(length)))
            self.cache.put((self.name, i), blk)
        return blk

    def get(self, key: bytes):
        """Value, None (tombstone), or _MISS."""
        if self.filter is not None and not self.filter.may_contain(key):
            from ..utils.metrics import REGISTRY
            REGISTRY.counter("state_filter_negative_skips",
                             "point reads skipped by run xor filters"
                             ).inc()
            return _MISS
        i = bisect.bisect_right(self._first_keys, key) - 1
        if i < 0:
            return _MISS
        blk = self._block(i)
        j = bisect.bisect_left(blk, (key,))
        if j < len(blk) and blk[j][0] == key:
            return blk[j][1]
        return _MISS

    def iter_range(self, start: Optional[bytes], end: Optional[bytes]
                   ) -> Iterator[Tuple[bytes, Optional[Tuple]]]:
        if not self.index:
            return
        i = 0
        if start is not None:
            i = max(0, bisect.bisect_right(self._first_keys, start) - 1)
        while i < len(self.index):
            if end is not None and self._first_keys[i] >= end:
                return
            for k, v in self._block(i):
                if start is not None and k < start:
                    continue
                if end is not None and k >= end:
                    return
                yield k, v
            i += 1


def _merge(sources: List[Iterator[Tuple[bytes, Optional[Tuple]]]]
           ) -> Iterator[Tuple[bytes, Optional[Tuple]]]:
    """K-way merge, earlier source wins on key ties (newest first) —
    `hummock/iterator/merge_inner.rs` analog. Yields tombstones."""
    heap: List[Tuple[bytes, int]] = []
    cur: List[Optional[Tuple[Optional[Tuple], Iterator]]] = []
    for pri, it in enumerate(sources):
        nxt = next(it, None)
        cur.append(None)
        if nxt is not None:
            heap.append((nxt[0], pri))
            cur[pri] = (nxt[1], it)
    heapq.heapify(heap)
    last: Optional[bytes] = None
    while heap:
        k, pri = heapq.heappop(heap)
        v, it = cur[pri]
        nxt = next(it, None)
        if nxt is not None:
            cur[pri] = (nxt[1], it)
            heapq.heappush(heap, (nxt[0], pri))
        if k == last:
            continue  # shadowed by a newer source
        last = k
        yield k, v


class SpillStateStore(StateStore):
    """Durable store: epoch-delta memtables over block-indexed spill runs."""

    # dirs this PROCESS owns (multi-open within a process is the normal
    # recovery-test pattern; cross-process sharing is what must fail fast)
    _process_locks: Dict[str, Any] = {}

    def __init__(self, directory: str,
                 cache_blocks: int = DEFAULT_CACHE_BLOCKS):
        self.dir = directory
        os.makedirs(os.path.join(directory, "runs"), exist_ok=True)
        self._acquire_dir_lock(directory)
        # keyed by (epoch, table) so committing epoch N persists exactly the
        # deltas ingested for epochs <= N — data already ingested for N+1
        # must NOT become durable under N's checkpoint ('uncommitted epochs
        # vanish' recovery contract)
        self._deltas: Dict[Tuple[int, int],
                           Dict[bytes, Optional[Tuple]]] = {}
        self._manifest: Dict[str, Any] = {"committed_epoch": 0, "tables": {},
                                          "counts": {}}
        self._file_seq = 0
        self.committed_epoch = 0
        self.cache = BlockCache(cache_blocks)
        self._readers: Dict[str, RunReader] = {}
        self._history: List[Dict[str, Any]] = []
        self._recover()
        self._sweep()

    @classmethod
    def _acquire_dir_lock(cls, directory: str) -> None:
        """One OWNING PROCESS per data directory: an advisory flock held
        for the process lifetime. A second process (another server, or
        the control CLI against a live dir) fails fast instead of
        clobbering the manifest under the owner
        (`HummockManager` single-writer invariant)."""
        key = os.path.realpath(directory)
        if key in cls._process_locks:
            return
        import fcntl
        fd = os.open(os.path.join(directory, ".lock"),
                     os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            raise RuntimeError(
                f"data directory {directory!r} is locked by another "
                "process (a live Database owns it)")
        cls._process_locks[key] = fd

    @classmethod
    def release_dir_lock(cls, directory: str) -> None:
        """Give up this process's ownership of `directory` once every
        store on it is closed and dropped, so another process (risectl,
        a restarted server) may open it. Opening it here again takes the
        lock again."""
        import fcntl
        fd = cls._process_locks.pop(os.path.realpath(directory), None)
        if fd is not None:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    # ---- write path -----------------------------------------------------
    def ingest_batch(self, table_id, batch, epoch):
        d = self._deltas.setdefault((epoch, table_id), {})
        for key, row in batch:
            d[key] = row

    def commit_epoch(self, epoch):
        garbage: List[str] = []
        ready = sorted(k for k in self._deltas if k[0] <= epoch)
        for ep_tid in ready:
            delta = self._deltas.pop(ep_tid)
            if not delta:
                continue
            tid = ep_tid[1]
            # the sequence number makes names unique even when two commits
            # share an epoch (e.g. back-to-back DDL) — a same-named run
            # would silently overwrite its predecessor
            self._file_seq += 1
            name = f"t{tid}_e{epoch}_{self._file_seq}.run"
            w = _RunWriter(self._run_path(name))
            for key, row in sorted(delta.items()):
                w.add(key, row)
            w.finish()
            runs = self._manifest["tables"].setdefault(str(tid), [])
            runs.append(name)
            # approximate live-count bookkeeping (exact after compaction):
            # inserts may overwrite and deletes may miss, so clamp at 0
            cnt = self._manifest["counts"].get(str(tid), 0)
            cnt += sum(1 if row is not None else -1
                       for row in delta.values())
            self._manifest["counts"][str(tid)] = max(0, cnt)
            if len(runs) > COMPACT_THRESHOLD:
                garbage += self._compact(tid, epoch)
        self._manifest["committed_epoch"] = max(
            self._manifest["committed_epoch"], epoch)
        self._write_manifest()
        # old runs are deleted only after the manifest that no longer
        # references them is durable (crash between compact and manifest
        # write must leave the previous version fully readable); files a
        # RETAINED version still references are spared until it ages out
        self._gc(garbage)
        self.committed_epoch = max(self.committed_epoch, epoch)

    # ---- read path ------------------------------------------------------
    def _delta_sources(self, table_id: int) -> List[Dict]:
        """This table's epoch deltas, newest epoch first (shared buffer)."""
        eps = sorted((e for e, t in self._deltas if t == table_id),
                     reverse=True)
        return [self._deltas[(e, table_id)] for e in eps]

    def _open_readers(self, names: Sequence[str]) -> List[RunReader]:
        """Open readers for `names` (given oldest-first, returned newest
        first), LRU-capping open fds while sparing THIS call's whole
        live set — evicting (closing) a reader a still-running k-way
        merge holds would yank its fd mid-iteration."""
        out = []
        live = set()
        for name in reversed(names):
            r = self._readers.pop(name, None)   # re-insert = mark recent
            if r is None:
                r = RunReader(name, self._run_path(name), self.cache)
            self._readers[name] = r
            out.append(r)
            live.add(name)
        while len(self._readers) > MAX_OPEN_READERS:
            old = next(iter(self._readers))
            if old in live:                     # everything live this call
                break
            self._readers.pop(old).close()
        return out

    def _run_readers(self, table_id: int) -> List[RunReader]:
        """This table's runs, newest first. Open handles are LRU-capped:
        each reader keeps one fd for its lifetime, and a long-lived process
        with many live runs would otherwise creep toward the ulimit."""
        return self._open_readers(
            self._manifest["tables"].get(str(table_id), []))

    def close(self) -> None:
        """Release all cached run fds (safe to keep using the store —
        readers reopen on demand)."""
        for r in self._readers.values():
            r.close()
        self._readers.clear()

    def __del__(self):  # best-effort fd hygiene for test-heavy processes
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def get(self, table_id: int, key: bytes) -> Optional[Tuple]:
        for d in self._delta_sources(table_id):
            if key in d:
                return d[key]
        for r in self._run_readers(table_id):
            v = r.get(key)
            if v is not _MISS:
                return v
        return None

    def iter_range(self, table_id: int, start: Optional[bytes],
                   end: Optional[bytes]
                   ) -> Iterator[Tuple[bytes, Tuple]]:
        sources: List[Iterator] = []
        for d in self._delta_sources(table_id):
            items = sorted((k, v) for k, v in d.items()
                           if (start is None or k >= start)
                           and (end is None or k < end))
            sources.append(iter(items))
        for r in self._run_readers(table_id):
            sources.append(r.iter_range(start, end))
        for k, v in _merge(sources):
            if v is not None:
                yield k, v

    def table_len(self, table_id: int) -> int:
        # approximate between compactions (see commit_epoch); uncommitted
        # deltas counted the same way
        n = self._manifest["counts"].get(str(table_id), 0)
        for d in self._delta_sources(table_id):
            n += sum(1 if v is not None else -1 for v in d.values())
        return max(0, n)

    # ---- files ----------------------------------------------------------
    def _run_path(self, name: str) -> str:
        return os.path.join(self.dir, "runs", name)

    def _write_manifest(self) -> None:
        tmp = os.path.join(self.dir, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(self._manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if failpoint("state.manifest_commit"):
            raise FailpointError(
                "state.manifest_commit: crashed between the tmp manifest "
                "and the atomic rename (previous version must stay live)")
        os.replace(tmp, os.path.join(self.dir, MANIFEST))
        # retained version history (time travel, `src/meta/src/hummock/
        # manager/time_travel.rs` analog): the last HISTORY_VERSIONS
        # manifests stay readable, and _gc spares any run they reference
        self._history.append(json.loads(json.dumps(self._manifest)))
        aged = self._history[:-HISTORY_VERSIONS]
        del self._history[:-HISTORY_VERSIONS]
        htmp = os.path.join(self.dir, MANIFEST_HISTORY + ".tmp")
        with open(htmp, "w") as f:
            json.dump(self._history, f)
            f.flush()
            os.fsync(f.fileno())     # a torn history file would silently
        os.replace(htmp, os.path.join(self.dir, MANIFEST_HISTORY))
        # age-out: runs referenced ONLY by versions that just left the
        # window die now (incremental — no directory scan per commit)
        dropped = set()
        for m in aged:
            for runs in m["tables"].values():
                dropped.update(runs)
        dropped -= self._retained()
        if dropped:
            self._gc(sorted(dropped), spare_retained=False)

    def _retained(self) -> set:
        """Runs referenced by the CURRENT manifest or any retained
        version. The current manifest is included explicitly: a freshly
        restored backup (or a pre-history directory) has an empty
        history, and sweeping by history alone would delete the live
        data itself."""
        out = set()
        for runs in self._manifest["tables"].values():
            out.update(runs)
        for m in self._history:
            for runs in m["tables"].values():
                out.update(runs)
        return out

    # ---- backup / time travel ------------------------------------------
    def backup(self, dest_dir: str) -> int:
        """Copy the current manifest + every referenced run into
        `dest_dir` (hardlinks when the filesystem allows). The backup is
        a self-contained data directory: opening it restores
        (`src/meta/src/backup_restore/` analog). Returns files copied."""
        import shutil
        os.makedirs(os.path.join(dest_dir, "runs"), exist_ok=True)
        n = 0
        for runs in self._manifest["tables"].values():
            for name in runs:
                src = self._run_path(name)
                dst = os.path.join(dest_dir, "runs", name)
                if not os.path.exists(dst):
                    try:
                        os.link(src, dst)
                    except OSError:
                        shutil.copy2(src, dst)
                    n += 1
        with open(os.path.join(dest_dir, MANIFEST), "w") as f:
            json.dump(self._manifest, f)
        # the device-policy marker rides along so Database opens the
        # backup under the policy that shaped its state-table layouts
        marker = os.path.join(self.dir, "device_mode.json")
        if os.path.exists(marker):
            shutil.copy2(marker, os.path.join(dest_dir,
                                              "device_mode.json"))
        return n

    def history_versions(self) -> List[Dict]:
        """Retained manifest versions, oldest first (read-only copies)."""
        return [dict(m) for m in self._history]

    def manifest_at(self, epoch: int) -> Optional[Dict]:
        """Newest RETAINED manifest with committed_epoch <= epoch."""
        best = None
        for m in self._history:          # oldest -> newest: latest wins,
            if m["committed_epoch"] <= epoch:   # ties included (two DDL
                if best is None or m["committed_epoch"] \
                        >= best["committed_epoch"]:   # commits may share
                    best = m                          # an epoch)
        return best

    def read_at(self, epoch: int, table_id: int
                ) -> Iterator[Tuple[bytes, Tuple]]:
        """Time-travel range read: the table's live rows as of the newest
        retained version <= epoch. Raises when the version fell out of
        the retention window."""
        m = self.manifest_at(epoch)
        if m is None:
            raise ValueError(
                f"no retained version at or before epoch {epoch} "
                f"(retention: last {HISTORY_VERSIONS} manifests)")
        # the version's FULL reader set opens with live-set protection
        # (_open_readers): the per-name _reader() helper would let the
        # LRU cap evict (close) an earlier reader of THIS call while
        # the k-way merge still iterates it
        readers = self._open_readers(m["tables"].get(str(table_id), []))
        for k, v in _merge([r.iter_range(None, None) for r in readers]):
            if v is not None:
                yield k, v

    # ---- compaction -----------------------------------------------------
    def _compact(self, table_id: int, epoch: int) -> List[str]:
        """Stream-merge all committed runs into one base snapshot;
        tombstones drop out. Streaming keeps peak memory at one block per
        input run + one output block, so tables far larger than RAM
        compact fine. Returns the now-unreferenced run files (deleted by
        the caller AFTER the new manifest is durable)."""
        names = self._manifest["tables"][str(table_id)]
        readers = self._run_readers(table_id)  # newest first = merge pri
        self._file_seq += 1
        base = f"t{table_id}_e{epoch}_{self._file_seq}.base"
        w = _RunWriter(self._run_path(base))
        for k, v in _merge([r.iter_range(None, None) for r in readers]):
            if v is not None:
                w.add(k, v)
        w.finish()
        self._manifest["tables"][str(table_id)] = [base]
        self._manifest["counts"][str(table_id)] = w.count  # exact again
        return list(names)

    def compact_all(self) -> Dict[str, int]:
        """Operator-triggered full compaction (risectl `hummock
        trigger-full-gc` / manual compaction analog): every table with
        more than one run merges to a single base. Returns
        {table_id: runs_merged}."""
        merged: Dict[str, int] = {}
        garbage: List[str] = []
        epoch = self._manifest["committed_epoch"]
        for tid_s, runs in list(self._manifest["tables"].items()):
            if len(runs) <= 1:
                continue
            merged[tid_s] = len(runs)
            garbage += self._compact(int(tid_s), epoch)
        if merged:
            self._write_manifest()
            self._gc(garbage)
        return merged

    def _sweep(self) -> None:
        """Startup GC: delete run files referenced by NO retained
        version (crash windows can leak files the incremental age-out
        in _write_manifest would have deleted)."""
        keep = self._retained()
        runs_dir = os.path.join(self.dir, "runs")
        try:
            on_disk = os.listdir(runs_dir)
        except FileNotFoundError:
            return
        dead = [f for f in on_disk
                if (f.endswith(".run") or f.endswith(".base"))
                and f not in keep]
        if dead:
            self._gc(dead, spare_retained=False)

    def _gc(self, names: Sequence[str],
            spare_retained: bool = True) -> None:
        if spare_retained:
            keep = self._retained()
            names = [n for n in names if n not in keep]
        for n in names:
            r = self._readers.pop(n, None)
            if r is not None:
                r.close()
            self.cache.drop_run(n)
            try:
                os.remove(self._run_path(n))
            except FileNotFoundError:
                pass

    # ---- recovery -------------------------------------------------------
    def _recover(self) -> None:
        """Read the manifest; data stays on disk until referenced."""
        hpath = os.path.join(self.dir, MANIFEST_HISTORY)
        if os.path.exists(hpath):
            try:
                with open(hpath) as f:
                    self._history = json.load(f)
            except (OSError, ValueError):
                self._history = []
        path = os.path.join(self.dir, MANIFEST)
        if not os.path.exists(path):
            return
        with open(path) as f:
            self._manifest = json.load(f)
        self._manifest.setdefault("counts", {})
        self.committed_epoch = self._manifest["committed_epoch"]
        for runs in self._manifest["tables"].values():
            for name in runs:
                parts = name.rsplit(".", 1)[0].split("_")
                if len(parts) >= 3:
                    self._file_seq = max(self._file_seq, int(parts[2]))
