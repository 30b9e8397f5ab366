"""Filesystem source connector: a directory of newline-delimited files
(the port's own copy of the JAX package's `connectors/filesystem.py`).

Reference shape: `src/connector/src/source/filesystem/` (posix_fs / s3 /
opendal sources list files as splits and tail them by byte offset). Here
the "object store" is a local directory; every file matching the pattern
is one split, the offset is a byte position, and new files appearing
between polls become new splits (late split discovery, the
`SplitEnumerator` re-list contract)."""
from __future__ import annotations

import fnmatch
import os
from typing import Any, List, Optional, Tuple

from .base import SourceSplit, SplitEnumerator, SplitReader


class DirEnumerator(SplitEnumerator):
    """One split per file under `path` matching `pattern` (sorted name
    order, so split ids are stable across restarts)."""

    def __init__(self, path: str, pattern: str = "*"):
        self.path = path
        self.pattern = pattern

    def list_splits(self) -> List[SourceSplit]:
        try:
            names = sorted(os.listdir(self.path))
        except FileNotFoundError:
            return []
        return [SourceSplit(n, os.path.join(self.path, n))
                for n in names
                if fnmatch.fnmatch(n, self.pattern)
                and os.path.isfile(os.path.join(self.path, n))]


class LineFileReader(SplitReader):
    """Reads complete newline-terminated records from a byte offset.

    A trailing partial line (a writer mid-append) is NOT consumed — the
    offset stays at the last complete record, so a crash/retry never
    splits a record (at-least-once becomes exactly-once through the
    offset-in-state protocol)."""

    def read(self, split: SourceSplit, offset: Any, max_records: int
             ) -> Tuple[List[bytes], Any]:
        pos = int(offset or 0)
        try:
            f = open(split.meta, "rb")
        except FileNotFoundError:
            return [], pos
        with f:
            size = os.fstat(f.fileno()).st_size
            if size < pos:
                # rotated/truncated shorter than the committed offset:
                # silently re-reading would duplicate, skipping would lose
                # data — fail loudly (reference treats file shrink the
                # same way: splits are append-only by contract)
                raise IOError(
                    f"source file {split.meta!r} shrank below the "
                    f"committed offset ({size} < {pos}); file splits "
                    "must be append-only")
            f.seek(pos)
            out: List[bytes] = []
            while len(out) < max_records:
                line = f.readline()
                if not line or not line.endswith(b"\n"):
                    break               # EOF or partial trailing record
                pos += len(line)
                s = line.rstrip(b"\r\n")   # only the framing, not content
                if s:
                    out.append(s)
        return out, pos
