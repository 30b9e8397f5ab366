"""Read-serving tier: host-side epoch-versioned MV snapshot caches (the
port's own copy of the JAX package's `serving/`).

The write path (fused epoch programs on the card) publishes state once
per checkpoint; this package makes the READ path scale independently of
it — see `read_cache.MVReadCache`.
"""
from .read_cache import MVReadCache

__all__ = ["MVReadCache"]
