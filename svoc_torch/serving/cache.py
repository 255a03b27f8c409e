"""The dedup/result cache: a content-keyed LRU of sentiment vectors.

Mirrors :mod:`svoc_tpu.serving.cache` (``cache.py:1-145``), the whole
module.  Serving traffic repeats, and tokenize → pack → forward is a
pure function of the text, so a repeat of ``(claim, text)`` is answered
at submit time from this cache and never takes a queue slot or a packed
segment.

- **Content-keyed**: the key digests the claim id and the text's
  sha256; two claims that submit the same text do not share an entry.
- **Bounded LRU**: ``capacity`` entries, the least recently *used*
  evicted (a hit refreshes it).
- **Observable**: every lookup and eviction counts into
  ``serving_cache{event=hit|miss|evict}``.

Thread-safe: the submit path and the batcher's fill path share it.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from svoc_torch.utils.metrics import MetricsRegistry
from svoc_torch.utils.metrics import registry as _default_registry


def text_digest(text: str) -> str:
    """sha256 of the comment text, computed ONCE a request at admission
    and carried to every consumer (the cache key, the batcher's in-batch
    dedup); the only place serving hashes variable-length content."""
    return hashlib.sha256(text.encode("utf-8", "replace")).hexdigest()


def content_key_from_digest(claim_id: str, digest: str) -> str:
    """The cache key of a text whose :func:`text_digest` is known: a hash
    of the claim and the fixed-size digest, never of the text again."""
    return hashlib.sha256(f"{claim_id}\x00{digest}".encode()).hexdigest()[:24]


def content_key(claim_id: str, text: str) -> str:
    """The cache key of ``(claim, text)``: fixed-size, and never leaks
    comment content into labels or logs."""
    return content_key_from_digest(claim_id, text_digest(text))


class ResultCache:
    """Bounded LRU of ``key → [M] sentiment vector``."""

    def __init__(self, capacity: int = 4096, *, metrics: Optional[MetricsRegistry] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._metrics = metrics or _default_registry
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, np.ndarray]" = OrderedDict()

    def _count(self, event: str) -> None:
        self._metrics.counter("serving_cache", labels={"event": event}).add(1)

    def get(self, key: str) -> Optional[np.ndarray]:
        """The cached vector (a copy), or None; counts one hit or miss."""
        with self._lock:
            vec = self._entries.get(key)
            if vec is not None:
                self._entries.move_to_end(key)
        self._count("hit" if vec is not None else "miss")
        return None if vec is None else vec.copy()

    def put(self, key: str, vector: np.ndarray) -> None:
        """Insert or refresh an entry, evicting the least recently used
        when full."""
        vec = np.asarray(vector, dtype=np.float64).copy()
        evicted = False
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
            elif len(self._entries) >= self.capacity:
                self._entries.popitem(last=False)
                evicted = True
            self._entries[key] = vec
        if evicted:
            self._count("evict")

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def stats(self) -> Dict[str, float]:
        """Size and the registry's cumulative hit, miss and evict counts."""
        counts = {
            event: self._metrics.counter("serving_cache", labels={"event": event}).count
            for event in ("hit", "miss", "evict")
        }
        lookups = counts["hit"] + counts["miss"]
        return {
            "size": len(self),
            "capacity": self.capacity,
            "hits": counts["hit"],
            "misses": counts["miss"],
            "evictions": counts["evict"],
            "hit_rate": round(counts["hit"] / lookups, 6) if lookups else 0.0,
        }
