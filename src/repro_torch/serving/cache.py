"""``ResultCache`` — the hot-query result cache for the serving fleet (port of
``repro.serving.cache``, copied rather than imported).

Peacock's query traffic is power-law (the paper names caching as a core
feature of the serving stack): a small head of queries repeats constantly
while the long tail is unique. The fleet serves the head from here and lets
the engines spend their batch capacity on the tail.

Design:

* **Keying** — ``(token-id bytes, shape bucket)``. The bucket is part of the
  key because the padded program that ran the query is part of the result
  (same tokens through a different bucket can differ in padding-sensitive
  metadata), and it makes a key self-describing for size accounting.
* **LRU/frequency hybrid (segmented LRU)** — two LRU segments. New entries
  enter *probation*; a hit promotes to *protected*; protected overflow
  demotes back to probation's MRU end; eviction always takes probation's LRU
  end. One-hit wonders (the tail) wash straight through probation without
  ever displacing the protected head — exactly the power-law shape LRU
  alone gets wrong under scanning traffic.
* **Version tags** — every entry records the ``model_version`` it was
  computed under. ``get`` takes the fleet's live version and treats any
  mismatch as a miss *and* drops the entry, so a cached result can never
  cross a hot-swap boundary; :meth:`drop_stale` lets a swap hook reclaim the
  memory eagerly instead of waiting for lazy discovery.
* **Byte budget** — capacity is bytes (``capacity_mb``), not entry count:
  pkd is K floats and K is 10⁵ at paper scale, so count-based caps would be
  meaningless across configurations. Stored arrays are compacted copies
  (never views into a batch buffer) and marked read-only — hits share them.

Concurrency contract (checked by the repo's concurrency analyzer): every
mutable field lives under ``_lock``; all public methods are single short
critical sections with no calls out while holding it, so the cache can be
hit from N engine callback threads plus every submitter concurrently.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Optional, Tuple

import numpy as np

Key = Tuple[bytes, int]

# fixed per-entry overhead charged on top of the payload bytes (dict slots,
# entry object, key tuple) so a flood of tiny entries can't blow the budget
_ENTRY_OVERHEAD = 256


@dataclasses.dataclass
class CacheEntry:
    """One cached inference result (arrays are read-only and shared)."""

    version: int                # model_version the result was computed under
    bucket: int
    pkd: np.ndarray
    feature_ids: np.ndarray
    feature_weights: np.ndarray
    nbytes: int
    hits: int = 0


def _freeze(a) -> np.ndarray:
    """Compact copy, decoupled from any batch buffer, immutable for sharing."""
    out = np.ascontiguousarray(a).copy()
    out.setflags(write=False)
    return out


class ResultCache:
    """Thread-safe segmented-LRU result cache with version invalidation."""

    _GUARDED_BY = {
        "_probation": "_lock", "_protected": "_lock", "_bytes": "_lock",
        "_protected_b": "_lock", "_hits": "_lock", "_misses": "_lock",
        "_stale": "_lock", "_insertions": "_lock", "_evictions": "_lock",
    }

    def __init__(self, capacity_mb: float = 64.0,
                 protected_frac: float = 0.8):
        if capacity_mb <= 0:
            raise ValueError("ResultCache capacity must be > 0 MB")
        if not 0.0 < protected_frac < 1.0:
            raise ValueError("protected_frac must be in (0, 1)")
        self.capacity_bytes = int(capacity_mb * (1 << 20))
        self.protected_bytes = int(self.capacity_bytes * protected_frac)
        self._lock = threading.Lock()
        # key -> CacheEntry; OrderedDict order IS the recency order
        self._probation: collections.OrderedDict = collections.OrderedDict()
        self._protected: collections.OrderedDict = collections.OrderedDict()
        self._bytes = 0            # payload bytes across both segments
        self._protected_b = 0      # payload bytes in the protected segment
        self._hits = 0
        self._misses = 0
        self._stale = 0            # version-mismatch drops
        self._insertions = 0
        self._evictions = 0

    # ------------------------------------------------------------------ get

    def get(self, key: Key, live_version: Optional[int]
            ) -> Optional[CacheEntry]:
        """Hit iff ``key`` is cached AND its entry's version == the fleet's
        live version. A version mismatch drops the entry (it can never
        become valid again — versions are monotonic) and counts as a miss.
        ``live_version=None`` (fleet version unknown, e.g. mid-rollout with
        divergent replicas) is always a miss: correctness over hit rate."""
        with self._lock:
            seg, entry = self._find(key)
            if entry is None:
                self._misses += 1
                return None
            if live_version is None or entry.version != live_version:
                self._remove(seg, key, entry)
                self._stale += 1
                self._misses += 1
                return None
            self._hits += 1
            entry.hits += 1
            if seg is self._probation:
                # frequency signal: a re-referenced entry graduates
                del self._probation[key]
                self._protected[key] = entry
                self._protected_b += entry.nbytes
                self._shrink_protected()
            else:
                self._protected.move_to_end(key)
            return entry

    # ------------------------------------------------------------------ put

    def put(self, key: Key, version: Optional[int], pkd, feature_ids,
            feature_weights, bucket: int) -> bool:
        """Insert one result. ``version=None`` (unknown provenance — e.g. a
        chunk-folded response that straddled a swap) is refused. Returns
        whether the entry was admitted."""
        if version is None:
            return False
        entry = CacheEntry(
            version=int(version), bucket=int(bucket),
            pkd=_freeze(pkd), feature_ids=_freeze(feature_ids),
            feature_weights=_freeze(feature_weights), nbytes=0)
        entry.nbytes = (entry.pkd.nbytes + entry.feature_ids.nbytes
                        + entry.feature_weights.nbytes + len(key[0])
                        + _ENTRY_OVERHEAD)
        if entry.nbytes > self.capacity_bytes:
            return False           # one entry larger than the whole budget
        with self._lock:
            seg, old = self._find(key)
            if old is not None:
                self._remove(seg, key, old)
            self._probation[key] = entry
            self._bytes += entry.nbytes
            self._insertions += 1
            while self._bytes > self.capacity_bytes:
                self._evict_one()
        return True

    # ----------------------------------------------------------- maintenance

    def drop_stale(self, live_version: int) -> int:
        """Eagerly drop every entry whose version != ``live_version`` (the
        hot-swap hook). Lazy ``get``-time checks already guarantee no stale
        entry is ever *served*; this reclaims the bytes immediately."""
        dropped = 0
        with self._lock:
            for seg in (self._probation, self._protected):
                for key in [k for k, e in seg.items()
                            if e.version != live_version]:
                    self._remove(seg, key, seg[key])
                    dropped += 1
            self._stale += dropped
        return dropped

    def clear(self) -> None:
        with self._lock:
            self._probation.clear()
            self._protected.clear()
            self._bytes = 0
            self._protected_b = 0

    def stats(self) -> dict:
        with self._lock:
            lookups = self._hits + self._misses
            return {
                "hits": self._hits, "misses": self._misses,
                "stale_drops": self._stale,
                "insertions": self._insertions,
                "evictions": self._evictions,
                "entries": len(self._probation) + len(self._protected),
                "protected_entries": len(self._protected),
                "bytes": self._bytes,
                "capacity_bytes": self.capacity_bytes,
                "hit_rate": self._hits / lookups if lookups else 0.0,
            }

    # ------------------------------------------------------------- internals

    def _find(self, key: Key):  # requires: _lock
        entry = self._protected.get(key)
        if entry is not None:
            return self._protected, entry
        entry = self._probation.get(key)
        if entry is not None:
            return self._probation, entry
        return None, None

    def _remove(self, seg, key: Key, entry: CacheEntry) -> None:  # requires: _lock
        del seg[key]
        self._bytes -= entry.nbytes
        if seg is self._protected:
            self._protected_b -= entry.nbytes

    def _shrink_protected(self) -> None:  # requires: _lock
        """Demote protected-LRU entries back to probation's MRU end until
        the protected segment fits its share of the budget."""
        while self._protected_b > self.protected_bytes and self._protected:
            key, entry = self._protected.popitem(last=False)
            self._protected_b -= entry.nbytes
            self._probation[key] = entry   # MRU end: demoted, not doomed
        while self._bytes > self.capacity_bytes:
            self._evict_one()

    def _evict_one(self) -> None:  # requires: _lock
        """Evict the least valuable entry: probation LRU end first (the tail
        passes through here), protected LRU end only when probation is dry."""
        if self._probation:
            _, entry = self._probation.popitem(last=False)
        elif self._protected:
            _, entry = self._protected.popitem(last=False)
            self._protected_b -= entry.nbytes
        else:
            return
        self._bytes -= entry.nbytes
        self._evictions += 1
