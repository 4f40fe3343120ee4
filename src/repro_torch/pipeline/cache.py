"""Content-addressed plan cache.

Planning is addressed by *content*, not identity: the cache key starts
with :func:`graph_digest` — a blake2b over the canonicalized edge set —
so two structurally identical graphs hit the same entry no matter how
they were constructed, and any edge edit changes the digest and misses.
The rest of the key is the full planning configuration supplied by the
planner entry points: kind, grid, chunk, relabel options, mask/stat flags,
``rebalance_trials``, and the stage knobs ``compact`` /
``autotune`` / ``aug_keys`` — every stage that changes the packed
arrays or the staged schedule is a key component, so (for example) a
compacted σ-re-packed artifact can never be served to a
``compact=False`` caller.  Derived *results* (the chosen σ, the
autotuned shapes) are deliberately **not** keyed: they are pure
functions of the keyed inputs.

One :class:`PlanCache` instance stores every pipeline product —
relabel results and plan artifacts — under
namespaced keys, so ``clear()`` is a single switch and the hit/miss
stats describe the whole planning stack.  The default process-wide
cache (:func:`default_cache`) is what ``count_triangles`` uses when no
cache is passed; serving processes can hold their own instance.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Hashable, Optional

import numpy as np

from ..core.graph import Graph

__all__ = ["PlanCache", "graph_digest", "default_cache", "set_default_cache"]


def graph_digest(graph: Graph) -> str:
    """Content digest of a graph: blake2b over (n, sorted edge keys).

    Canonicalizes via the packed key ``lo * n + hi`` (edges are already
    stored as ``(min, max)``) sorted ascending, so edge *order* never
    affects the digest — only the edge *set* and vertex count do.
    """
    n = np.int64(graph.n)
    key = graph.edges[:, 0] * n + graph.edges[:, 1]
    # Graph.from_edges emits keys already ascending (np.unique); only
    # hand-built edge lists pay the sort
    if key.size and not np.all(key[1:] > key[:-1]):
        key = np.sort(key)
    h = hashlib.blake2b(digest_size=16)
    h.update(int(n).to_bytes(8, "little"))
    h.update(np.ascontiguousarray(key).tobytes())
    return h.hexdigest()


class PlanCache:
    """Thread-safe LRU over pipeline products.

    ``maxsize=0`` disables caching (every ``get`` misses, ``put`` is a
    no-op) — useful for benchmarking the cold path.

    Eviction is entry-count-based, not byte-based.  Cached artifacts pin
    whatever they have memoized — staged *device* tensors — so LRU eviction calls ``value.release()`` (or the
    supplied ``on_evict`` hook) *outside the lock*: the pinned device
    memory is dropped immediately even while serving threads still hold
    Python references to the artifact; they simply re-stage on next use.
    Size ``maxsize`` to the working set of distinct (graph, config)
    pairs the process actually serves; for one-shot batch jobs prefer
    ``maxsize=0``.
    """

    def __init__(self, maxsize: int = 8, on_evict=None):
        self.maxsize = int(maxsize)
        self._on_evict = on_evict
        self._entries: OrderedDict[Hashable, Any] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _release(self, value: Any) -> None:
        if self._on_evict is not None:
            self._on_evict(value)
            return
        release = getattr(value, "release", None)
        if callable(release):
            release()

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return self._entries[key]
            self.misses += 1
            return None

    def put(self, key: Hashable, value: Any) -> None:
        if self.maxsize <= 0:
            return
        evicted = []
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                _, old = self._entries.popitem(last=False)
                self.evictions += 1
                evicted.append(old)
        for old in evicted:
            if old is not value:  # self-eviction of a fresh put keeps it usable
                self._release(old)

    def memo(self, key: Hashable, build) -> Any:
        """Get-or-build: return the cached value, building (outside the
        lock) and storing it on a miss.  NOTE: concurrent misses may both
        build; the last ``put`` wins — acceptable for pipeline products,
        which are pure functions of their key."""
        hit = self.get(key)
        if hit is not None:
            return hit
        out = build()
        self.put(key, out)
        return out

    def clear(self) -> None:
        with self._lock:
            dropped = list(self._entries.values())
            self._entries.clear()
        for old in dropped:
            self._release(old)

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        return dict(
            size=len(self._entries),
            maxsize=self.maxsize,
            hits=self.hits,
            misses=self.misses,
            evictions=self.evictions,
        )


_DEFAULT = PlanCache()


def default_cache() -> PlanCache:
    """The process-wide cache used when callers pass ``cache=None``."""
    return _DEFAULT


def set_default_cache(cache: PlanCache) -> PlanCache:
    """Swap the process-wide cache (returns the previous one)."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, cache
    return prev
