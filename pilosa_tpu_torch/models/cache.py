"""TopN row caches: candidate rows per fragment, with their counts.

Copy of pilosa_tpu/models/cache.py:1-243 (pure Python): RankCache (the
default for set fields: threshold-buffered re-rank to the top cache_size,
a versioned memo of the rank-ordered arrays), LRUCache, NopCache, and the
cross-shard Pairs merge. A view keeps one cache per fragment, updated by
every write, and saves it beside the fragment as `<shard>.cache` in the
same JSON, so each package reads the other's.

TopN reads the caches only to pick candidate rows; every count it
returns is recounted exactly (from container metadata, or on the device
when a Src bitmap is given).
"""

from __future__ import annotations

import heapq
import json
import os
from typing import Iterable

import numpy as np

CACHE_TYPE_RANKED = "ranked"
CACHE_TYPE_LRU = "lru"
CACHE_TYPE_NONE = "none"

# re-rank when the buffer grows past cache_size * this factor
THRESHOLD_FACTOR = 1.5


class RankCache:
    """Per-row counts, pruned to the top cache_size rows by count once the
    buffer passes cache_size * THRESHOLD_FACTOR (cache.py:31-138)."""

    cache_type = CACHE_TYPE_RANKED

    def __init__(self, cache_size: int = 50000):
        self.cache_size = cache_size
        self.counts: dict[int, int] = {}
        # (version, ids, counts) of the last top_arrays(); every writer
        # bumps _version after its mutation, so a reader that raced a
        # write tags its snapshot with the old version and the next read
        # recomputes
        self._top_memo = None
        self._version = 0

    def _dirty(self) -> None:
        self._version += 1
        self._top_memo = None

    def add(self, row_id: int, count: int) -> None:
        if count <= 0:
            self.counts.pop(row_id, None)
        else:
            self.counts[row_id] = count
        self._dirty()
        if len(self.counts) > self.cache_size * THRESHOLD_FACTOR:
            self.invalidate()

    def bulk_add(self, pairs: Iterable[tuple[int, int]]) -> None:
        for row_id, count in pairs:
            if count > 0:
                self.counts[row_id] = count
        self._dirty()
        if len(self.counts) > self.cache_size * THRESHOLD_FACTOR:
            self.invalidate()

    def invalidate(self) -> None:
        """Prune to the top cache_size rows by count."""
        if len(self.counts) > self.cache_size:
            top = heapq.nlargest(self.cache_size, self.counts.items(),
                                 key=lambda kv: kv[1])
            self.counts = dict(top)
        self._dirty()

    def top_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(ids, counts) int64 arrays in Pairs order (count desc, id asc),
        memoized until the next write."""
        memo = self._top_memo
        if memo is not None and memo[0] == self._version:
            return memo[1], memo[2]
        version = self._version  # read before snapshotting counts
        if not self.counts:
            ids = cnts = np.empty(0, np.int64)
        else:
            arr = np.array(list(self.counts.items()), dtype=np.int64)
            arr = arr[np.argsort(arr[:, 0])]  # id asc, then stable by count
            o = np.argsort(-arr[:, 1], kind="stable")
            ids, cnts = arr[o, 0], arr[o, 1]
        self._top_memo = (version, ids, cnts)
        return ids, cnts

    def top(self, n: int | None = None) -> list[tuple[int, int]]:
        """(row_id, count) pairs, count desc then id asc."""
        ids, cnts = self.top_arrays()
        if n is not None:
            ids, cnts = ids[:n], cnts[:n]
        return list(zip(ids.tolist(), cnts.tolist()))

    def __len__(self) -> int:
        return len(self.counts)

    # -- the fragment's .cache sidecar (JSON, as the JAX package writes it)

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump({"type": self.cache_type, "cacheSize": self.cache_size,
                       "counts": {str(k): v for k, v in self.counts.items()}},
                      f)
        os.replace(tmp, path)


class LRUCache(RankCache):
    """Evicts by last touch instead of rank (cache.py:141-167)."""

    cache_type = CACHE_TYPE_LRU

    def add(self, row_id: int, count: int) -> None:
        if count <= 0:
            self.counts.pop(row_id, None)
            self._dirty()
            return
        # dicts keep insertion order: delete + insert marks recency
        self.counts.pop(row_id, None)
        self.counts[row_id] = count
        while len(self.counts) > self.cache_size:
            self.counts.pop(next(iter(self.counts)))
        self._dirty()

    def bulk_add(self, pairs: Iterable[tuple[int, int]]) -> None:
        for row_id, count in pairs:
            self.add(row_id, count)

    def invalidate(self) -> None:
        while len(self.counts) > self.cache_size:
            self.counts.pop(next(iter(self.counts)))
        self._dirty()


class NopCache(RankCache):
    """Tracks nothing: TopN over such a field has no candidates
    (cache.py:170-183)."""

    cache_type = CACHE_TYPE_NONE

    def add(self, row_id: int, count: int) -> None:
        pass

    def bulk_add(self, pairs: Iterable[tuple[int, int]]) -> None:
        pass

    def save(self, path: str) -> None:
        pass


_CACHE_TYPES = {
    CACHE_TYPE_RANKED: RankCache,
    CACHE_TYPE_LRU: LRUCache,
    CACHE_TYPE_NONE: NopCache,
}
CACHE_TYPES = tuple(_CACHE_TYPES)


def make_cache(cache_type: str, cache_size: int = 50000) -> RankCache:
    cls = _CACHE_TYPES.get(cache_type)
    if cls is None:
        raise ValueError(f"invalid cache type: {cache_type}")
    return cls(cache_size)


def load_cache(path: str) -> RankCache:
    """Load a .cache sidecar, dispatching on its recorded type."""
    with open(path) as f:
        data = json.load(f)
    c = make_cache(data.get("type", CACHE_TYPE_RANKED),
                   data.get("cacheSize", 50000))
    c.counts = {int(k): v for k, v in data.get("counts", {}).items()}
    return c


def merge_pair_arrays(arrays) -> tuple[np.ndarray, np.ndarray]:
    """Sum (ids, counts) int64 array pairs by id, then order by count desc,
    id asc: the cross-shard TopN reduce (cache.py:210-229)."""
    chunks = [a for a in arrays if a[0].size]
    if not chunks:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    ids = np.concatenate([a[0] for a in chunks])
    cnts = np.concatenate([a[1] for a in chunks])
    u, inv = np.unique(ids, return_inverse=True)
    out = np.zeros(u.size, dtype=np.int64)
    np.add.at(out, inv, cnts)
    # u ascends, so a stable sort on -count keeps id order among ties
    order = np.argsort(-out, kind="stable")
    return u[order], out[order]


def merge_pairs(lists: Iterable[list[tuple[int, int]]]) -> list[tuple[int, int]]:
    """merge_pair_arrays over lists of (row_id, count) pairs."""
    arrays = []
    for pairs in lists:
        if len(pairs):
            arr = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
            arrays.append((arr[:, 0], arr[:, 1]))
    ids, counts = merge_pair_arrays(arrays)
    return list(zip(ids.tolist(), counts.tolist()))
