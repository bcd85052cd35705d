"""View: a named sub-bitmap of a field, owning fragments by shard.

Trimmed copy of pilosa_tpu/models/view.py:34-178: the standard view and an
int field's `bsig_<field>` BSI view. A view that tracks rank keeps one rank
cache per fragment (models/cache.py): loaded from the fragment's `.cache`
sidecar at open, or built from the fragment where there is none, updated
under the fragment's lock by every single-bit write, rebuilt after a bulk
import, and saved on close in the JAX package's format, so either package
reopens a data dir the other wrote with caches that match the bits.
load_frozen_fragment (:180-203) bulk-loads a fragment into the frozen
store and builds its rank cache from the store's arrays.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np

from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.models.cache import (
    CACHE_TYPE_NONE,
    CACHE_TYPE_RANKED,
    RankCache,
    load_cache,
    make_cache,
)
from pilosa_tpu_torch.storage.fragment import Fragment, frozen_row_arrays

VIEW_STANDARD = "standard"
VIEW_BSI_PREFIX = "bsig_"
CACHE_EXT = ".cache"


def view_path(field_path: str, name: str) -> str:
    return os.path.join(field_path, "views", name)


class View:
    def __init__(self, path: str, index: str, field: str, name: str,
                 track_rank: bool = False, cache_size: int = 50000,
                 cache_type: str = CACHE_TYPE_RANKED):
        self.path = path
        self.index = index
        self.field = field
        self.name = name
        self.fragments: dict[int, Fragment] = {}
        self._frag_mu = threading.Lock()
        self.track_rank = track_rank and cache_type != CACHE_TYPE_NONE
        self.cache_size = cache_size
        self.cache_type = cache_type
        self.rank_caches: dict[int, RankCache] = {}

    def open(self) -> "View":
        frag_dir = os.path.join(self.path, "fragments")
        if os.path.isdir(frag_dir):
            for fname in os.listdir(frag_dir):
                # data files are named by shard; sidecars (.cache, .lock,
                # .snapshotting, .corrupt-*) are skipped
                if fname.isdigit():
                    self._open_fragment(int(fname))
        return self

    def flush_caches(self) -> int:
        """Save every rank cache beside its fragment; returns how many."""
        n = 0
        for shard, frag in list(self.fragments.items()):
            cache = self.rank_caches.get(shard)
            if cache is not None:
                cache.save(frag.path + CACHE_EXT)
                n += 1
        return n

    def close(self, save_caches: bool = True) -> None:
        if save_caches:
            self.flush_caches()
        for frag in self.fragments.values():
            frag.close()
        self.fragments.clear()
        self.rank_caches.clear()

    def _open_fragment(self, shard: int, new: bool = False) -> Fragment:
        """Open one shard's fragment; new=True for a shard the view's
        open() did not find on disk."""
        frag = Fragment(os.path.join(self.path, "fragments", str(shard)),
                        self.index, self.field, self.name, shard).open(new)
        self.fragments[shard] = frag
        if self.track_rank:
            cache_path = frag.path + CACHE_EXT
            if frag.fresh:
                self.rank_caches[shard] = make_cache(self.cache_type,
                                                     self.cache_size)
            elif os.path.exists(cache_path):
                self.rank_caches[shard] = load_cache(cache_path)
            else:
                self.rank_caches[shard] = self._build_cache(frag)
        return frag

    def _build_cache(self, frag: Fragment) -> RankCache:
        """A fragment's rank cache from its row ids and counts (one pass
        over the containers each, Fragment.row_counts)."""
        cache = make_cache(self.cache_type, self.cache_size)
        ids = frag.row_ids()
        cache.bulk_add(zip(ids, frag.row_counts(ids).tolist()))
        return cache

    def fragment(self, shard: int) -> Optional[Fragment]:
        return self.fragments.get(shard)

    def create_fragment_if_not_exists(self, shard: int) -> Fragment:
        frag = self.fragments.get(shard)
        if frag is None:
            with self._frag_mu:
                frag = self.fragments.get(shard)
                if frag is None:
                    frag = self._open_fragment(shard, new=True)
        return frag

    def shards(self) -> list[int]:
        return sorted(self.fragments)

    def set_bit(self, row_id: int, column: int) -> bool:
        shard = column // SHARD_WIDTH
        frag = self.create_fragment_if_not_exists(shard)
        changed = frag.set_bit(row_id, column % SHARD_WIDTH)
        if changed:
            self._update_rank(shard, frag, row_id)
        return changed

    def clear_bit(self, row_id: int, column: int) -> bool:
        shard = column // SHARD_WIDTH
        frag = self.fragments.get(shard)
        if frag is None:
            return False
        changed = frag.clear_bit(row_id, column % SHARD_WIDTH)
        if changed:
            self._update_rank(shard, frag, row_id)
        return changed

    def _update_rank(self, shard: int, frag: Fragment, row_id: int) -> None:
        cache = self.rank_caches.get(shard)
        if cache is not None:
            # count and store under the fragment's lock: two racing writers
            # could otherwise store their counts out of order. The count
            # goes through row_cardinality's per-generation cache, which
            # the chooser reads next
            with frag.mu:
                cache.add(row_id, frag.row_cardinality(row_id))

    def refresh_rank_cache(self, shard: int) -> None:
        """Rebuild one shard's rank cache from its fragment (after a bulk
        write)."""
        if not self.track_rank:
            return
        frag = self.fragments.get(shard)
        if frag is not None:
            self.rank_caches[shard] = self._build_cache(frag)

    def load_frozen_fragment(self, shard: int, positions: np.ndarray,
                             presorted: bool = False) -> Fragment:
        """Bulk-load one shard's fragment from shard-local bit positions
        through the frozen store (Fragment.import_frozen), and build its
        rank cache from the store's key layout: per-row counts as arrays,
        and only the top cache_size rows enter the cache, picked by the
        JAX package's np.argpartition, so the same rows enter a full cache
        as there (the reference's add-then-prune, without a Python walk
        over every row)."""
        frag = self.create_fragment_if_not_exists(shard)
        frag.import_frozen(positions, presorted=presorted)
        if self.track_rank:
            cache = make_cache(self.cache_type, self.cache_size)
            uids, sums = frozen_row_arrays(frag.storage.containers)
            k = cache.cache_size
            if uids.size > k:
                top = np.argpartition(-sums, k - 1)[:k]
                uids, sums = uids[top], sums[top]
            cache.bulk_add(zip(uids.tolist(), sums.tolist()))
            self.rank_caches[shard] = cache
        return frag
