"""Field: a typed sub-matrix of an index.

Trimmed copy of pilosa_tpu/models/field.py: `set` fields on the standard
view, and `int` fields whose values live bit-sliced in the `bsig_<field>`
view (rows 0..depth-1 the place values of value - min, row depth the
not-null row; :95-107, :245-277, :340-383). Options and the
available-shards bitmap persist in the reference's files (`.meta` JSON,
`.available.shards` roaring), so either package opens a field the other
wrote. Keys, time quantums and the mutex, bool and time types open (so a
data dir the JAX package wrote loads whole) but cannot be created or
queried here: they are not ported yet.

A set field's standard view tracks rank (a rank cache per fragment, the
TopN candidates) unless its cache type is "none"; `bsig_` views never do
(:109-111, :152-166). A bulk import rebuilds each touched shard's cache
after its apply (:309).
"""

from __future__ import annotations

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass
from typing import Optional

import numpy as np

from pilosa_tpu_torch.constants import DEFAULT_CACHE_SIZE, SHARD_WIDTH
from pilosa_tpu_torch.models.cache import CACHE_TYPE_NONE, CACHE_TYPES
from pilosa_tpu_torch.models.view import (
    VIEW_BSI_PREFIX,
    VIEW_STANDARD,
    View,
    view_path,
)
from pilosa_tpu_torch.storage.roaring import Bitmap

# threads applying one bulk import's per-shard groups
IMPORT_WORKERS = min(8, os.cpu_count() or 1)


class NotPortedError(ValueError):
    """A feature of the JAX package this port does not serve yet."""


@dataclass
class FieldOptions:
    # the same fields, names and defaults as the reference's FieldOptions:
    # `.meta` is json.dump(asdict(options)) in both packages
    type: str = "set"
    cache_type: str = "ranked"
    cache_size: int = DEFAULT_CACHE_SIZE
    min: int = 0
    max: int = 0
    time_quantum: str = ""
    keys: bool = False

    def validate(self) -> None:
        if self.type not in ("set", "int"):
            raise NotPortedError(f"field type {self.type!r} not ported yet")
        if self.type == "int" and self.max < self.min:
            raise ValueError("int field max must be >= min")
        if self.keys:
            raise NotPortedError("keyed fields not ported yet")
        if self.time_quantum:
            raise NotPortedError("time quantums not ported yet")
        if self.cache_type not in CACHE_TYPES:
            raise ValueError(f"invalid cache type: {self.cache_type}")


class Field:
    def __init__(self, path: str, index: str, name: str,
                 options: Optional[FieldOptions] = None):
        self.path = path
        self.index = index
        self.name = name
        self.options = options or FieldOptions()
        self.views: dict[str, View] = {}
        self._view_mu = threading.Lock()
        self.available_shards = Bitmap()
        # bumped on every available-shards change (Index memoizes on it)
        self.shards_version = 0
        self._shards_mu = threading.Lock()

    # -- BSI layout (int fields) ---------------------------------------------

    @property
    def bsi_view_name(self) -> str:
        return VIEW_BSI_PREFIX + self.name

    @property
    def base(self) -> int:
        """BSI offset: stored value = actual - base."""
        return self.options.min

    @property
    def bit_depth(self) -> int:
        return max((self.options.max - self.options.min).bit_length(), 1)

    def _track_rank(self) -> bool:
        return (self.options.type == "set"
                and self.options.cache_type != CACHE_TYPE_NONE)

    def open(self) -> "Field":
        os.makedirs(self.path, exist_ok=True)
        meta = os.path.join(self.path, ".meta")
        if os.path.exists(meta):
            with open(meta) as f:
                self.options = FieldOptions(**json.load(f))
        else:
            self.save_meta()
        avail = os.path.join(self.path, ".available.shards")
        if os.path.exists(avail):
            with open(avail, "rb") as f:
                data = f.read()
            if data:
                self.available_shards = Bitmap.from_bytes(data)
                self.shards_version += 1
        views_dir = os.path.join(self.path, "views")
        if os.path.isdir(views_dir):
            for vname in os.listdir(views_dir):
                self.create_view_if_not_exists(vname)
        return self

    def close(self) -> None:
        for v in self.views.values():
            v.close()
        self.views.clear()

    def save_meta(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        with open(os.path.join(self.path, ".meta"), "w") as f:
            json.dump(asdict(self.options), f)

    def create_view_if_not_exists(self, name: str) -> View:
        v = self.views.get(name)
        if v is None:
            with self._view_mu:
                v = self.views.get(name)
                if v is None:
                    v = View(view_path(self.path, name), self.index,
                             self.name, name,
                             track_rank=self._track_rank()
                             and not name.startswith(VIEW_BSI_PREFIX),
                             cache_size=self.options.cache_size,
                             cache_type=self.options.cache_type).open()
                    self.views[name] = v
        return v

    def view(self, name: str = VIEW_STANDARD) -> Optional[View]:
        return self.views.get(name)

    def add_available_shards(self, shards) -> None:
        with self._shards_mu:
            new = [int(s) for s in shards
                   if not self.available_shards.contains(int(s))]
            if not new:
                return
            self.available_shards.add_many(np.asarray(new, dtype=np.uint64))
            self.shards_version += 1
            with open(os.path.join(self.path, ".available.shards"), "wb") as f:
                self.available_shards.write_to(f)

    def shards(self) -> list[int]:
        return [int(s) for s in self.available_shards.slice()]

    # -- writes -------------------------------------------------------------

    def set_bit(self, row_id: int, column: int) -> bool:
        view = self.create_view_if_not_exists(VIEW_STANDARD)
        changed = view.set_bit(row_id, column)
        self.add_available_shards([column // SHARD_WIDTH])
        return changed

    def clear_bit(self, row_id: int, column: int) -> bool:
        v = self.views.get(VIEW_STANDARD)
        return False if v is None else v.clear_bit(row_id, column)

    def import_bits(self, row_ids, columns, clear: bool = False) -> None:
        """Bulk import (clear=True removes the bits instead), grouped by
        shard in numpy: one bulk merge and one snapshot per shard. Shards
        are independent fragments, so they apply on a thread pool (the
        snapshots' writes and fsyncs, and numpy's sorts, release the GIL)."""
        rows = np.asarray(row_ids, dtype=np.uint64).reshape(-1)
        cols = np.asarray(columns, dtype=np.uint64).reshape(-1)
        if rows.shape != cols.shape:
            raise ValueError("row/column length mismatch")
        if cols.size == 0:
            return
        shards = cols // np.uint64(SHARD_WIDTH)
        order = np.argsort(shards, kind="stable")
        shards, rows, cols = shards[order], rows[order], cols[order]
        bounds = np.flatnonzero(np.diff(shards)) + 1
        view = self.create_view_if_not_exists(VIEW_STANDARD)
        groups = list(zip(shards[np.concatenate(([0], bounds))].tolist(),
                          np.split(rows, bounds), np.split(cols, bounds)))

        def apply(group) -> None:
            shard, g_rows, g_cols = group
            frag = view.create_fragment_if_not_exists(shard)
            local = g_cols % np.uint64(SHARD_WIDTH)
            if clear:
                frag.bulk_clear(g_rows, local)
            else:
                frag.bulk_import(g_rows, local)
            view.refresh_rank_cache(shard)

        if len(groups) == 1:
            apply(groups[0])
        else:
            with ThreadPoolExecutor(max_workers=IMPORT_WORKERS) as pool:
                list(pool.map(apply, groups))
        self.add_available_shards([g[0] for g in groups])

    # -- BSI values (int fields) ----------------------------------------------

    def _require_int(self) -> None:
        if self.options.type != "int":
            raise ValueError(f"field {self.name} is not an int field")

    def set_value(self, column: int, value: int) -> bool:
        """Store value - base in the BSI view."""
        self._require_int()
        if value < self.options.min or value > self.options.max:
            raise ValueError(f"value {value} out of range "
                             f"[{self.options.min}, {self.options.max}]")
        shard = column // SHARD_WIDTH
        frag = self.create_view_if_not_exists(self.bsi_view_name) \
            .create_fragment_if_not_exists(shard)
        changed = frag.set_value(column % SHARD_WIDTH, self.bit_depth,
                                 value - self.base)
        self.add_available_shards([shard])
        return changed

    def _bsi_fragment(self, column: int):
        v = self.views.get(self.bsi_view_name)
        return None if v is None else v.fragment(column // SHARD_WIDTH)

    def value(self, column: int) -> tuple[int, bool]:
        frag = self._bsi_fragment(column)
        if frag is None:
            return 0, False
        raw, ok = frag.value(column % SHARD_WIDTH, self.bit_depth)
        return (raw + self.base, True) if ok else (0, False)

    def clear_value(self, column: int) -> bool:
        frag = self._bsi_fragment(column)
        if frag is None:
            return False
        return frag.clear_value(column % SHARD_WIDTH, self.bit_depth)

    def import_values(self, columns, values) -> None:
        """BSI bulk import: the last value of a column wins; one plane-mask
        merge and one snapshot per shard, shards on a thread pool."""
        self._require_int()
        cols = np.asarray(columns, dtype=np.uint64).reshape(-1)
        vals = np.asarray(values, dtype=np.int64).reshape(-1)
        if cols.size != vals.size:
            raise ValueError("column/value length mismatch")
        bad = vals[(vals < self.options.min) | (vals > self.options.max)]
        if bad.size:
            raise ValueError(f"value {int(bad[0])} out of range")
        if cols.size == 0:
            return
        order = np.argsort(cols, kind="stable")
        cols, vals = cols[order], vals[order]
        # after a stable sort the last duplicate is last in input order
        last = np.concatenate([cols[1:] != cols[:-1], [True]])
        cols, vals = cols[last], vals[last] - self.base
        shards = cols // np.uint64(SHARD_WIDTH)
        bounds = np.flatnonzero(np.diff(shards)) + 1
        view = self.create_view_if_not_exists(self.bsi_view_name)
        groups = list(zip(shards[np.concatenate(([0], bounds))].tolist(),
                          np.split(cols, bounds), np.split(vals, bounds)))
        depth = self.bit_depth

        def apply(group) -> None:
            shard, g_cols, g_vals = group
            view.create_fragment_if_not_exists(shard).bulk_import_values(
                g_cols % np.uint64(SHARD_WIDTH), g_vals, depth)

        if len(groups) == 1:
            apply(groups[0])
        else:
            with ThreadPoolExecutor(max_workers=IMPORT_WORKERS) as pool:
                list(pool.map(apply, groups))
        self.add_available_shards([g[0] for g in groups])
