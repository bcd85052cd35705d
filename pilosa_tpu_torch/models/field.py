"""Field: a typed sub-matrix of an index.

Trimmed copy of pilosa_tpu/models/field.py: the five field types (set,
int, time, mutex, bool; :32-65). Set, mutex, bool and time fields keep
their bits in the standard view; a time field also writes each
timestamped bit into one `standard_<YYYY[MM[DD[HH]]]>` view per unit of
its quantum (models/timequantum.py; :195-220); mutex and bool fields
hold at most one row per column, clearing the column's other rows before
a set (:206-243) and, in a bulk import, letting the last write of a
column win (Fragment.bulk_import_mutex). Int fields keep their values
bit-sliced in the `bsig_<field>` view (rows 0..depth-1 the place values
of value - min, row depth the not-null row; :95-107, :245-277,
:340-383). Options and the available-shards bitmap persist in the
reference's files (`.meta` JSON, `.available.shards` roaring), so either
package opens a field the other wrote. A keyed field (`keys`) is a
field whose rows the executor names by string keys (utils/translate.py);
its storage is the same. The field's row attributes live in
`<field>/.row_attrs.db` (utils/attrstore.py; :86-88), opened and closed
with the field.

Every view of a set, mutex, bool or time field tracks rank (a rank cache
per fragment, the TopN candidates) unless its cache type is "none";
`bsig_` views never do (:109-111, :152-166). A bulk import rebuilds each
touched fragment's cache after its apply (:309). import_rows_frozen and
import_values_frozen (:312-338, :385-410) are the BASELINE-scale loads:
each shard's fragment freezes in one shot from a numpy position array
(storage/frozen.py), volatile until it is snapshotted.
"""

from __future__ import annotations

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass
from datetime import datetime
from typing import Optional

import numpy as np

from pilosa_tpu_torch.constants import DEFAULT_CACHE_SIZE, SHARD_WIDTH
from pilosa_tpu_torch.models import timequantum
from pilosa_tpu_torch.models.cache import CACHE_TYPE_NONE, CACHE_TYPES
from pilosa_tpu_torch.models.row import Row
from pilosa_tpu_torch.models.view import (
    VIEW_BSI_PREFIX,
    VIEW_STANDARD,
    View,
    view_path,
)
from pilosa_tpu_torch.storage.roaring import Bitmap
from pilosa_tpu_torch.utils.attrstore import AttrStore

# threads applying one bulk import's per-shard groups
IMPORT_WORKERS = min(8, os.cpu_count() or 1)


def _each(apply, groups: list) -> None:
    """apply() over per-shard groups: shards are independent fragments, so
    more than one go to a thread pool (numpy's sorts and the snapshots'
    writes release the GIL)."""
    if len(groups) == 1:
        apply(groups[0])
    elif groups:
        with ThreadPoolExecutor(max_workers=IMPORT_WORKERS) as pool:
            list(pool.map(apply, groups))


def as_datetime64(timestamps) -> np.ndarray:
    """Import timestamps as datetime64[us], NaT where a bit has none: a
    datetime64 array as it is, else a sequence of naive datetimes (the
    wall clock, as the JAX package's strftime reads it) and Nones."""
    if isinstance(timestamps, np.ndarray) and timestamps.dtype.kind == "M":
        return timestamps.astype("datetime64[us]").reshape(-1)
    vals = [None if t is None else t.replace(tzinfo=None)
            for t in timestamps]
    return np.array(vals, dtype="datetime64[us]").reshape(-1)


class NotPortedError(ValueError):
    """A feature of the JAX package this port does not serve yet."""


# the field types (FieldType, :32-39)
SET, INT, TIME, MUTEX, BOOL = "set", "int", "time", "mutex", "bool"
FIELD_TYPES = (SET, INT, TIME, MUTEX, BOOL)
# the types whose rows are bits of the standard view (and time views)
ROW_TYPES = (SET, MUTEX, BOOL, TIME)
# at most one row per column
MUTEX_TYPES = (MUTEX, BOOL)
# numpy's unit of each quantum unit
_NP_UNITS = {"Y": "Y", "M": "M", "D": "D", "H": "h"}


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
        """The JAX package's checks and texts (:52-65)."""
        if self.type not in FIELD_TYPES:
            raise ValueError(f"invalid field type: {self.type}")
        if self.cache_type not in CACHE_TYPES:
            raise ValueError(f"invalid cache type: {self.cache_type}")
        if self.type == INT and self.max < self.min:
            raise ValueError("int field max must be >= min")
        if self.type == TIME:
            timequantum.validate_quantum(self.time_quantum)
            if not self.time_quantum:
                raise ValueError("time field requires a time quantum")


class Field:
    def __init__(self, path: str, index: str, name: str,
                 options: Optional[FieldOptions] = None,
                 wal_fsync: bool = False):
        self.path = path
        self.wal_fsync = wal_fsync
        self.index = index
        self.name = name
        self.options = options or FieldOptions()
        self.views: dict[str, View] = {}
        self._view_mu = threading.Lock()
        self.available_shards = Bitmap()
        # bumped on every available-shards change (Index memoizes on it)
        self.shards_version = 0
        self._shards_mu = threading.Lock()
        # on_shard_added(index, field, shard): the server's create-shard
        # announcement (Holder.set_shard_hook)
        self.on_shard_added = None
        self.row_attrs = AttrStore(os.path.join(self.path, ".row_attrs.db"))

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
        return (self.options.type in ROW_TYPES
                and self.options.cache_type != CACHE_TYPE_NONE)

    def open(self) -> "Field":
        os.makedirs(self.path, exist_ok=True)
        self.row_attrs.open()
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

    def close(self, save_caches: bool = True) -> None:
        for v in self.views.values():
            v.close(save_caches)
        self.views.clear()
        self.row_attrs.close()

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
                             cache_type=self.options.cache_type,
                             wal_fsync=self.wal_fsync).open()
                    self.views[name] = v
        return v

    def view(self, name: str = VIEW_STANDARD) -> Optional[View]:
        return self.views.get(name)

    def add_available_shards(self, shards, quiet: bool = False) -> None:
        """Mark shards available; each new one is announced through
        on_shard_added unless quiet (a shard learned from another node)."""
        with self._shards_mu:
            new = [int(s) for s in shards
                   if not self.available_shards.contains(int(s))]
            if not new:
                return
            self.available_shards.add_many(np.asarray(new, dtype=np.uint64))
            self.shards_version += 1
            self._save_available_shards()
        hook = self.on_shard_added
        if hook is not None and not quiet:
            for s in new:
                hook(self.index, self.name, s)

    def remove_available_shard(self, shard: int) -> None:
        """DELETE .../remote-available-shards/{shard} (field.go:303)."""
        with self._shards_mu:
            if not self.available_shards.contains(int(shard)):
                return
            self.available_shards.remove(int(shard))
            self.shards_version += 1
            self._save_available_shards()

    def _save_available_shards(self) -> None:
        with open(os.path.join(self.path, ".available.shards"), "wb") as f:
            self.available_shards.write_to(f)

    def shards(self) -> list[int]:
        return [int(s) for s in self.available_shards.slice()]

    # -- writes -------------------------------------------------------------

    def _views_for_write(self, timestamp: Optional[datetime]) -> list[str]:
        """The views a bit write lands in (:195-204): the standard view,
        and on a time field one view per quantum unit of the timestamp."""
        if self.options.type == TIME:
            views = [] if timestamp is None else timequantum.views_by_time(
                VIEW_STANDARD, timestamp, self.options.time_quantum)
            return [VIEW_STANDARD] + views
        if timestamp is not None:
            raise ValueError("timestamp given on non-time field")
        return [VIEW_STANDARD]

    def set_bit(self, row_id: int, column: int,
                timestamp: Optional[datetime] = None) -> bool:
        """Set one bit in every view of the write (:206-220); a mutex or
        bool field first clears the column's other rows."""
        if self.options.type == INT:
            raise ValueError(
                f"field {self.name} is an int field; use set_value")
        if self.options.type == BOOL and row_id not in (0, 1):
            raise ValueError("bool field rows must be 0 (false) or 1 (true)")
        if self.options.type in MUTEX_TYPES:
            self._clear_other_rows(row_id, column)
        changed = False
        for vname in self._views_for_write(timestamp):
            changed |= self.create_view_if_not_exists(vname).set_bit(
                row_id, column)
        self.add_available_shards([column // SHARD_WIDTH])
        return changed

    def clear_bit(self, row_id: int, column: int) -> bool:
        """Clear one bit in every view but the BSI one (:222-227)."""
        changed = False
        for v in list(self.views.values()):
            if not v.name.startswith(VIEW_BSI_PREFIX):
                changed |= v.clear_bit(row_id, column)
        return changed

    def _clear_other_rows(self, row_id: int, column: int) -> None:
        """Mutex semantics (:229-243): clear every other row holding the
        column, found by the column probe (Fragment.rows_for_column)."""
        shard = column // SHARD_WIDTH
        for v in list(self.views.values()):
            if v.name.startswith(VIEW_BSI_PREFIX):
                continue
            frag = v.fragment(shard)
            if frag is None:
                continue
            for rid in frag.rows_for_column(column):
                if rid != row_id:
                    v.clear_bit(rid, column)

    def import_bits(self, row_ids, columns, timestamps=None,
                    clear: bool = False) -> None:
        """Bulk import (clear=True removes the bits instead), grouped by
        (view, shard) in numpy: one bulk merge and one snapshot per
        fragment, the fragments on a thread pool (the snapshots' writes
        and fsyncs, and numpy's sorts, release the GIL). On a time field
        each timestamped bit also goes to its quantum's views (:281-310);
        timestamps are datetimes or None, or a datetime64 array with NaT
        for none, and other field types ignore them. A mutex or bool field
        lets the last write of a column win (Fragment.bulk_import_mutex)."""
        rows = np.asarray(row_ids, dtype=np.uint64).reshape(-1)
        cols = np.asarray(columns, dtype=np.uint64).reshape(-1)
        if rows.shape != cols.shape:
            raise ValueError("row/column length mismatch")
        ts = None
        if timestamps is not None:
            ts = as_datetime64(timestamps)
            if ts.shape != cols.shape:
                raise ValueError("row/column/timestamp length mismatch")
        if cols.size == 0:
            return
        shards = (cols // np.uint64(SHARD_WIDTH)).astype(np.int64)
        # every bit in the standard view (view 0), then each timestamped
        # bit once per quantum unit, in views numbered from 1
        names = [VIEW_STANDARD]
        vidx, sel = [np.zeros(cols.size, dtype=np.int64)], [None]
        if self.options.type == TIME and ts is not None:
            has = np.flatnonzero(~np.isnat(ts))
            for unit in self.options.time_quantum:
                codes = ts[has].astype(f"datetime64[{_NP_UNITS[unit]}]")
                uniq, inv = np.unique(codes, return_inverse=True)
                vidx.append(inv.astype(np.int64) + len(names))
                # .item(): a datetime, or a date for a day or coarser
                # unit, whose strftime is the same
                names += [timequantum.view_by_time_unit(
                    VIEW_STANDARD, u.item(), unit) for u in uniq]
                sel.append(has)
        v_all = np.concatenate(vidx)
        s_all = np.concatenate([shards if x is None else shards[x]
                                for x in sel])
        order = np.lexsort((s_all, v_all))  # stable: input order kept
        v_all, s_all = v_all[order], s_all[order]
        take = np.concatenate([np.arange(cols.size) if x is None else x
                               for x in sel])[order]
        bounds = np.flatnonzero((np.diff(v_all) != 0)
                                | (np.diff(s_all) != 0)) + 1
        starts = np.concatenate(([0], bounds)).tolist()
        groups = [(names[int(v_all[a])], int(s_all[a]), idx)
                  for a, idx in zip(starts, np.split(take, bounds))]
        views = {n: self.create_view_if_not_exists(n)
                 for n in dict.fromkeys(g[0] for g in groups)}
        mutex = self.options.type in MUTEX_TYPES

        def apply(group) -> None:
            vname, shard, idx = group
            view = views[vname]
            frag = view.create_fragment_if_not_exists(shard)
            local = cols[idx] % np.uint64(SHARD_WIDTH)
            if clear:
                frag.bulk_clear(rows[idx], local)
            elif mutex:
                frag.bulk_import_mutex(rows[idx], local)
            else:
                frag.bulk_import(rows[idx], local)
            view.refresh_rank_cache(shard)

        _each(apply, groups)
        self.add_available_shards(sorted({g[1] for g in groups}))

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

    def _values_shard_groups(self, columns, values) -> list:
        """Validate a BSI import, keep the last value of each column (the
        reference's importValue: both would leave the OR of the two) and
        split it by shard (:340-373), in numpy: [(shard, shard-local
        columns, stored values)]. A list, so that a rejected import
        creates no view."""
        cols = np.asarray(columns, dtype=np.uint64).reshape(-1)
        vals = np.asarray(values, dtype=np.int64).reshape(-1)
        if cols.size != vals.size:
            raise ValueError("column/value length mismatch")
        bad = vals[(vals < self.options.min) | (vals > self.options.max)]
        if bad.size:
            raise ValueError(f"value {int(bad[0])} out of range")
        if cols.size == 0:
            return []
        order = np.argsort(cols, kind="stable")
        cols, vals = cols[order], vals[order]
        # after a stable sort the last duplicate is last in input order
        last = np.concatenate([cols[1:] != cols[:-1], [True]])
        cols, vals = cols[last], vals[last] - self.base
        shards = cols // np.uint64(SHARD_WIDTH)
        bounds = np.flatnonzero(np.diff(shards)) + 1
        return list(zip(shards[np.concatenate(([0], bounds))].tolist(),
                        np.split(cols % np.uint64(SHARD_WIDTH), bounds),
                        np.split(vals, bounds)))

    def import_values(self, columns, values) -> None:
        """BSI bulk import: the last value of a column wins; one plane-mask
        merge and one snapshot per shard, shards on a thread pool."""
        self._require_int()
        groups = self._values_shard_groups(columns, values)
        if not groups:
            return
        view = self.create_view_if_not_exists(self.bsi_view_name)
        depth = self.bit_depth

        def apply(group) -> None:
            shard, g_cols, g_vals = group
            view.create_fragment_if_not_exists(shard).bulk_import_values(
                g_cols, g_vals, depth)

        _each(apply, groups)
        self.add_available_shards([g[0] for g in groups])

    # -- frozen bulk loads (BASELINE scale) -----------------------------------

    def import_rows_frozen(self, row_ids, columns) -> None:
        """Set-field bulk load through the frozen store: the shard split
        and the bit positions in numpy, each shard's (empty) fragment
        frozen in one shot with its rank cache built from the store's
        arrays (View.load_frozen_fragment). Standard view only."""
        if self.options.type != "set" or self.options.time_quantum:
            raise ValueError(
                "import_rows_frozen supports plain set fields only")
        rows = np.asarray(row_ids, dtype=np.uint64).reshape(-1)
        cols = np.asarray(columns, dtype=np.uint64).reshape(-1)
        if rows.size != cols.size:
            raise ValueError("row/column length mismatch")
        w = np.uint64(SHARD_WIDTH)
        shards = (cols // w).astype(np.int64)
        positions = rows * w + cols % w
        order = np.lexsort((positions, shards))
        shards, positions = shards[order], positions[order]
        bounds = np.flatnonzero(np.diff(shards)) + 1
        view = self.create_view_if_not_exists(VIEW_STANDARD)
        groups = list(zip(np.split(shards, bounds),
                          np.split(positions, bounds)))
        groups = [(int(g_shards[0]), g_pos) for g_shards, g_pos in groups
                  if g_shards.size]
        _each(lambda g: view.load_frozen_fragment(*g), groups)
        self.add_available_shards([g[0] for g in groups])

    def import_values_frozen(self, columns, values) -> None:
        """Int-field bulk load through the frozen store: per shard the
        plane masks become one sorted position array (plane ranges are
        disjoint and the columns sorted and unique, so plane order is
        sorted order) and the empty fragment freezes in one shot. Volatile
        like import_rows_frozen."""
        if self.options.type != "int":
            raise ValueError("import_values_frozen supports int fields only")
        groups = self._values_shard_groups(columns, values)
        view = self.create_view_if_not_exists(self.bsi_view_name)
        depth = self.bit_depth
        sw = np.uint64(SHARD_WIDTH)

        def apply(group) -> None:
            shard, g_cols, g_vals = group
            planes = [g_cols[((g_vals >> i) & 1).astype(bool)]
                      + np.uint64(i) * sw for i in range(depth)]
            planes.append(g_cols + np.uint64(depth) * sw)  # not-null row
            view.load_frozen_fragment(shard, np.concatenate(planes),
                                      presorted=True)

        _each(apply, groups)
        self.add_available_shards([g[0] for g in groups])

    # -- reads ----------------------------------------------------------------

    def row(self, row_id: int, view: str = VIEW_STANDARD) -> Row:
        """One row across the view's shards (Field.row, :413)."""
        v = self.views.get(view)
        out = Row()
        if v is None:
            return out
        for shard in v.shards():
            cols = v.fragment(shard).row_columns(row_id)
            if cols.size:
                out.segments[shard] = (cols.astype(np.uint64)
                                       + np.uint64(shard * SHARD_WIDTH))
        return out

    def row_time(self, row_id: int, start: datetime, end: datetime) -> Row:
        """The union of the views covering [start, end) (:427)."""
        if self.options.type != TIME:
            raise ValueError("row_time on non-time field")
        out = Row()
        for vname in timequantum.views_by_time_range(
                VIEW_STANDARD, start, end, self.options.time_quantum):
            for shard, seg in self.row(row_id, view=vname).segments.items():
                have = out.segments.get(shard)
                out.segments[shard] = (seg if have is None
                                       else np.union1d(have, seg))
        return out
