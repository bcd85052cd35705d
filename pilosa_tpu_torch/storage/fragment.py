"""Fragment: the (index, field, view, shard) storage unit.

Trimmed copy of pilosa_tpu/storage/fragment.py (:192-560, :873, :952-979):
one roaring file with a CRC-framed WAL, snapshot compaction after MAX_OP_N
ops, row generations, dense row materialization and BSI values, in the
reference's on-disk format; the row reads of TopN, Rows and GroupBy
(row_count, row_counts, row_ids, rows_for_column, bit_count; :565-577,
:644-707, :807-868); the hybrid chooser's statistics (row_cardinality,
row_runs, row_run_stats with its incremental _run_stats_update;
:709-800); and the coalesced write path's apply_batch (:431-500).

Each read works over either container store: the dict, or the frozen
array-backed store of storage/frozen.py that import_frozen (:982-1010)
installs for BASELINE-scale bulk loads, where row_counts, row_ids,
rows_for_column and bit_count answer from the flat arrays and
rows_intersection_counts (:582-635) counts |row & src| for many rows at
once (the sparse Src TopN walk). A frozen fragment is volatile (:158-167,
:1061): it has no WAL, skips the automatic snapshots, and counts the
writes it takes in volatile_mutations until snapshot() makes it durable
and re-attaches the WAL. Left out: anti-entropy blocks, mutex paths (and
the frozen mutex rewrite), import_roaring, corruption quarantine (a
damaged file raises at open) and hints.

Row r of the shard occupies absolute bit positions [r*2^20, (r+1)*2^20).
In a BSI view rows 0..depth-1 hold the place values of each column's
stored value and row `depth` is the not-null row.
"""

from __future__ import annotations

import bisect
import fcntl
import functools
import os
import threading
from typing import Iterable, Optional

import numpy as np

from pilosa_tpu_torch.constants import (
    CONTAINERS_PER_SHARD,
    MAX_OP_N,
    SHARD_WIDTH,
)
from pilosa_tpu_torch.storage.roaring import (
    Bitmap,
    is_frozen_store,
    sorted_unique,
)

SNAPSHOT_EXT = ".snapshotting"
LOCK_EXT = ".lock"


def _locked(method):
    """Serialize a mutating method under the per-fragment write lock."""
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with self.mu:
            return method(self, *args, **kwargs)
    return wrapper


def frozen_row_arrays(store) -> tuple[np.ndarray, np.ndarray]:
    """(row ids, counts) ascending arrays from a frozen store's sorted key
    layout, in one reduceat pass (:95, :637): the vectorized base of
    row_counts, row_ids and the rank cache of a frozen load."""
    keys, ns = store.key_and_count_arrays()
    if keys.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    rids = keys // CONTAINERS_PER_SHARD
    starts = np.flatnonzero(np.concatenate([[True], rids[1:] != rids[:-1]]))
    return rids[starts], np.add.reduceat(ns.astype(np.int64), starts)


def pos(row_id: int, column: int) -> int:
    """Absolute bit position of (row, column-within-shard)."""
    return row_id * SHARD_WIDTH + (column % SHARD_WIDTH)


class Fragment:
    """Host-authoritative storage for one shard of one view of one field."""

    def __init__(self, path: str, index: str, field: str, view: str,
                 shard: int, wal_fsync: bool = False):
        self.path = path
        self.index = index
        self.field = field
        self.view = view
        self.shard = shard
        self.wal_fsync = wal_fsync
        self.mu = threading.RLock()  # snapshot() runs under bulk paths
        self.storage = Bitmap()
        self.op_n = 0
        self._op_file = None
        self._lock_file = None
        self.closed = True
        # row generations: bumped on any mutation touching the row; the
        # device leaf cache keys on them
        self.generation = 0
        self._row_gen: dict[int, int] = {}
        # generation of the last bulk write: row_counts rebuilds its base
        # map when it moves, and re-probes rows written singly since
        self._bulk_gen = 0
        # every row's generation is at least this: import_frozen replaces
        # the whole store without a generation per row (the JAX package's
        # row_generation floors at its _bulk_gen)
        self._gen_floor = 0
        # storage came from import_frozen and has not been snapshotted:
        # no WAL, no automatic snapshot; the writes taken since count in
        # volatile_mutations (/debug/vars volatileFragments)
        self._volatile = False
        self.volatile_mutations = 0
        self._row_counts_cache = None  # (bulk gen, gen, map, overlay)
        self._row_ids_cache = None  # (generation, sorted row ids)
        # row -> (row generation, interval count, max run length)
        self._row_run_stats: dict[int, tuple] = {}
        # row -> (row generation, interval count)
        self._row_intervals: dict[int, tuple] = {}
        # torn WAL tail dropped at the last open
        self.wal_truncated_bytes = 0

    # -- lifecycle ----------------------------------------------------------

    def open(self) -> "Fragment":
        """flock the sidecar lock file, parse snapshot + WAL, truncate a
        torn WAL tail, attach the WAL appender."""
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._lock_file = open(self.path + LOCK_EXT, "ab")
        try:
            fcntl.flock(self._lock_file.fileno(),
                        fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._lock_file.close()
            self._lock_file = None
            raise RuntimeError(
                f"fragment file locked by another process: {self.path}")
        try:
            # unbuffered: an acked op reaches the kernel before the write
            # returns
            self._op_file = open(self.path, "ab", buffering=0)
            if os.path.getsize(self.path) == 0:
                self.storage.write_snapshot(self._op_file)
            with open(self.path, "rb") as f:
                data = f.read()
            self.storage = Bitmap.from_bytes(data, recover_wal=True)
        except Exception:
            if self._op_file is not None:
                self._op_file.close()
                self._op_file = None
            self._lock_file.close()
            self._lock_file = None
            raise
        if self.storage.wal_error is not None:
            valid_end = self.storage.wal_valid_end
            self.wal_truncated_bytes = len(data) - valid_end
            os.truncate(self.path, valid_end)
        self.op_n = self.storage.op_n
        self.storage.op_writer = self._op_file
        self.storage.op_sync = self.wal_fsync
        self.closed = False
        return self

    def close(self) -> None:
        if self._op_file is not None:
            self._op_file.close()
            self._op_file = None
        self.storage.op_writer = None
        if self._lock_file is not None:
            self._lock_file.close()  # releases the flock
            self._lock_file = None
        self.closed = True

    # -- mutation -----------------------------------------------------------

    def _touch(self, row_id: int) -> None:
        self.generation += 1
        self._row_gen[row_id] = self.generation
        if self._volatile:
            self.volatile_mutations += 1

    @property
    def frozen(self) -> bool:
        """Whether the storage is the frozen array-backed store."""
        return is_frozen_store(self.storage.containers)

    def row_generation(self, row_id: int) -> int:
        g = self._row_gen.get(row_id, 0)
        return g if g > self._gen_floor else self._gen_floor

    @_locked
    def set_bit(self, row_id: int, column: int) -> bool:
        """Set one bit; appends to the WAL, snapshots past MAX_OP_N."""
        prev_gen = self.row_generation(row_id)
        changed = self.storage.add(pos(row_id, column))
        if changed:
            self._touch(row_id)
            self._run_stats_update(row_id, column, prev_gen, added=True)
        self._increment_op_n()
        return changed

    @_locked
    def clear_bit(self, row_id: int, column: int) -> bool:
        prev_gen = self.row_generation(row_id)
        changed = self.storage.remove(pos(row_id, column))
        if changed:
            self._touch(row_id)
            self._run_stats_update(row_id, column, prev_gen, added=False)
        self._increment_op_n()
        return changed

    @_locked
    def apply_batch(self, muts) -> tuple[list, int, int]:
        """Apply one batch of ordered (is_set, row_id, column) mutations
        (pilosa_tpu/storage/fragment.py:431-500): one sorted-dedup merge
        per touched container, one generation bump for every changed row
        and one WAL group commit (Bitmap.append_ops) instead of a write per
        bit. Membership is probed once (contains_many) and then tracked
        through the batch in order, so each `changed` flag is what the
        per-bit path would return. Only the net effect per position goes
        to the WAL, each position at most once, so replay lands on the
        same state; a set then clear of an absent bit logs nothing while
        both report changed. Returns (changed, n_wal_ops, n_wal_appends)."""
        if not muts:
            return [], 0, 0
        positions = [pos(r, c) for _, r, c in muts]
        uniq = sorted(set(positions))
        initial_mask = self.storage.contains_many(
            np.asarray(uniq, dtype=np.uint64))
        state = dict(zip(uniq, initial_mask.tolist()))
        initial = dict(state)
        changed = []
        changed_rows = set()
        n_changed = 0
        for (is_set, row_id, _col), p in zip(muts, positions):
            cur = state[p]
            ch = (not cur) if is_set else cur
            state[p] = bool(is_set)
            changed.append(ch)
            if ch:
                changed_rows.add(row_id)
                n_changed += 1
        net_adds = np.array([p for p, s in state.items()
                             if s and not initial[p]], dtype=np.uint64)
        net_removes = np.array([p for p, s in state.items()
                                if not s and initial[p]], dtype=np.uint64)
        if net_adds.size:
            self.storage.add_many(net_adds)
        if net_removes.size:
            self.storage.remove_many(net_removes)
        n_net = int(net_adds.size + net_removes.size)
        wal_appends = 0
        if changed_rows:
            # one generation for the whole batch; the run statistics of
            # changed rows recount on their next read (a batch can split
            # and merge any number of runs), the interval counts are
            # carried across
            pre_gen = {rid: self.row_generation(rid) for rid in changed_rows}
            self.generation += 1
            for rid in changed_rows:
                self._row_gen[rid] = self.generation
                self._row_run_stats.pop(rid, None)
            self._intervals_after_batch(
                net_adds.tolist() + net_removes.tolist(), pre_gen)
            if self._volatile:
                self.volatile_mutations += n_changed
        if n_net and not self._volatile:
            if self.storage.op_writer is not None:
                self.storage.append_ops(net_adds, net_removes)
                wal_appends = 1
            self.op_n += n_net
            if self.op_n > MAX_OP_N:
                self.snapshot()
        return changed, n_net, wal_appends

    def _increment_op_n(self) -> None:
        self.op_n += 1
        if self.op_n > MAX_OP_N:
            self._maybe_snapshot()

    def _maybe_snapshot(self) -> None:
        """The mutating paths' snapshot (:1061): a volatile (frozen)
        fragment skips it; its durability is an explicit snapshot()."""
        if not self._volatile:
            self.snapshot()

    def _bulk_positions(self, row_ids: Iterable[int],
                        columns: Iterable[int]) -> tuple:
        rows = np.asarray(row_ids, dtype=np.uint64)
        cols = np.asarray(columns, dtype=np.uint64)
        if rows.shape != cols.shape:
            raise ValueError("row/column length mismatch")
        positions = rows * np.uint64(SHARD_WIDTH) + cols % np.uint64(SHARD_WIDTH)
        return rows, positions

    @_locked
    def bulk_import(self, row_ids: Iterable[int],
                    columns: Iterable[int]) -> None:
        """Bulk set: merge all bits, then one snapshot."""
        rows, positions = self._bulk_positions(row_ids, columns)
        self.storage.add_many(positions)
        for rid in sorted_unique(rows).tolist():
            self._touch(int(rid))
        self._bulk_gen = self.generation
        self._maybe_snapshot()

    @_locked
    def bulk_clear(self, row_ids: Iterable[int],
                   columns: Iterable[int]) -> None:
        """Bulk clear: remove all bits, then one snapshot."""
        rows, positions = self._bulk_positions(row_ids, columns)
        self.storage.remove_many(positions)
        for rid in sorted_unique(rows).tolist():
            self._touch(int(rid))
        self._bulk_gen = self.generation
        self._maybe_snapshot()

    # -- BSI values ---------------------------------------------------------

    @_locked
    def set_value(self, column: int, bit_depth: int, value: int) -> bool:
        """Write a stored (non-negative) BSI value and its not-null bit."""
        changed = False
        for i in range(bit_depth):
            if (value >> i) & 1:
                changed |= self.set_bit(i, column)
            else:
                changed |= self.clear_bit(i, column)
        changed |= self.set_bit(bit_depth, column)
        return changed

    @_locked
    def clear_value(self, column: int, bit_depth: int) -> bool:
        changed = False
        for i in range(bit_depth + 1):
            changed |= self.clear_bit(i, column)
        return changed

    def value(self, column: int, bit_depth: int) -> tuple[int, bool]:
        """(stored value, True), or (0, False) where the column has none."""
        if not self.storage.contains(pos(bit_depth, column)):
            return 0, False
        v = 0
        for i in range(bit_depth):
            if self.storage.contains(pos(i, column)):
                v |= 1 << i
        return v, True

    @_locked
    def bulk_import_values(self, columns: Iterable[int],
                           values: Iterable[int], bit_depth: int) -> None:
        """BSI bulk import: numpy plane masks, one merge, one snapshot. The
        zero planes are cleared only where the fragment already holds bits
        (a fresh fragment has nothing to overwrite)."""
        cols = np.asarray(columns, dtype=np.uint64) % np.uint64(SHARD_WIDTH)
        vals = np.asarray(values, dtype=np.int64)
        if cols.shape != vals.shape:
            raise ValueError("column/value length mismatch")
        empty = not self.storage.containers
        add, clear = [], []
        for i in range(bit_depth):
            base = np.uint64(i * SHARD_WIDTH)
            mask = ((vals >> i) & 1).astype(bool)
            add.append(cols[mask] + base)
            if not empty:
                clear.append(cols[~mask] + base)
        add.append(cols + np.uint64(bit_depth * SHARD_WIDTH))  # not-null
        if clear:
            self.storage.remove_many(np.concatenate(clear))
        self.storage.add_many(np.concatenate(add))
        for i in range(bit_depth + 1):
            self._touch(i)
        self._bulk_gen = self.generation
        self._maybe_snapshot()

    @_locked
    def import_frozen(self, positions: np.ndarray,
                      presorted: bool = False) -> None:
        """BASELINE-scale bulk load (:982-1010): replace this empty
        fragment's storage with a frozen store built from its shard-local
        bit positions in numpy. Volatile by design: nothing goes to the
        WAL or a snapshot (the load is reproducible from its source), and
        the WAL stays detached, since an op record against the unwritten
        base would replay into an empty fragment after a restart.
        snapshot() persists the whole store and re-attaches the WAL."""
        if self.storage.containers:
            raise ValueError("import_frozen requires an empty fragment")
        self.storage = Bitmap.frozen(positions, presorted=presorted)
        self.storage.op_writer = None  # volatile: see the docstring
        self._volatile = True
        self.generation += 1
        self._row_gen.clear()
        self._gen_floor = self._bulk_gen = self.generation
        self._row_counts_cache = None
        self._row_ids_cache = None
        self._row_run_stats.clear()
        self._row_intervals.clear()

    # -- reads --------------------------------------------------------------

    def row_dense(self, row_id: int) -> np.ndarray:
        """A row as a dense uint32[32768] bitvector."""
        base = row_id * SHARD_WIDTH
        return self.storage.to_dense_words(base, base + SHARD_WIDTH)

    def row_columns(self, row_id: int) -> np.ndarray:
        """Set columns of a row as shard-local int64 offsets."""
        base = row_id * SHARD_WIDTH
        return (self.storage.slice(base, base + SHARD_WIDTH)
                - np.uint64(base)).astype(np.int64)

    def row_count(self, row_id: int) -> int:
        """Set bits of one row: the sum of its containers' cardinalities
        (rows are container-aligned, so no key-space scan)."""
        base = row_id * CONTAINERS_PER_SHARD
        get = self.storage.containers.get
        total = 0
        for j in range(CONTAINERS_PER_SHARD):
            c = get(base + j)
            if c is not None:
                total += c.n
        return total

    def row_counts(self, row_ids) -> np.ndarray:
        """Exact counts of many rows -> int64 array. One pass over the
        container keys builds a row -> count map, rebuilt only after a bulk
        write; rows written singly since are re-probed through a per-row
        overlay keyed by their generations."""
        _, base_gen, m, overlay = self._row_counts_base()
        rows_arr = np.asarray(row_ids, dtype=np.int64).reshape(-1)
        if isinstance(m, tuple):
            # frozen: one vectorized lookup, then the rows written since
            uids, sums = m
            out = np.zeros(rows_arr.size, dtype=np.int64)
            if uids.size:
                idx = np.minimum(np.searchsorted(uids, rows_arr),
                                 uids.size - 1)
                hit = uids[idx] == rows_arr
                out[hit] = sums[idx[hit]]
            if not self._row_gen:
                return out
            for x, r in enumerate(rows_arr.tolist()):
                if self._row_gen.get(r, 0) > base_gen:
                    out[x] = self._overlay_count(overlay, r)
            return out
        rows = rows_arr.tolist()
        out = np.zeros(len(rows), dtype=np.int64)
        for x, r in enumerate(rows):
            if self._row_gen.get(r, 0) > base_gen:
                out[x] = self._overlay_count(overlay, r)
            else:
                out[x] = m.get(r, 0)
        return out

    def _row_counts_base(self) -> tuple:
        """(bulk gen, generation at build, base map, overlay) of
        row_counts, rebuilt after a bulk write. The base map is a dict
        row -> count over a dict store, and (row ids, counts) sorted arrays
        over a frozen one (no dict of a billion rows)."""
        cached = self._row_counts_cache
        if cached is None or cached[0] != self._bulk_gen:
            store = self.storage.containers
            if is_frozen_store(store):
                m = frozen_row_arrays(store)
            else:
                m = {}
                for key, c in list(store.items()):
                    r = key // CONTAINERS_PER_SHARD
                    m[r] = m.get(r, 0) + c.n
            cached = (self._bulk_gen, self.generation, m, {})
            self._row_counts_cache = cached
        return cached

    def _overlay_count(self, overlay: dict, row_id: int) -> int:
        """A row written since the base map was built: its count, kept per
        row generation."""
        rg = self._row_gen.get(row_id, 0)
        og = overlay.get(row_id)
        if og is None or og[0] != rg:
            og = (rg, self.row_count(row_id))
            overlay[row_id] = og
        return og[1]

    def row_cardinality(self, row_id: int) -> int:
        """Exact set bits of one row, through the row_counts cache: the
        hybrid chooser's statistic (fragment.py:709). row_counts for one
        row without its array conversions: the chooser asks once per
        fragment and leaf."""
        _, base_gen, m, overlay = self._row_counts_base()
        if self._row_gen.get(row_id, 0) > base_gen:
            return self._overlay_count(overlay, row_id)
        if isinstance(m, tuple):
            uids, sums = m
            i = int(np.searchsorted(uids, row_id))
            return int(sums[i]) if i < uids.size and uids[i] == row_id else 0
        return m.get(row_id, 0)

    def row_runs(self, row_id: int) -> np.ndarray:
        """int64[n, 2] inclusive shard-local [start, last] intervals of a
        row, from its containers (run containers verbatim, the others by
        their break scan), merged across container boundaries
        (fragment.py:719-747). No dense plane is built."""
        base = row_id * CONTAINERS_PER_SHARD
        get = self.storage.containers.get
        parts = []
        for j in range(CONTAINERS_PER_SHARD):
            c = get(base + j)
            if c is None or not c.n:
                continue
            iv = c._runs().astype(np.int64)
            if iv.shape[0]:
                parts.append(iv + (j << 16))
        if not parts:
            return np.empty((0, 2), dtype=np.int64)
        iv = np.concatenate(parts)
        if iv.shape[0] > 1:
            gap = iv[1:, 0] > iv[:-1, 1] + 1
            starts = iv[np.concatenate(([True], gap)), 0]
            lasts = iv[np.concatenate((gap, [True])), 1]
            iv = np.stack([starts, lasts], axis=1)
        return iv

    def row_interval_count(self, row_id: int) -> int:
        """Number of intervals of a row, row_runs(row_id).shape[0], from
        each container's run count (bit arithmetic on a bitmap container,
        no member array) less the runs that continue across a container
        boundary; cached per row generation. The hybrid chooser reads only
        this part of row_run_stats."""
        gen = self.row_generation(row_id)
        entry = self._row_intervals.get(row_id)
        if entry is not None and entry[0] == gen:
            return entry[1]
        base = row_id * CONTAINERS_PER_SHARD
        get = self.storage.containers.get
        n, carry = 0, False
        for j in range(CONTAINERS_PER_SHARD):
            c = get(base + j)
            if c is None or not c.n:
                carry = False
                continue
            n += c.n_runs() - int(carry and c.contains(0))
            carry = c.contains(0xFFFF)
        self._row_intervals[row_id] = (gen, n)
        return n

    def row_run_stats(self, row_id: int) -> tuple[int, int]:
        """(interval count, max run length) of one row, cached per row
        generation (fragment.py:749-769). Single-bit writes keep the entry
        current (_run_stats_update); an add that grows a run marks the
        max run length for a recount (-1), and a batch drops the entry.
        After clears the max run length can stay an upper bound until the
        next recount."""
        gen = self.row_generation(row_id)
        entry = self._row_run_stats.get(row_id)
        if entry is not None and entry[0] == gen and entry[2] >= 0:
            return entry[1], entry[2]
        iv = self.row_runs(row_id)
        n = int(iv.shape[0])
        maxr = int((iv[:, 1] - iv[:, 0] + 1).max()) if n else 0
        self._row_run_stats[row_id] = (gen, n, maxr)
        return n, maxr

    def _run_stats_update(self, row_id: int, column: int, prev_gen: int,
                          added: bool) -> None:
        """Keep one row's run statistics current across one changed bit
        (fragment.py:771-800): the interval-count delta follows from the
        two neighbour bits, probed after the write (which never changes
        them). An isolated add makes a run (+1), an add touching one
        neighbour extends one (0), an add bridging two merges them (-1);
        clears are the mirror image. Only an entry current for the row's
        pre-write generation is updated; any other is dropped. The
        chooser's interval count (row_interval_count) moves by the same
        delta."""
        entry = self._row_run_stats.get(row_id)
        iv_entry = self._row_intervals.get(row_id)
        if entry is not None and entry[0] != prev_gen:
            self._row_run_stats.pop(row_id, None)
            entry = None
        if iv_entry is not None and iv_entry[0] != prev_gen:
            iv_entry = None
        if entry is None and iv_entry is None:
            return
        col = column % SHARD_WIDTH
        left = col > 0 and self.storage.contains(pos(row_id, col - 1))
        right = (col < SHARD_WIDTH - 1
                 and self.storage.contains(pos(row_id, col + 1)))
        if added:
            delta = 1 - int(left) - int(right)
        else:
            delta = int(left) + int(right) - 1
        gen = self.row_generation(row_id)
        if iv_entry is not None:
            self._row_intervals[row_id] = (gen, iv_entry[1] + delta)
        if entry is None:
            return
        maxr = entry[2]
        if added:
            # an isolated add is a run of 1; a grown run's length needs a
            # recount, and so does a length already unknown (-1): the JAX
            # package's max(-1, 1) reads 1 there, short of a longer run
            # (ROADMAP Queue C 3; its chooser never reads the length)
            maxr = -1 if left or right or maxr < 0 else max(maxr, 1)
        self._row_run_stats[row_id] = (gen, entry[1] + delta, maxr)

    def _intervals_after_batch(self, changed: list, pre_gen: dict) -> None:
        """Carry the cached interval counts (row_interval_count) of a
        batch's changed rows across it, where the entry was current before
        the batch; the JAX package recounts them on the next read. A
        row's count is its number of run starts (a set bit whose left
        neighbour in the shard is clear), and only the net-changed
        positions and their right neighbours can gain or lose one: their
        bits after the batch are probed, and before it they differ
        exactly at the changed positions. changed: the batch's net-changed
        absolute positions."""
        live = {r: e[1] for r, g in pre_gen.items()
                if (e := self._row_intervals.get(r)) is not None
                and e[0] == g}
        if not live:
            return
        moved = {p for p in changed if p // SHARD_WIDTH in live}
        contains = self.storage.contains
        memo: dict = {}

        def bit(x: int, before: bool) -> bool:
            b = memo.get(x)
            if b is None:
                b = memo[x] = contains(x)
            return b != (before and x in moved)

        def starts(x: int, before: bool) -> int:
            if not bit(x, before):
                return 0
            return int(x % SHARD_WIDTH == 0 or not bit(x - 1, before))

        delta = dict.fromkeys(live, 0)
        for q in moved | {p + 1 for p in moved if (p + 1) % SHARD_WIDTH}:
            delta[q // SHARD_WIDTH] += starts(q, False) - starts(q, True)
        for r, n in live.items():
            self._row_intervals[r] = (self.row_generation(r), n + delta[r])

    def row_ids(self, start: int = 0, limit: Optional[int] = None) -> list[int]:
        """Distinct row ids >= start with any set bit, ascending, at most
        `limit` of them. The full list is cached per generation; over a
        frozen store as a numpy array (:812-834), boxed only for a walk
        without a limit."""
        cached = self._row_ids_cache
        if cached is None or cached[0] != self.generation:
            store = self.storage.containers
            if is_frozen_store(store):
                cached = (self.generation, frozen_row_arrays(store)[0])
            else:
                cached = (self.generation,
                          sorted({key // CONTAINERS_PER_SHARD
                                  for key in list(store)}))
            self._row_ids_cache = cached
        ids = cached[1]
        if isinstance(ids, np.ndarray):
            if limit is not None or start:
                if start:
                    ids = ids[int(np.searchsorted(ids, start)):]
                return ids[:limit].tolist()
            full = ids.tolist()
            self._row_ids_cache = (cached[0], full)
            return list(full)
        if start:
            ids = ids[bisect.bisect_left(ids, start):]
        return ids[:limit] if limit is not None else list(ids)

    def rows_for_column(self, column: int) -> list[int]:
        """Row ids with this column's bit set: only the containers that can
        hold the column (key = column >> 16 modulo the keys per row) are
        probed; over a frozen store with one vectorized membership call
        (:856)."""
        col = column % SHARD_WIDTH
        sub, low = col >> 16, col & 0xFFFF
        store = self.storage.containers
        if is_frozen_store(store):
            keys = store.key_and_count_arrays()[0]
            cand = keys[keys % CONTAINERS_PER_SHARD == sub]
            if cand.size == 0:
                return []
            probe = (cand.astype(np.uint64) << np.uint64(16)) | np.uint64(low)
            hit = self.storage.contains_many(probe)
            return np.sort(cand[hit] // CONTAINERS_PER_SHARD).tolist()
        out = [key // CONTAINERS_PER_SHARD
               for key, c in list(store.items())
               if key % CONTAINERS_PER_SHARD == sub and c.contains(low)]
        return sorted(out)

    def rows_intersection_counts(self, row_ids, src_cols: np.ndarray):
        """|row & src| for many rows against a sorted shard-local column
        set, in array math over the frozen store's flat layout: one
        gather, one searchsorted and one segment sum for all rows
        (:582-635). This makes the Src TopN walk linear in the candidates'
        stored bits rather than candidates x the dense shard width.
        int64[len(row_ids)], or None where the vectorized path does not
        apply (a dict store, or a candidate row touched by the overlay):
        the caller walks densely."""
        store = self.storage.containers
        if not is_frozen_store(store):
            return None
        kpr = CONTAINERS_PER_SHARD
        rids = np.asarray(row_ids, dtype=np.int64)
        if src_cols.size == 0:  # src empty in this shard
            return np.zeros(rids.size, dtype=np.int64)
        if store._overlay or store._deleted:
            touched = ({k // kpr for k in store._overlay}
                       | {k // kpr for k in store._deleted})
            if touched.intersection(rids.tolist()):
                return None
        keys, starts, ends = store._keys, store._starts, store._ends
        lo = np.searchsorted(keys, rids * kpr)
        hi = np.searchsorted(keys, (rids + 1) * kpr)
        n_conts = hi - lo  # containers per row
        n_all = int(n_conts.sum())
        if n_all == 0:
            return np.zeros(rids.size, dtype=np.int64)
        # every container of every row, then every element of those
        cont_idx = (np.arange(n_all, dtype=np.int64)
                    + np.repeat(lo - np.concatenate(
                        [[0], np.cumsum(n_conts)[:-1]]), n_conts))
        cont_row = np.repeat(np.arange(rids.size), n_conts)
        c_starts = starts[cont_idx]
        c_lens = (ends - starts)[cont_idx]
        total = int(c_lens.sum())
        if total == 0:
            return np.zeros(rids.size, dtype=np.int64)
        elem_idx = (np.arange(total, dtype=np.int64)
                    + np.repeat(c_starts - np.concatenate(
                        [[0], np.cumsum(c_lens)[:-1]]), c_lens))
        elem_row = np.repeat(cont_row, c_lens)
        # shard-local column of each element: (key % kpr) << 16 | low
        cols = (((keys[cont_idx] % kpr) << 16).repeat(c_lens)
                | store._lows[elem_idx].astype(np.int64))
        at = np.minimum(np.searchsorted(src_cols, cols), src_cols.size - 1)
        member = src_cols[at] == cols
        return np.bincount(elem_row, weights=member,
                           minlength=rids.size).astype(np.int64)

    def bit_count(self) -> int:
        return self.storage.count()

    # -- snapshot / WAL compaction ------------------------------------------

    @_locked
    def snapshot(self) -> None:
        """Rewrite the file as one snapshot (with integrity trailer) via a
        temp file and an atomic rename; the WAL restarts empty."""
        tmp = self.path + SNAPSHOT_EXT
        if self._op_file is not None:
            self._op_file.close()
            self._op_file = None
        try:
            self.storage.optimize()
            with open(tmp, "wb") as f:
                self.storage.write_snapshot(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
            if not self.closed:
                self._op_file = open(self.path, "ab", buffering=0)
            self.storage.op_writer = self._op_file
            self.storage.op_sync = self.wal_fsync
        self.op_n = 0
        self.storage.op_n = 0
        self._volatile = False  # persisted: the WAL is attached again
        self.volatile_mutations = 0
