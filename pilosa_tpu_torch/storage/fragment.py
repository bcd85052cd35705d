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
and re-attaches the WAL. The typed fields' writes: bulk_import_mutex
(with the frozen rewrite), set_row and clear_row (Store and ClearRow,
which the port logs to the WAL: durable across a reopen, unlike the JAX
package's) and import_roaring (with the in-place clear over a frozen
store). Left out: anti-entropy blocks, corruption quarantine (a damaged
file raises at open) and hints.

Row r of the shard occupies absolute bit positions [r*2^20, (r+1)*2^20).
In a BSI view rows 0..depth-1 hold the place values of each column's
stored value and row `depth` is the not-null row.
"""

from __future__ import annotations

import bisect
import functools
import hashlib
import io
import os
import threading
import time
from typing import Iterable, Optional

import numpy as np

from pilosa_tpu_torch.constants import (
    CONTAINERS_PER_SHARD,
    HASH_BLOCK_SIZE,
    MAX_OP_N,
    SHARD_WIDTH,
)
from pilosa_tpu_torch.storage.roaring import (
    Bitmap,
    is_frozen_store,
    sorted_unique,
)

SNAPSHOT_EXT = ".snapshotting"


@functools.lru_cache(maxsize=1)
def _empty_snapshot() -> bytes:
    """The file of a new fragment: an empty bitmap's snapshot."""
    buf = io.BytesIO()
    Bitmap().write_snapshot(buf)
    return buf.getvalue()


def _write_all(fd: int, data) -> None:
    view = memoryview(data)
    while view:
        view = view[os.write(fd, view):]


class _FdBudget:
    """How many WAL descriptors the process keeps open at once. A
    fragment keeps its WAL open while the budget allows and opens and
    closes it per append past it: one process's fragments can outnumber
    its open-file limit (RLIMIT_NOFILE is 20,000 on the card's machine; a
    Star Trace-shaped time field of 1024 shards has 97,280 fragments),
    while a write path's hot fragments keep their descriptors."""

    def __init__(self, cap: int):
        self.cap = cap
        self.used = 0
        self._mu = threading.Lock()

    def take(self) -> bool:
        with self._mu:
            if self.used >= self.cap:
                return False
            self.used += 1
            return True

    def give(self) -> None:
        with self._mu:
            self.used -= 1


WAL_FDS = _FdBudget(8192)


class WalAppender:
    """A fragment's WAL as Bitmap.op_writer. It opens the file at its
    first write and keeps the descriptor while WAL_FDS allows (else it
    closes it after each write); the fragment's snapshot() and close()
    release it (a snapshot replaces the file). The first write to a
    fragment that has no file yet (`ready` False) creates it with an
    empty snapshot ahead of the ops. Writes run under the fragment's
    lock. An acknowledged op has reached the kernel (and with wal_fsync
    the disk) before write() returns."""

    __slots__ = ("path", "sync", "ready", "fd")

    def __init__(self, path: str, sync: bool):
        self.path = path
        self.sync = sync
        self.ready = False  # the file holds a snapshot to append to
        self.fd = None  # kept open under WAL_FDS

    def write(self, data) -> int:
        fd = self.fd
        if fd is None:
            flags = os.O_WRONLY | os.O_APPEND
            if not self.ready:
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                flags |= os.O_CREAT | os.O_TRUNC
            fd = os.open(self.path, flags, 0o644)
            if WAL_FDS.take():
                self.fd = fd
        try:
            if not self.ready:
                _write_all(fd, _empty_snapshot())
            _write_all(fd, data)
            if self.sync:
                os.fsync(fd)
        finally:
            if self.fd is None:
                os.close(fd)
        self.ready = True
        return len(data)

    def release(self) -> None:
        """Close the kept descriptor, if any."""
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None
            WAL_FDS.give()


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
        self._wal = WalAppender(path, wal_fsync)
        self.closed = True
        self.fresh = False  # open() found no file, or an empty one
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
        self.wal_truncate_error: Optional[str] = None
        # a damaged snapshot moved aside at open, until a replica rebuild
        self.quarantine_path: Optional[str] = None
        self.corruption_error: Optional[str] = None
        self.rebuilt_from: Optional[str] = None
        # block -> checksum, dropped per block by the writes
        self._block_checksums: dict[int, bytes] = {}

    # -- lifecycle ----------------------------------------------------------

    def open(self, new: bool = False) -> "Fragment":
        """Parse snapshot + WAL, truncate a torn WAL tail, attach the WAL
        appender. A new fragment's file is written at its first op or
        snapshot (a bulk load writes each new fragment once); new=True
        says the caller knows there is no file (its view listed them all
        at open) and skips the lookup. A damaged snapshot section is
        quarantined (_quarantine) and the fragment reopens empty. No
        descriptor stays open but the WAL's, within WAL_FDS; the holder's
        lock excludes other processes (models/holder.py)."""
        self.quarantine_path = None
        self.corruption_error = None
        self.rebuilt_from = None
        self.wal_truncated_bytes = 0
        self.wal_truncate_error = None
        data = b""
        if not new:
            try:
                with open(self.path, "rb") as f:
                    data = f.read()
            except FileNotFoundError:
                pass
        self.fresh = not data
        if not self.fresh:
            try:
                self.storage = Bitmap.from_bytes(data, recover_wal=True)
            except ValueError as e:
                self.corruption_error = str(e)
                self.quarantine_path = self._quarantine()
                self.storage = Bitmap()
                self.fresh = True
            if self.storage.wal_error is not None:
                valid_end = self.storage.wal_valid_end
                self.wal_truncated_bytes = len(data) - valid_end
                self.wal_truncate_error = self.storage.wal_error
                os.truncate(self.path, valid_end)
        self.op_n = self.storage.op_n
        self._wal.ready = not self.fresh or self.quarantine_path is not None
        self.storage.op_writer = self._wal
        self.closed = False
        return self

    def _quarantine(self) -> str:
        """Move the damaged file to `<path>.corrupt-<ts>` (kept for the
        operator) and put an empty fragment's file in its place, as the
        JAX package's open does (:325-338)."""
        ts = time.strftime("%Y%m%d-%H%M%S")
        dest = f"{self.path}.corrupt-{ts}"
        i = 1
        while os.path.exists(dest):
            dest = f"{self.path}.corrupt-{ts}-{i}"
            i += 1
        os.replace(self.path, dest)
        with open(self.path, "wb") as f:
            f.write(_empty_snapshot())
        return dest

    @property
    def needs_rebuild(self) -> bool:
        """Quarantined at open and not rebuilt from a replica yet (the
        scrubber's work list)."""
        return self.quarantine_path is not None and self.rebuilt_from is None

    def close(self) -> None:
        self.storage.op_writer = None
        self._wal.release()
        self.closed = True

    # -- mutation -----------------------------------------------------------

    def _touch(self, row_id: int) -> None:
        self.generation += 1
        self._row_gen[row_id] = self.generation
        self._block_checksums.pop(row_id // HASH_BLOCK_SIZE, None)
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
                self._block_checksums.pop(rid // HASH_BLOCK_SIZE, None)
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

    @_locked
    def bulk_import_mutex(self, row_ids: Iterable[int],
                          columns: Iterable[int]) -> None:
        """Mutex bulk set (:902-951): the last write of a column wins, and
        every other row's bit in a written column is cleared. The mutex
        invariant bounds the fragment's bits by the column space, so all
        of them are read once, the stale bits fall out of set algebra, and
        the store is rebuilt from the final position set (Bitmap.reset: a
        frozen store's flat arrays by FrozenContainers.from_positions, as
        in the JAX package; a dict store's containers optimally encoded)
        instead of merging container by container."""
        rows = np.asarray(row_ids, dtype=np.uint64).reshape(-1)
        cols = (np.asarray(columns, dtype=np.uint64).reshape(-1)
                % np.uint64(SHARD_WIDTH))
        if rows.size != cols.size:
            raise ValueError("row/column length mismatch")
        if rows.size == 0:
            return
        # the first occurrence in the reversed arrays is the last write
        ucols, ridx = np.unique(cols[::-1], return_index=True)
        target = rows[::-1][ridx]  # aligned with ucols (sorted)
        sw = np.uint64(SHARD_WIDTH)
        all_pos = self.storage.positions()
        cand = all_pos[np.isin(all_pos % sw, ucols)]
        want = target[np.searchsorted(ucols, cand % sw)]
        to_clear = cand[cand // sw != want]
        add_pos = target * sw + ucols
        self.storage.reset(np.union1d(
            np.setdiff1d(all_pos, to_clear, assume_unique=True), add_pos))
        for rid in np.unique(np.concatenate([to_clear // sw,
                                             target])).tolist():
            self._touch(int(rid))
        self._bulk_gen = self.generation
        self._maybe_snapshot()

    # -- whole rows ---------------------------------------------------------

    def _log_row_ops(self, adds: np.ndarray, removes: np.ndarray) -> None:
        """A whole-row write's net bits to the WAL in one append (the JAX
        package logs none, so its Store and ClearRow are lost at a reopen;
        ROADMAP Queue C 5), snapshotting past MAX_OP_N. A volatile
        fragment logs nothing: its snapshot() makes the write durable."""
        n = int(adds.size + removes.size)
        if self._volatile or n == 0:
            return
        self.storage.append_ops(adds, removes)
        self.op_n += n
        if self.op_n > MAX_OP_N:
            self.snapshot()

    @_locked
    def set_row(self, row_id: int, columns) -> None:
        """Replace a row with the given shard-local columns (:503-511, the
        reference's setRow); the row's generation moves even when its bits
        do not."""
        base = row_id * SHARD_WIDTH
        old = self.storage.slice(base, base + SHARD_WIDTH)
        new = sorted_unique(np.asarray(columns, dtype=np.uint64).reshape(-1)
                            % np.uint64(SHARD_WIDTH) + np.uint64(base))
        removes = np.setdiff1d(old, new, assume_unique=True)
        adds = np.setdiff1d(new, old, assume_unique=True)
        if removes.size:
            self.storage.remove_many(removes)
        if adds.size:
            self.storage.add_many(adds)
        self._touch(row_id)
        self._log_row_ops(adds, removes)

    @_locked
    def clear_row(self, row_id: int) -> int:
        """Clear a row (:513-521); returns how many bits it held."""
        base = row_id * SHARD_WIDTH
        vals = self.storage.remove_range(base, base + SHARD_WIDTH)
        if vals.size:
            self._touch(row_id)
            self._log_row_ops(np.empty(0, dtype=np.uint64), vals)
        return int(vals.size)

    @_locked
    def import_roaring(self, data: bytes, clear: bool = False) -> None:
        """Union (or clear) a serialized roaring bitmap of shard-local
        positions into the fragment, then one snapshot (:1013-1058). Over
        a frozen store both go through the copy-on-write overlay, touching
        only the incoming containers, and the fragment stays volatile with
        the write counted. Every row counts as written."""
        other = Bitmap.from_bytes(data)
        if clear:
            # a difference, container by container: the JAX package's
            # in-place clear over a frozen store asks Container.op for a
            # "difference" kind it does not have and gets a xor (ROADMAP
            # Queue C 6)
            self.storage.remove_many(other.positions())
        else:
            self.storage.add_many(other.positions())
        self.generation += 1
        self._row_gen.clear()
        self._gen_floor = self._bulk_gen = self.generation
        self._row_run_stats.clear()
        self._row_intervals.clear()
        self._block_checksums.clear()
        if self._volatile:
            self.volatile_mutations += 1
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
        self._block_checksums.clear()

    # -- reads --------------------------------------------------------------

    def row_dense(self, row_id: int,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
        """A row as a dense uint32[32768] bitvector (written into `out`, a
        zeroed one, where given)."""
        base = row_id * SHARD_WIDTH
        return self.storage.to_dense_words(base, base + SHARD_WIDTH, out)

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

    # -- anti-entropy blocks (:1176-1300) -----------------------------------

    def blocks(self) -> list[tuple[int, bytes]]:
        """(block, checksum) of every non-empty HASH_BLOCK_SIZE-row block,
        ascending: blake2b-16 over the block's positions relative to its
        start, as uint64 (the JAX package's bytes)."""
        blks = sorted({r // HASH_BLOCK_SIZE for r in self.row_ids()})
        out = []
        for blk in blks:
            chk = self._block_checksum(blk)
            if chk is not None:
                out.append((blk, chk))
        return out

    def _block_positions(self, blk: int) -> np.ndarray:
        """The block's positions relative to its start, ascending uint64.
        A block is whole containers, so its containers' values are
        gathered as they are and offset by their keys in a few array
        operations, not filtered container by container (Bitmap.slice):
        a returning node checks every block of every fenced fragment."""
        span = HASH_BLOCK_SIZE * CONTAINERS_PER_SHARD
        first = blk * span
        keys = self.storage._keys_in(first << 16, (first + span) << 16)
        if not keys:
            return np.empty(0, dtype=np.uint64)
        get = self.storage.containers.__getitem__
        vals = [get(k).values() for k in keys]
        lens = np.fromiter((v.size for v in vals), dtype=np.int64,
                           count=len(vals))
        offs = (np.asarray(keys, dtype=np.uint64)
                - np.uint64(first)) << np.uint64(16)
        return np.repeat(offs, lens) + np.concatenate(vals).astype(np.uint64)

    def _block_checksum(self, blk: int) -> Optional[bytes]:
        cached = self._block_checksums.get(blk)
        if cached is not None:
            return cached
        # under the write lock: a write between the read and the store
        # would leave a stale checksum cached
        with self.mu:
            rel = self._block_positions(blk)
            if rel.size == 0:
                return None
            h = hashlib.blake2b(rel.tobytes(), digest_size=16).digest()
            self._block_checksums[blk] = h
            return h

    def block_data(self, blk: int) -> tuple[np.ndarray, np.ndarray]:
        """(rows, columns) int64 pairs of one block, ascending."""
        rel = self._block_positions(blk)
        sw = np.uint64(SHARD_WIDTH)
        return ((rel // sw).astype(np.int64) + blk * HASH_BLOCK_SIZE,
                (rel % sw).astype(np.int64))

    @_locked
    def merge_block_majority(self, blk: int, peer_positions: list,
                             majority_n: Optional[int] = None):
        """One block merged across every replica at once (:1211-1300).
        peer_positions: one uint64 position array per peer (an empty one
        still votes). The target is every pair held by at least
        majority_n replicas, this one included ((replicas + 1) // 2 when
        None: union with one peer; with three, a bit cleared on two stays
        cleared). Applies this fragment's sets and clears, bumping the
        generation of every changed row, and returns (n_sets, n_clears,
        deltas, durable): deltas[i] is the (sets, clears) pair for peer i.
        Up to MAX_OP_N changes go to the WAL as redo records; a volatile
        (frozen) fragment logs nothing (its durability is an explicit
        snapshot); durable is False only for a larger change on a WAL
        fragment, which asks the caller for one snapshot."""
        local_rows, local_cols = self.block_data(blk)
        sw = np.uint64(SHARD_WIDTH)
        local_pos = local_rows.astype(np.uint64) * sw \
            + local_cols.astype(np.uint64)
        votes = [np.unique(np.asarray(p, dtype=np.uint64))
                 for p in peer_positions]
        votes.insert(0, local_pos)
        if majority_n is None:
            majority_n = (len(votes) + 1) // 2
        uniq, counts = np.unique(np.concatenate(votes), return_counts=True)
        target = uniq[counts >= majority_n]
        deltas = [(np.setdiff1d(target, v), np.setdiff1d(v, target))
                  for v in votes]
        local_sets, local_clears = deltas[0]
        if local_sets.size:
            self.storage.add_many(local_sets)
        if local_clears.size:
            self.storage.remove_many(local_clears)
        durable = True
        n_changed = int(local_sets.size) + int(local_clears.size)
        if n_changed:
            changed = np.concatenate([local_sets, local_clears])
            for rid in np.unique(changed // sw).tolist():
                self._touch(int(rid))
            if self._volatile:
                pass  # durability is the explicit snapshot()
            elif (self.storage.op_writer is not None
                  and n_changed <= MAX_OP_N):
                self.storage.append_ops(local_sets, local_clears)
                self.op_n += n_changed
                if self.op_n > MAX_OP_N:
                    self.snapshot()
            else:
                durable = False
        return (int(local_sets.size), int(local_clears.size), deltas[1:],
                durable)

    # -- snapshot / WAL compaction ------------------------------------------

    @_locked
    def snapshot(self) -> None:
        """Rewrite the file as one snapshot (with integrity trailer) via a
        temp file and an atomic rename; the WAL restarts empty."""
        tmp = self.path + SNAPSHOT_EXT
        self._wal.release()  # it would append to the replaced file
        replaced = False
        try:
            self.storage.optimize()
            try:
                f = open(tmp, "wb")
            except FileNotFoundError:  # a new fragment's first write
                os.makedirs(os.path.dirname(tmp), exist_ok=True)
                f = open(tmp, "wb")
            with f:
                self.storage.write_snapshot(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            replaced = True
            self._wal.ready = True
        finally:
            if not replaced:
                try:
                    os.remove(tmp)
                except FileNotFoundError:
                    pass
            self.storage.op_writer = None if self.closed else self._wal
        self.op_n = 0
        self.storage.op_n = 0
        self._volatile = False  # persisted: the WAL is attached again
        self.volatile_mutations = 0
