"""64-bit roaring bitmap, numpy-backed, Pilosa file-format compatible.

Trimmed copy of pilosa_tpu/storage/roaring.py: the numpy path only (the
reference's optional C++ accelerator in pilosa_tpu/native is left out),
eager parsing from bytes (no mmap-lazy containers), three container
stores (a plain dict, the B+Tree of storage/containers.py, picked with
`store=` or PILOSA_TPU_CONTAINER_STORE as in the JAX package (:550-560),
and the frozen array-backed store of storage/frozen.py for bulk loads),
set algebra whose results inherit their source's store kind (:866-908),
and what the fragment layer needs. A file of at least
frozen.FROZEN_PARSE_MIN containers parses into a frozen store (the JAX
package takes that branch on its lazy mmap opens; the port parses
eagerly, so it takes it by size alone).

The WAL append is the failpoint `storage.wal.append` (:659-698): a torn
append is rewound off the log and raises, so it is never acknowledged;
one that cannot be rewound poisons the WAL, and every later append
refuses until a snapshot rewrites the file.

The on-disk format is the reference's, byte for byte compatible:
  bytes 0-1  magic 12348        (u16 LE)
  bytes 2-3  storage version 0  (u16 LE)
  bytes 4-7  container count    (u32 LE)
  per container: key u64 | container type u16 | cardinality-1 u16   (12 B)
  per container: absolute file offset u32                            (4 B)
  container payloads: array = n x u16; bitmap = 1024 x u64;
                      run = count u16 then count x (start u16, last u16)
  snapshot trailer (files only): "PTS1" | section length u64 | blake2b-16
  op-log: CRC32-framed records [0xFA | version | type | value u64 | crc32]
          (legacy 13-byte fnv1a32 records still parse), replayed on open.

from_bytes also reads the official 32-bit RoaringFormatSpec (cookies
12346 and 12347; pilosa_tpu/storage/roaring.py:1211-1290), the payload
an import-roaring client sends: the run-flag bitmap, the offset header
(always without runs; with runs when there are at least 4 containers),
and runs as (start, length) where Pilosa's are (start, last).
"""

from __future__ import annotations

import hashlib
import io
import os
import struct
import zlib
from typing import Iterator, Optional

import numpy as np

from pilosa_tpu_torch.constants import (
    ARRAY_MAX_SIZE,
    CONTAINER_BITS,
    MAGIC_NUMBER,
    STORAGE_VERSION,
)
from pilosa_tpu_torch.storage.containers import (
    make_container_store,
    resolve_store_kind,
)
from pilosa_tpu_torch.utils import failpoints

BITMAP_WORDS = CONTAINER_BITS // 64  # 1024 x uint64
HEADER_BASE_SIZE = 8

TYPE_ARRAY = 1
TYPE_BITMAP = 2
TYPE_RUN = 3

OP_ADD = 0
OP_REMOVE = 1
OP_SIZE = 13

OP_MAGIC = 0xFA
OP_VERSION = 1
FRAMED_OP_SIZE = 15  # magic u8 | version u8 | type u8 | value u64 | crc32 u32

# at most this many values, add_many / remove_many / contains_many take a
# plain Python path (the ingest path's few values per fragment and batch)
SMALL_BATCH = 64

SNAP_TRAILER_MAGIC = b"PTS1"
SNAP_TRAILER_SIZE = 4 + 8 + 16


class CorruptionError(ValueError):
    """Snapshot-section integrity failure (trailer digest mismatch), or
    mid-log WAL damage with valid records after it."""


# -- CRC-framed WAL records (pilosa_tpu/storage/roaring.py:92-147) ----------


def frame_op(typ: int, value: int) -> bytes:
    """One CRC32-framed WAL record."""
    body = struct.pack("<BBBQ", OP_MAGIC, OP_VERSION, typ, value)
    return body + struct.pack("<I", zlib.crc32(body))


class _HashingWriter:
    """Pass-through writer keeping a running blake2b-16 and byte count."""

    __slots__ = ("w", "h", "n")

    def __init__(self, w):
        self.w = w
        self.h = hashlib.blake2b(digest_size=16)
        self.n = 0

    def write(self, data) -> int:
        self.w.write(data)
        self.h.update(data)
        n = memoryview(data).nbytes
        self.n += n
        return n


def _valid_record_after(data, pos: int, n: int) -> bool:
    """True if any offset past `pos` parses as a checksum-valid record —
    tells a torn tail (safe to truncate) from mid-log damage (acked records
    follow it; truncation would lose them)."""
    for off in range(pos + 1, n - FRAMED_OP_SIZE + 1):
        lead = data[off]
        if lead == OP_MAGIC:
            _m, ver, typ, _value, chk = struct.unpack_from("<BBBQI", data, off)
            if ver == OP_VERSION and typ in (OP_ADD, OP_REMOVE) \
                    and chk == zlib.crc32(bytes(data[off:off + 11])):
                return True
        elif lead in (OP_ADD, OP_REMOVE) and off + OP_SIZE <= n:
            (chk,) = struct.unpack_from("<I", data, off + 9)
            if chk == fnv1a32(bytes(data[off:off + 9])):
                return True
    return False


def fnv1a32(data: bytes) -> int:
    h = 2166136261
    for b in data:
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


# -- container encodings (numpy) ---------------------------------------------


def sorted_unique(a: np.ndarray) -> np.ndarray:
    """np.unique by sort and neighbour mask (the bulk paths' hot dedup)."""
    a = np.sort(np.asarray(a), kind="stable")
    if a.size < 2:
        return a
    keep = np.empty(a.size, dtype=bool)
    keep[0] = True
    np.not_equal(a[1:], a[:-1], out=keep[1:])
    return a[keep]


def _array_to_words(vals: np.ndarray) -> np.ndarray:
    """Sorted uint16 members -> uint64[1024] little-endian bitmap."""
    bits = np.zeros(CONTAINER_BITS, dtype=np.uint8)
    bits[np.asarray(vals, dtype=np.uint16)] = 1
    return np.packbits(bits, bitorder="little").view("<u8").copy()


def _words_to_array(words: np.ndarray) -> np.ndarray:
    """uint64[1024] bitmap -> sorted uint16 members."""
    words = np.ascontiguousarray(words, dtype=np.uint64)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.uint16)


def _runs_to_words(iv: np.ndarray) -> np.ndarray:
    """[nruns, 2] (start, last) -> uint64[1024] bitmap."""
    bits = np.zeros(CONTAINER_BITS, dtype=np.uint8)
    for s, last in np.asarray(iv, dtype=np.int64):
        bits[s:last + 1] = 1
    return np.packbits(bits, bitorder="little").view("<u8").copy()


def _runs_to_values(iv: np.ndarray) -> np.ndarray:
    """[nruns, 2] (start, last) -> sorted uint16 members."""
    if iv.shape[0] == 0:
        return np.empty(0, dtype=np.uint16)
    return np.concatenate([np.arange(s, last + 1, dtype=np.uint16)
                           for s, last in iv.astype(np.int64)])


def container_contains_many(c: "Container", lows: np.ndarray) -> np.ndarray:
    """Vectorized membership of uint16 `lows` in one container, by kind
    (pilosa_tpu/storage/roaring.py:176)."""
    if c.kind == "array":
        idx = np.searchsorted(c.data, lows)
        idx_c = np.minimum(idx, c.data.size - 1)
        return (idx < c.data.size) & (c.data[idx_c] == lows)
    if c.kind == "run":
        i = np.searchsorted(c.data[:, 0], lows, side="right") - 1
        i_c = np.maximum(i, 0)
        return (i >= 0) & (lows <= c.data[i_c, 1])
    li = lows.astype(np.int64)
    w = c.data[li >> 6]
    return ((w >> (li.astype(np.uint64) & np.uint64(63)))
            & np.uint64(1)).astype(bool)


def _payload_size(code: int, card: int, buf, offset: int) -> int:
    """Byte length of a container payload without parsing it
    (pilosa_tpu/storage/roaring.py:527)."""
    if code == TYPE_ARRAY:
        return 2 * card
    if code == TYPE_BITMAP:
        return 8 * BITMAP_WORDS
    if code == TYPE_RUN:
        if offset + 2 > len(buf):
            raise ValueError("run container header out of bounds")
        (nruns,) = struct.unpack_from("<H", buf, offset)
        return 2 + 4 * nruns
    raise ValueError(f"unknown container type {code}")


def is_frozen_store(store) -> bool:
    """Whether a container store is the frozen array-backed one (the
    capability marker of storage/frozen.py)."""
    return getattr(store, "VECTORIZED_STORE", False)


class Container:
    """One 2^16-bit container: sorted uint16 array, uint64[1024] bitmap, or
    [nruns, 2] (start, last) run intervals."""

    __slots__ = ("kind", "data")

    def __init__(self, kind: str, data: np.ndarray):
        self.kind = kind  # "array" | "bitmap" | "run"
        self.data = data

    @classmethod
    def empty(cls) -> "Container":
        return cls("array", np.empty(0, dtype=np.uint16))

    @classmethod
    def from_values(cls, values: np.ndarray) -> "Container":
        """values: sorted unique uint16."""
        values = np.asarray(values, dtype=np.uint16)
        if values.size > ARRAY_MAX_SIZE:
            return cls("bitmap", _array_to_words(values))
        return cls("array", values)

    @property
    def n(self) -> int:
        if self.kind == "array":
            return int(self.data.size)
        if self.kind == "run":
            iv = self.data.astype(np.int64)
            return int(np.sum(iv[:, 1] - iv[:, 0] + 1)) if iv.size else 0
        return int(np.sum(np.bitwise_count(self.data)))

    def values(self) -> np.ndarray:
        if self.kind == "array":
            return self.data
        if self.kind == "run":
            return _runs_to_values(self.data)
        return _words_to_array(self.data)

    def words(self) -> np.ndarray:
        if self.kind == "bitmap":
            return self.data
        if self.kind == "run":
            return _runs_to_words(self.data)
        return _array_to_words(self.data)

    def contains(self, v: int) -> bool:
        if self.kind == "array":
            i = np.searchsorted(self.data, v)
            return bool(i < self.data.size and self.data[i] == v)
        if self.kind == "run":
            i = int(np.searchsorted(self.data[:, 0], v, side="right")) - 1
            return bool(i >= 0 and v <= int(self.data[i, 1]))
        return bool((int(self.data[v >> 6]) >> (v & 63)) & 1)

    def _normalize(self) -> "Container":
        """Re-pick array-vs-bitmap after mutation (runs come only from
        optimize())."""
        if self.kind == "bitmap" and self.n <= ARRAY_MAX_SIZE:
            return Container("array", _words_to_array(self.data))
        if self.kind == "array" and self.data.size > ARRAY_MAX_SIZE:
            return Container("bitmap", _array_to_words(self.data))
        return self

    def _runs(self) -> np.ndarray:
        """[nruns, 2] (start, last) intervals of the members."""
        if self.kind == "run":
            return self.data
        vals = self.values().astype(np.int64)
        if vals.size == 0:
            return np.empty((0, 2), dtype=np.uint16)
        breaks = np.flatnonzero(np.diff(vals) != 1)
        starts = np.concatenate(([0], breaks + 1))
        ends = np.concatenate((breaks, [vals.size - 1]))
        return np.stack([vals[starts], vals[ends]], axis=1).astype(np.uint16)

    def n_runs(self) -> int:
        """Number of runs, counted without materializing them."""
        if self.kind == "run":
            return int(self.data.shape[0])
        if self.kind == "array":
            v = self.data.astype(np.int32)
            return int(np.count_nonzero(np.diff(v) != 1)) + 1 if v.size else 0
        w = self.data
        carry = np.concatenate(([np.uint64(0)], w[:-1] >> np.uint64(63)))
        starts = w & ~((w << np.uint64(1)) | carry)  # first bit of each run
        return int(np.bitwise_count(starts).sum())

    def optimize(self) -> "Container":
        """The smallest of the three encodings (called on snapshot)."""
        sizes = {"array": 2 * self.n, "bitmap": 8 * BITMAP_WORDS,
                 "run": 2 + 4 * self.n_runs()}
        best = min(sizes, key=lambda k: (sizes[k], k))
        if best == self.kind:
            return self
        if best == "run":
            return Container("run", self._runs())
        if best == "array":
            return Container("array", self.values())
        return Container("bitmap", self.words())

    def add_many(self, vals: np.ndarray) -> "Container":
        vals = np.asarray(vals, dtype=np.uint16)
        if self.kind == "array":
            return Container.from_values(
                sorted_unique(np.concatenate([self.data, vals])))
        words = self.data.copy() if self.kind == "bitmap" else self.words()
        idx = vals.astype(np.int64)
        np.bitwise_or.at(words, idx >> 6,
                         np.uint64(1) << (idx & 63).astype(np.uint64))
        return Container("bitmap", words)._normalize()

    def remove_many(self, vals: np.ndarray) -> "Container":
        vals = np.asarray(vals, dtype=np.uint16)
        if self.kind == "array":
            return Container("array", self.data[~np.isin(self.data, vals)])
        words = self.data.copy() if self.kind == "bitmap" else self.words()
        idx = vals.astype(np.int64)
        np.bitwise_and.at(words, idx >> 6,
                          ~(np.uint64(1) << (idx & 63).astype(np.uint64)))
        return Container("bitmap", words)._normalize()

    def op(self, other: "Container", kind: str) -> "Container":
        """A new container of self <kind> other ("and", "or", "andnot",
        "xor"): two arrays by a sorted merge, anything else over the
        words (pilosa_tpu/storage/roaring.py:311, without its native
        run paths)."""
        if self.kind == "array" and other.kind == "array":
            a, b = self.data, other.data
            out = {"and": lambda: np.intersect1d(a, b, assume_unique=True),
                   "or": lambda: np.union1d(a, b),
                   "andnot": lambda: np.setdiff1d(a, b, assume_unique=True),
                   "xor": lambda: np.setxor1d(a, b, assume_unique=True),
                   }[kind]()
            return Container.from_values(out.astype(np.uint16))
        aw, bw = self.words(), other.words()
        out = {"and": aw & bw, "or": aw | bw, "andnot": aw & ~bw,
               "xor": aw ^ bw}[kind]
        return Container("bitmap", out)._normalize()

    def encode_current(self):
        """(type_code, payload bytes) in the current encoding."""
        if self.kind == "array":
            return TYPE_ARRAY, self.data.astype("<u2").tobytes()
        if self.kind == "run":
            return TYPE_RUN, struct.pack("<H", self.data.shape[0]) + \
                self.data.astype("<u2").tobytes()
        return TYPE_BITMAP, self.data.astype("<u8").tobytes()

    @classmethod
    def from_payload(cls, type_code: int, n: int,
                     buf: memoryview) -> tuple["Container", int]:
        """Parse one container payload -> (container, bytes consumed)."""
        def need(nbytes: int) -> None:
            if len(buf) < nbytes:
                raise ValueError(f"container payload truncated: need "
                                 f"{nbytes} bytes, have {len(buf)}")

        if type_code == TYPE_ARRAY:
            need(2 * n)
            arr = np.frombuffer(buf[:2 * n], dtype="<u2").astype(np.uint16)
            return cls("array", arr), 2 * n
        if type_code == TYPE_BITMAP:
            need(8 * BITMAP_WORDS)
            words = np.frombuffer(buf[:8 * BITMAP_WORDS], dtype="<u8").copy()
            return cls("bitmap", words)._normalize(), 8 * BITMAP_WORDS
        if type_code == TYPE_RUN:
            need(2)
            (nruns,) = struct.unpack_from("<H", buf, 0)
            need(2 + 4 * nruns)
            iv = np.frombuffer(buf[2:2 + 4 * nruns], dtype="<u2") \
                .reshape(nruns, 2).copy()
            return cls("run", iv), 2 + 4 * nruns
        raise ValueError(f"unknown container type {type_code}")


class Bitmap:
    """64-bit roaring bitmap: {key = position >> 16} -> Container.

    `containers` is a dict or a BTreeContainers (`store` "dict" or
    "btree"; None: PILOSA_TPU_CONTAINER_STORE, else "dict"), or a
    FrozenContainers after `frozen()` or the frozen parse; all serve the
    mapping protocol. `op_writer` is the WAL hook (the fragment's
    WalAppender, which fsyncs when asked): when set, single-value
    add/remove append one framed op record each."""

    def __init__(self, values=None, store: Optional[str] = None):
        self.store_kind = resolve_store_kind(store)
        self.containers = make_container_store(self.store_kind)
        self._dirty: set[int] = set()  # keys changed since optimize()
        self.op_writer = None
        self.op_n = 0
        # WAL recovery report of from_bytes(recover_wal=True)
        self.wal_valid_end: Optional[int] = None
        self.wal_error: Optional[str] = None
        # a failed append could not be rewound off the log: the file ends
        # in garbage that recovery would truncate along with any record
        # appended after it, so appends refuse until a snapshot rewrites
        self.wal_poisoned = False
        if values is not None:
            self.add_many(np.asarray(values, dtype=np.uint64))

    @classmethod
    def frozen(cls, positions: np.ndarray,
               presorted: bool = False) -> "Bitmap":
        """Bulk-load constructor (pilosa_tpu/storage/roaring.py:737): the
        whole position set becomes a frozen array-backed store in numpy,
        with no per-container Python loop. presorted=True skips the dedup
        sort for callers whose positions are already sorted and unique.
        Later mutations go to the store's copy-on-write overlay."""
        from pilosa_tpu_torch.storage.frozen import FrozenContainers

        b = cls()
        positions = np.asarray(positions, dtype=np.uint64)
        if not presorted:
            positions = sorted_unique(positions)
        b.containers = FrozenContainers.from_positions(positions)
        return b

    # -- mutation -----------------------------------------------------------

    def _with_key(self, key: int) -> Container:
        c = self.containers.get(key)
        return Container.empty() if c is None else c

    def _store(self, key: int, c: Container) -> None:
        self._dirty.add(key)
        if c.n == 0:
            self.containers.pop(key, None)
        else:
            self.containers[key] = c

    def _chunks(self, values: np.ndarray):
        """(key, sorted lows) per container of the unique values."""
        values = np.asarray(values, dtype=np.uint64)
        if values.size <= SMALL_BATCH:
            # a write batch's few values per fragment: grouping in Python
            # costs less than the numpy calls below
            by_key: dict = {}
            for v in sorted(set(values.tolist())):
                by_key.setdefault(v >> 16, []).append(v & 0xFFFF)
            for key, lows in by_key.items():
                yield key, np.array(lows, dtype=np.uint16)
            return
        values = sorted_unique(values)
        if values.size == 0:
            return
        keys = (values >> np.uint64(16)).astype(np.int64)
        lows = (values & np.uint64(0xFFFF)).astype(np.uint16)
        bounds = np.flatnonzero(np.diff(keys)) + 1
        for ck, cl in zip(np.split(keys, bounds), np.split(lows, bounds)):
            yield int(ck[0]), cl

    def add_many(self, values: np.ndarray) -> None:
        """Bulk insert (no op-log; callers snapshot)."""
        if (not self.containers and np.size(values)
                and not is_frozen_store(self.containers)):
            self._fill(values)
            return
        for key, lows in self._chunks(values):
            self._store(key, self._with_key(key).add_many(lows))

    def reset(self, positions: np.ndarray) -> None:
        """Replace every container with the given sorted unique positions:
        a frozen store is rebuilt from them in numpy, a dict or B+Tree
        store refilled with optimally encoded containers (_fill). The
        op-log hook stays."""
        if is_frozen_store(self.containers):
            from pilosa_tpu_torch.storage.frozen import FrozenContainers

            self.containers = FrozenContainers.from_positions(positions)
            return
        self.containers = make_container_store(self.store_kind)
        self._dirty.clear()
        if np.size(positions):
            self._fill(positions)

    def _fill(self, values: np.ndarray) -> None:
        """add_many into an empty dict or B+Tree store: the containers are
        cut from the sorted positions in numpy and each is built in the
        encoding Container.optimize would pick (the smallest of array,
        bitmap and run, ties in that order), so none is left for
        optimize() to re-pick: the snapshot's bytes are the ones the
        per-container path writes, and a bulk load of many small
        fragments pays no per-container sort, merge or run count."""
        pos = sorted_unique(np.asarray(values, dtype=np.uint64))
        keys = (pos >> np.uint64(16)).astype(np.int64)
        lows = (pos & np.uint64(0xFFFF)).astype(np.uint16)
        first = np.empty(pos.size, dtype=bool)
        first[0] = True
        np.not_equal(keys[1:], keys[:-1], out=first[1:])
        starts = np.flatnonzero(first)
        ends = np.append(starts[1:], pos.size)
        run_start = first.copy()
        run_start[1:] |= (pos[1:] - pos[:-1]) != 1
        nruns = np.add.reduceat(run_start.astype(np.int64), starts)
        arr_size = 2 * (ends - starts)
        run_size = 2 + 4 * nruns
        bmp_size = 8 * BITMAP_WORDS
        kinds = np.where((arr_size <= bmp_size) & (arr_size <= run_size), 0,
                         np.where(bmp_size <= run_size, 1, 2))
        run_idx = np.flatnonzero(run_start)
        store = self.containers
        for key, a, b, kind in zip(keys[starts].tolist(), starts.tolist(),
                                   ends.tolist(), kinds.tolist()):
            vals = lows[a:b]
            if kind == 0:
                c = Container("array", vals)
            elif kind == 1:
                c = Container("bitmap", _array_to_words(vals))
            else:
                r = run_idx[np.searchsorted(run_idx, a):
                            np.searchsorted(run_idx, b)]
                lasts = np.append(r[1:], b) - 1
                c = Container("run", np.stack([lows[r], lows[lasts]],
                                              axis=1))
            store[key] = c

    def remove_many(self, values: np.ndarray) -> None:
        for key, lows in self._chunks(values):
            if key in self.containers:
                self._store(key, self.containers[key].remove_many(lows))

    def remove_range(self, start: int, stop: int) -> np.ndarray:
        """Remove every position in the container-aligned [start, stop),
        dropping whole containers (no per-value membership test); returns
        the positions removed, sorted."""
        vals = self.slice(start, stop)
        for key in self._keys_in(start, stop):
            self._store(key, Container.empty())
        return vals

    def add(self, value: int) -> bool:
        """Single add, logged to the op-log when attached."""
        changed = not self.contains(value)
        if changed:
            key, low = int(value) >> 16, int(value) & 0xFFFF
            self._store(key, self._with_key(key).add_many(
                np.array([low], dtype=np.uint16)))
        self._write_op(OP_ADD, value)
        return changed

    def remove(self, value: int) -> bool:
        changed = self.contains(value)
        if changed:
            key, low = int(value) >> 16, int(value) & 0xFFFF
            self._store(key, self.containers[key].remove_many(
                np.array([low], dtype=np.uint16)))
        self._write_op(OP_REMOVE, value)
        return changed

    def _check_wal_clean(self) -> None:
        if self.wal_poisoned:
            raise OSError(
                "WAL poisoned by an earlier failed append (un-rewindable "
                "torn record); snapshot the fragment to restore durability")

    def _rewind_torn_write(self, n_written: int, torn: Exception) -> None:
        """Cut a torn record's bytes off the log and raise (:644-657):
        recovery truncates at the first bad record, so a record
        acknowledged after the garbage would be lost at the next open. A
        crash between the write and the rewind leaves the torn tail,
        which recovery truncates with nothing acknowledged after it. If
        the rewind fails too, the WAL is poisoned."""
        try:
            self.op_writer.rewind(n_written)
        except (OSError, ValueError):
            self.wal_poisoned = True
        raise torn

    def _write_op(self, typ: int, value: int) -> None:
        # the poisoned check first: a poisoned WAL must refuse even with
        # no writer attached
        self._check_wal_clean()
        if self.op_writer is None:
            return
        rec, torn = failpoints.corrupt_write("storage.wal.append",
                                             frame_op(typ, int(value)))
        self.op_writer.write(rec)
        if torn is not None:
            self._rewind_torn_write(len(rec), torn)
        self.op_n += 1

    def append_ops(self, adds: np.ndarray, removes: np.ndarray) -> None:
        """WAL-append a batch's net deltas as OP_ADD / OP_REMOVE records in
        ONE write (pilosa_tpu/storage/roaring.py:677). The caller has
        already applied them; these are redo records for replay. A torn
        buffer is rewound whole: none of the delta is acknowledged."""
        self._check_wal_clean()
        if self.op_writer is None:
            return
        parts = [frame_op(typ, v)
                 for typ, vals in ((OP_ADD, adds), (OP_REMOVE, removes))
                 for v in np.asarray(vals, dtype=np.uint64).tolist()]
        if not parts:
            return
        buf, torn = failpoints.corrupt_write("storage.wal.append",
                                             b"".join(parts))
        self.op_writer.write(buf)
        if torn is not None:
            self._rewind_torn_write(len(buf), torn)
        self.op_n += len(parts)

    # -- queries ------------------------------------------------------------

    def contains_many(self, values: np.ndarray) -> np.ndarray:
        """Vectorized membership: a bool per value, probed container by
        container (pilosa_tpu/storage/roaring.py:705); a frozen store
        answers from its flat arrays in one pass."""
        values = np.asarray(values, dtype=np.uint64)
        if is_frozen_store(self.containers):
            return self.containers.contains_positions(values)
        if values.size <= SMALL_BATCH:
            return np.array([self.contains(v) for v in values.tolist()],
                            dtype=bool)
        out = np.zeros(values.size, dtype=bool)
        keys = (values >> np.uint64(16)).astype(np.int64)
        lows = (values & np.uint64(0xFFFF)).astype(np.uint16)
        for key in np.unique(keys).tolist():
            c = self.containers.get(key)
            if c is None or c.n == 0:
                continue
            m = keys == key
            out[m] = container_contains_many(c, lows[m])
        return out

    def contains(self, value: int) -> bool:
        c = self.containers.get(int(value) >> 16)
        return c is not None and c.contains(int(value) & 0xFFFF)

    def count(self) -> int:
        """Set bits in all (pilosa_tpu/storage/roaring.py:758)."""
        if is_frozen_store(self.containers):
            return self.containers.total_count()
        return sum(c.n for c in list(self.containers.values()))

    def positions(self) -> np.ndarray:
        """All set positions as one sorted uint64 array (:728); a frozen
        store answers from its flat arrays."""
        if is_frozen_store(self.containers):
            return self.containers.all_positions()
        return self.slice(0)

    def _keys_in(self, start: int, stop: int) -> list[int]:
        if stop <= start:
            return []
        lo, hi = start >> 16, (stop - 1) >> 16
        if is_frozen_store(self.containers):
            return list(self.containers.irange(lo, hi))
        if hi - lo < len(self.containers):  # a row: probe its 16 keys
            return [k for k in range(lo, hi + 1) if k in self.containers]
        if hasattr(self.containers, "irange"):  # the B+Tree's range walk
            return list(self.containers.irange(lo, hi))
        return sorted(k for k in self.containers if lo <= k <= hi)

    def slice(self, start: int = 0, stop: Optional[int] = None) -> np.ndarray:
        """All set positions in [start, stop) as sorted uint64."""
        stop = stop if stop is not None else (1 << 64)
        if stop <= start:
            return np.empty(0, dtype=np.uint64)
        last = np.uint64(stop - 1)
        out = []
        for key in self._keys_in(start, stop):
            vals = self.containers[key].values().astype(np.uint64) \
                + np.uint64(key << 16)
            out.append(vals[(vals >= np.uint64(start)) & (vals <= last)])
        if not out:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(out)

    def to_dense_words(self, start: int, stop: int,
                       out: Optional[np.ndarray] = None) -> np.ndarray:
        """Dense little-endian uint32 bitvector of positions [start, stop);
        start and stop must be container-aligned. `out`, where given, is
        a zeroed uint32 array of that length, filled in place."""
        if start % CONTAINER_BITS or stop % CONTAINER_BITS:
            raise ValueError("range must be container-aligned")
        if out is None:
            out = np.zeros((stop - start) // 32, dtype=np.uint32)
        arrays = []  # array containers' members, set in one scatter
        get = self.containers.get
        for key in range(start >> 16, stop >> 16):
            c = get(key)
            if c is None:
                continue
            base = (key << 16) - start
            if c.kind == "array":
                if c.data.size:
                    arrays.append(c.data.astype(np.int64) + base)
                continue
            woff = base // 32
            out[woff:woff + CONTAINER_BITS // 32] = c.words().view("<u4")
        if arrays:
            pos = arrays[0] if len(arrays) == 1 else np.concatenate(arrays)
            # members are unique, so adding each bit into its word is an OR
            np.add.at(out, pos >> 5,
                      np.left_shift(np.uint32(1), (pos & 31).astype(np.uint32)))
        return out

    def min(self) -> Optional[int]:
        """The smallest set position, or None (:801)."""
        keys = self._sorted_keys()
        if not keys:
            return None
        return (keys[0] << 16) | int(self.containers[keys[0]].values()[0])

    def max(self) -> Optional[int]:
        """The largest set position, or None (:809)."""
        keys = self._sorted_keys()
        if not keys:
            return None
        return (keys[-1] << 16) | int(self.containers[keys[-1]].values()[-1])

    def _sorted_keys(self) -> list[int]:
        store = self.containers
        if hasattr(store, "irange") and not is_frozen_store(store):
            return list(store)  # the B+Tree iterates in key order
        return sorted(k for k, c in store.items() if c.n)

    def any(self) -> bool:
        return bool(self.containers)

    def __iter__(self) -> Iterator[int]:
        for key in self._sorted_keys():
            base = key << 16
            for v in self.containers[key].values().tolist():
                yield base | v

    # -- set algebra (:866-908): results inherit the store kind ------------

    def _binary(self, other: "Bitmap", kind: str) -> "Bitmap":
        out = Bitmap(store=self.store_kind)
        if kind == "and":
            keys = set(self.containers) & set(other.containers)
        elif kind == "andnot":
            keys = set(self.containers)
        else:
            keys = set(self.containers) | set(other.containers)
        for key in sorted(keys):
            a = self.containers.get(key)
            b = other.containers.get(key)
            if a is None:
                res = (Container(b.kind, b.data.copy())
                       if kind in ("or", "xor") else None)
            elif b is None:
                res = (Container(a.kind, a.data.copy())
                       if kind in ("or", "xor", "andnot") else None)
            else:
                res = a.op(b, kind)
            if res is not None and res.n:
                out.containers[key] = res
        return out

    def intersect(self, other: "Bitmap") -> "Bitmap":
        return self._binary(other, "and")

    def union(self, other: "Bitmap") -> "Bitmap":
        return self._binary(other, "or")

    def difference(self, other: "Bitmap") -> "Bitmap":
        return self._binary(other, "andnot")

    def xor(self, other: "Bitmap") -> "Bitmap":
        return self._binary(other, "xor")

    def intersection_count(self, other: "Bitmap") -> int:
        return sum(self.containers[k].op(other.containers[k], "and").n
                   for k in set(self.containers) & set(other.containers))

    def check(self) -> None:
        """Consistency check of every container (Bitmap.Check, :1299):
        no empty container, arrays strictly ascending, runs ordered,
        disjoint and not adjacent. Raises ValueError."""
        for key, c in self.containers.items():
            if c.n == 0:
                raise ValueError(f"empty container at key {key}")
            if c.kind == "array":
                if c.data.size and not np.all(
                        np.diff(c.data.astype(np.int64)) > 0):
                    raise ValueError(
                        f"unsorted/duplicate array container at key {key}")
            elif c.kind == "run":
                iv = c.data.astype(np.int64)
                if iv.size:
                    if not np.all(iv[:, 1] >= iv[:, 0]):
                        raise ValueError(
                            f"inverted run in container at key {key}")
                    if not np.all(iv[1:, 0] > iv[:-1, 1] + 1):
                        raise ValueError(
                            "unsorted/overlapping/adjacent runs at key "
                            f"{key}")

    # -- serialization ------------------------------------------------------

    def write_to(self, w) -> int:
        """Serialize in Pilosa roaring format (no op-log, no trailer),
        each container in its current encoding; a frozen store writes
        itself from its arrays (write_pilosa, :975)."""
        if is_frozen_store(self.containers):
            return self.containers.write_pilosa(w)
        keys = sorted(k for k, c in self.containers.items() if c.n > 0)
        encs = []
        for k in keys:
            c = self.containers[k]
            code, payload = c.encode_current()
            encs.append((k, code, c.n, payload))
        header = struct.pack("<HHI", MAGIC_NUMBER, STORAGE_VERSION, len(keys))
        desc = b"".join(struct.pack("<QHH", k, code, n - 1)
                        for k, code, n, _ in encs)
        offset = HEADER_BASE_SIZE + len(keys) * 16
        offsets = []
        for *_, payload in encs:
            offsets.append(struct.pack("<I", offset))
            offset += len(payload)
        data = header + desc + b"".join(offsets) + b"".join(p for *_, p in encs)
        w.write(data)
        return len(data)

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        self.write_to(buf)
        return buf.getvalue()

    def write_snapshot(self, w) -> int:
        """write_to + the blake2b integrity trailer (durable files)."""
        hw = _HashingWriter(w)
        self.write_to(hw)
        w.write(SNAP_TRAILER_MAGIC + struct.pack("<Q", hw.n) + hw.h.digest())
        return hw.n + SNAP_TRAILER_SIZE

    # the official format's cookies: 12347 with runs, 12346 without
    _SERIAL_COOKIE = 12347
    _SERIAL_COOKIE_NO_RUN = 12346

    @classmethod
    def _from_official_bytes(cls, data: bytes) -> "Bitmap":
        """The official 32-bit RoaringFormatSpec: a cookie, the container
        descriptors (key u16, cardinality-1 u16), offsets, payloads."""
        if len(data) < 8:
            raise ValueError("buffer too small")
        (cookie,) = struct.unpack_from("<I", data, 0)
        pos = 4
        run_flags = None
        if cookie == cls._SERIAL_COOKIE_NO_RUN:
            (size,) = struct.unpack_from("<I", data, pos)
            pos += 4
        elif cookie & 0xFFFF == cls._SERIAL_COOKIE:
            size = (cookie >> 16) + 1
            nbytes = (size + 7) // 8
            run_flags = data[pos:pos + nbytes]
            pos += nbytes
        else:
            raise ValueError("did not find expected serialCookie in header")
        if size > (1 << 16):
            raise ValueError("more than 2^16 containers is impossible")
        if pos + 4 * size > len(data):
            raise ValueError("container descriptors overrun the buffer")
        desc = np.frombuffer(data, dtype="<u2", count=2 * size,
                             offset=pos).reshape(size, 2).astype(np.int64)
        pos += 4 * size
        keys, cards = desc[:, 0], desc[:, 1] + 1
        runs = np.zeros(size, dtype=bool)
        if run_flags is not None:
            bits = np.unpackbits(np.frombuffer(run_flags, dtype=np.uint8),
                                 bitorder="little")
            runs = bits[:size].astype(bool)
        b = cls()
        mv = memoryview(data)
        if run_flags is None or size >= 4:
            # the offset header: always without runs, and with runs from
            # 4 containers on (the spec's NO_OFFSET_THRESHOLD)
            if pos + 4 * size > len(data):
                raise ValueError("offset header overruns the buffer")
            offsets = np.frombuffer(data, dtype="<u4", count=size,
                                    offset=pos).astype(np.int64)
            pos += 4 * size
        else:
            offsets = None
        for i in range(size):
            if offsets is not None:
                pos = int(offsets[i])
                if pos >= len(data):
                    raise ValueError(f"offset out of bounds: off={pos}")
            card = int(cards[i])
            if runs[i]:
                if pos + 2 > len(data):
                    raise ValueError("run container truncated")
                (nruns,) = struct.unpack_from("<H", data, pos)
                if pos + 2 + 4 * nruns > len(data):
                    raise ValueError("run container truncated")
                iv = np.frombuffer(data, dtype="<u2", count=2 * nruns,
                                   offset=pos + 2).reshape(nruns, 2)
                iv = iv.astype(np.int64)
                c = Container("run", np.stack(
                    [iv[:, 0], iv[:, 0] + iv[:, 1]], axis=1)
                    .astype(np.uint16))
                pos += 2 + 4 * nruns
            else:
                kind = TYPE_ARRAY if card <= ARRAY_MAX_SIZE else TYPE_BITMAP
                c, consumed = Container.from_payload(kind, card, mv[pos:])
                pos += consumed
            b._store(int(keys[i]), c)
        return b

    @classmethod
    def from_bytes(cls, data, recover_wal: bool = False) -> "Bitmap":
        """Parse the Pilosa format (containers, snapshot trailer check,
        then op-log replay) or the official format. recover_wal=True stops replay at a torn tail
        (wal_error / wal_valid_end say where) instead of raising; mid-log
        damage with valid records after it raises CorruptionError."""
        if len(data) < HEADER_BASE_SIZE:
            raise ValueError("data too small")
        magic, version, key_n = struct.unpack_from("<HHI", data, 0)
        if magic != MAGIC_NUMBER:
            return cls._from_official_bytes(bytes(data))
        if version != STORAGE_VERSION:
            raise ValueError(f"wrong roaring version, file is v{version}")
        b = cls()
        mv = memoryview(data)
        desc_off = HEADER_BASE_SIZE
        off_off = desc_off + key_n * 12
        ops_offset = off_off + key_n * 4
        if ops_offset > len(data):
            raise ValueError(f"header overruns buffer: {key_n} containers "
                             f"need {ops_offset} bytes, have {len(data)}")
        from pilosa_tpu_torch.storage import frozen

        if key_n >= frozen.FROZEN_PARSE_MIN:
            # vectorized parse into the frozen store (:1052-1064): the
            # array payloads stay views of `data`, which they keep alive
            b.containers, ops_offset = frozen.parse_pilosa_frozen(
                data, key_n, desc_off, off_off)
            return cls._replay_ops(b, data, ops_offset, recover=recover_wal)
        for i in range(key_n):
            key, code, n_minus_1 = struct.unpack_from("<QHH", data,
                                                      desc_off + i * 12)
            (offset,) = struct.unpack_from("<I", data, off_off + i * 4)
            if offset >= len(data):
                raise ValueError(f"offset out of bounds: off={offset}, "
                                 f"len={len(data)}")
            c, consumed = Container.from_payload(code, n_minus_1 + 1,
                                                 mv[offset:])
            b._store(int(key), c)
            ops_offset = offset + consumed
        return cls._replay_ops(b, data, ops_offset, recover=recover_wal)

    @staticmethod
    def _verify_trailer(data, ops_offset: int) -> int:
        """Verify the snapshot trailer at ops_offset, if present; returns
        where the op records start."""
        n = len(data)
        if n - ops_offset < SNAP_TRAILER_SIZE \
                or bytes(data[ops_offset:ops_offset + 4]) != SNAP_TRAILER_MAGIC:
            return ops_offset
        (body_len,) = struct.unpack_from("<Q", data, ops_offset + 4)
        digest = bytes(data[ops_offset + 12:ops_offset + 28])
        if body_len != ops_offset:
            raise CorruptionError(
                f"snapshot trailer length mismatch: trailer says {body_len} "
                f"bytes, container section is {ops_offset}")
        actual = hashlib.blake2b(memoryview(data)[:ops_offset],
                                 digest_size=16).digest()
        if actual != digest:
            raise CorruptionError("snapshot integrity check failed: blake2b "
                                  f"digest mismatch over {ops_offset} bytes")
        return ops_offset + SNAP_TRAILER_SIZE

    @classmethod
    def _replay_ops(cls, b: "Bitmap", data, ops_offset: int,
                    recover: bool = False) -> "Bitmap":
        """Replay framed (CRC32) and legacy (fnv1a32) op records in order."""
        pos = cls._verify_trailer(data, ops_offset)
        n = len(data)
        ops_t: list[int] = []
        ops_v: list[int] = []
        err = None
        while pos < n:
            lead = data[pos]
            if lead == OP_MAGIC:
                if pos + FRAMED_OP_SIZE > n:
                    err = f"op data out of bounds: len={n - pos}"
                    break
                _m, ver, typ, value, chk = struct.unpack_from("<BBBQI",
                                                              data, pos)
                if ver != OP_VERSION:
                    err = f"unknown op record version: {ver}"
                    break
                if chk != zlib.crc32(bytes(data[pos:pos + 11])):
                    err = "checksum mismatch"
                    break
                if typ not in (OP_ADD, OP_REMOVE):
                    err = f"invalid op type: {typ}"
                    break
                size = FRAMED_OP_SIZE
            elif lead in (OP_ADD, OP_REMOVE):
                if pos + OP_SIZE > n:
                    err = f"op data out of bounds: len={n - pos}"
                    break
                body = bytes(data[pos:pos + 9])
                (chk,) = struct.unpack_from("<I", data, pos + 9)
                if chk != fnv1a32(body):
                    err = "checksum mismatch"
                    break
                typ, value = struct.unpack("<BQ", body)
                size = OP_SIZE
            else:
                err = f"invalid op type: {lead}"
                break
            ops_t.append(typ)
            ops_v.append(value)
            pos += size
        if err is not None and not recover:
            raise ValueError(err)
        if err is not None and _valid_record_after(data, pos, n):
            raise CorruptionError(
                f"op log corrupt mid-stream at offset {pos} ({err}) with "
                "valid records after the damage")
        if ops_t:
            types = np.asarray(ops_t, dtype=np.uint8)
            values = np.asarray(ops_v, dtype=np.uint64)
            bounds = np.flatnonzero(np.diff(types)) + 1
            for t_run, v_run in zip(np.split(types, bounds),
                                    np.split(values, bounds)):
                if t_run[0] == OP_ADD:
                    b.add_many(v_run)
                else:
                    b.remove_many(v_run)
            b.op_n += len(ops_t)
        b.wal_valid_end = pos
        b.wal_error = err
        return b

    def optimize(self) -> None:
        """Re-pick the encoding (runs where smallest) of every container
        changed since the last call; the others are already optimal. A
        frozen store picks encodings as it writes itself (:1284)."""
        if is_frozen_store(self.containers):
            self._dirty.clear()
            return
        for key in self._dirty:
            c = self.containers.get(key)
            if c is not None:
                self.containers[key] = c.optimize()
        self._dirty.clear()
