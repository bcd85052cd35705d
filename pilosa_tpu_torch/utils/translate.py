"""Key translation: string keys <-> uint64 ids.

Trimmed copy of pilosa_tpu/utils/translate.py: an append-only binary log
is the durable record of every key minted, and a sqlite sidecar
(`<log>.idx`) derived from it serves lookups, with a bounded LRU of hot
keys in front, so a corpus of many millions of keys is not held in
Python dicts. The index records the log offset it has absorbed
(`meta.log_pos`) and an open replays only the log's tail past it.

The log's bytes and the sqlite schema (`kv`, `kv_rev`, `meta.log_pos`)
are the JAX package's, so either package opens a `.keys` log and its
`.keys.idx` sidecar that the other wrote. Ids are minted per scope
((kind, index, field)) from 1 upwards, in the order keys are first seen.

Record format (little-endian):
  kind u8 (0=column, 1=row) | index_len u16 | index | field_len u16 | field |
  key_len u16 | key | id u64

The sidecar is opened with the JAX package's pragmas, journal_mode=WAL
and synchronous=OFF (the log is the durable record), and two of the
port's own, which leave the files as the JAX package reads them: a 256
MiB page cache (cache_size) and locking_mode=EXCLUSIVE, under which
WAL keeps its index in this process's memory instead of a shared
`-shm` mapping and takes no file lock per statement (the holder's flock
already makes the server the data dir's only user). On the card
machine's 9p root (`scripts/fs_probe.py`; PERF.md) a lookup among
1,000,000 keys took 9.10 us a key in IN queries and 18.96 us alone with
the JAX pragmas, 3.06 and 5.63 us with these. Whatever sqlite refuses
raises: the index never drops to an in-memory copy.

Left out: the cluster's replication (read-only replicas, log tailing,
ensure_mapping, apply_log), which waits for the port's cluster.
"""

from __future__ import annotations

import os
import sqlite3
import struct
import threading
from collections import OrderedDict
from typing import Iterator, Optional

KIND_COLUMN = 0
KIND_ROW = 1

# hot keys kept per direction (forward and reverse) in front of sqlite
CACHE_MAX = 1 << 18
# parameters of one batched lookup (sqlite's historical floor is 999)
SQL_VARS = 900
# the sqlite index's page cache, KiB (sqlite's default is 2,000 KiB)
PAGE_CACHE_KIB = 256 * 1024


class _DictIndex:
    """A fully resident index: a store without a path."""

    def __init__(self):
        self._fwd: dict[tuple[int, str, str], dict[str, int]] = {}
        self._rev: dict[tuple[int, str, str], dict[int, str]] = {}

    def get(self, kind: int, index: str, field: str,
            key: str) -> Optional[int]:
        return self._fwd.get((kind, index, field), {}).get(key)

    def get_rev(self, kind: int, index: str, field: str,
                id_: int) -> Optional[str]:
        return self._rev.get((kind, index, field), {}).get(id_)

    def put(self, kind: int, index: str, field: str, key: str,
            id_: int) -> None:
        scope = (kind, index, field)
        self._fwd.setdefault(scope, {})[key] = id_
        self._rev.setdefault(scope, {})[id_] = key

    def get_many(self, kind: int, index: str, field: str,
                 keys: list) -> list:
        fwd = self._fwd.get((kind, index, field), {})
        return [fwd.get(k) for k in keys]

    def get_rev_many(self, kind: int, index: str, field: str,
                     ids: list) -> list:
        rev = self._rev.get((kind, index, field), {})
        return [rev.get(i) for i in ids]

    def put_many(self, kind: int, index: str, field: str,
                 items: list) -> None:
        scope = (kind, index, field)
        fwd = self._fwd.setdefault(scope, {})
        rev = self._rev.setdefault(scope, {})
        for key, id_ in items:
            fwd[key] = id_
            rev[id_] = key

    def next_id(self, kind: int, index: str, field: str) -> int:
        return len(self._fwd.get((kind, index, field), {})) + 1

    def items(self, kind: int, index: str,
              field: str) -> Iterator[tuple[str, int]]:
        return iter(self._fwd.get((kind, index, field), {}).items())

    def log_pos(self) -> int:
        return 0  # always replay the whole log

    def set_log_pos(self, pos: int) -> None:
        pass

    def commit(self) -> None:
        pass

    def rollback(self) -> None:
        pass

    def close(self) -> None:
        pass


class _SqliteIndex:
    """The index over the log in sqlite: B-tree pages read on demand, a
    bounded LRU for hot keys, `meta.log_pos` tying it to the log."""

    def __init__(self, path: str):
        self.path = path
        self._db = sqlite3.connect(path, check_same_thread=False)
        # the port's two pragmas (see the module docstring) come first:
        # EXCLUSIVE must hold before WAL is entered, so that the WAL index
        # lives in this process's memory, not in a shared -shm mapping
        self._db.execute(f"PRAGMA cache_size=-{PAGE_CACHE_KIB}")
        self._db.execute("PRAGMA locking_mode=EXCLUSIVE")
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=OFF")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS kv ("
            " kind INTEGER, idx TEXT, field TEXT, key TEXT, id INTEGER,"
            " PRIMARY KEY (kind, idx, field, key)) WITHOUT ROWID")
        self._db.execute(
            "CREATE UNIQUE INDEX IF NOT EXISTS kv_rev"
            " ON kv (kind, idx, field, id)")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS meta (k TEXT PRIMARY KEY, v INTEGER)")
        self._db.commit()
        self._fwd_cache: OrderedDict = OrderedDict()
        self._rev_cache: OrderedDict = OrderedDict()
        self._next: dict[tuple[int, str, str], int] = {}

    @staticmethod
    def _cache_put(cache: OrderedDict, k, v) -> None:
        cache[k] = v
        cache.move_to_end(k)
        if len(cache) > CACHE_MAX:
            cache.popitem(last=False)

    def get(self, kind: int, index: str, field: str,
            key: str) -> Optional[int]:
        ck = (kind, index, field, key)
        hit = self._fwd_cache.get(ck)
        if hit is not None:
            self._fwd_cache.move_to_end(ck)
            return hit
        row = self._db.execute(
            "SELECT id FROM kv WHERE kind=? AND idx=? AND field=? AND key=?",
            ck).fetchone()
        if row is None:
            return None
        self._cache_put(self._fwd_cache, ck, int(row[0]))
        return int(row[0])

    def get_rev(self, kind: int, index: str, field: str,
                id_: int) -> Optional[str]:
        ck = (kind, index, field, id_)
        hit = self._rev_cache.get(ck)
        if hit is not None:
            self._rev_cache.move_to_end(ck)
            return hit
        row = self._db.execute(
            "SELECT key FROM kv WHERE kind=? AND idx=? AND field=? AND id=?",
            ck).fetchone()
        if row is None:
            return None
        self._cache_put(self._rev_cache, ck, row[0])
        return row[0]

    def put(self, kind: int, index: str, field: str, key: str,
            id_: int) -> None:
        self._db.execute(
            "INSERT OR IGNORE INTO kv (kind, idx, field, key, id)"
            " VALUES (?, ?, ?, ?, ?)", (kind, index, field, key, id_))
        self._cache_put(self._fwd_cache, (kind, index, field, key), id_)
        self._cache_put(self._rev_cache, (kind, index, field, id_), key)
        scope = (kind, index, field)
        nxt = self._next.get(scope)
        if nxt is None or id_ >= nxt:
            self._next[scope] = id_ + 1

    def _select_in(self, col: str, want: str, scope: tuple,
                   values: list) -> dict:
        """{value: other column} of the rows of `scope` whose `col` is one
        of `values`, in queries of SQL_VARS parameters."""
        found: dict = {}
        for lo in range(0, len(values), SQL_VARS):
            part = values[lo:lo + SQL_VARS]
            q = (f"SELECT {col}, {want} FROM kv WHERE kind=? AND idx=?"
                 f" AND field=? AND {col} IN ("
                 + ",".join("?" * len(part)) + ")")
            found.update(self._db.execute(q, scope + tuple(part)))
        return found

    def get_many(self, kind: int, index: str, field: str,
                 keys: list) -> list:
        """get() of every key: the hot cache first, then one query per
        SQL_VARS of the misses."""
        cache = self._fwd_cache
        out = [cache.get((kind, index, field, k)) for k in keys]
        miss = list({k for k, v in zip(keys, out) if v is None})
        if miss:
            found = self._select_in("key", "id", (kind, index, field), miss)
            if found:
                out = [v if v is not None else found.get(k)
                       for k, v in zip(keys, out)]
        return out

    def get_rev_many(self, kind: int, index: str, field: str,
                     ids: list) -> list:
        cache = self._rev_cache
        out = [cache.get((kind, index, field, i)) for i in ids]
        miss = list({i for i, v in zip(ids, out) if v is None})
        if miss:
            found = self._select_in("id", "key", (kind, index, field), miss)
            if found:
                out = [v if v is not None else found.get(i)
                       for i, v in zip(ids, out)]
        return out

    def put_many(self, kind: int, index: str, field: str,
                 items: list) -> None:
        """put() of every (key, id), in one executemany; the last
        CACHE_MAX enter the hot caches."""
        self._db.executemany(
            "INSERT OR IGNORE INTO kv (kind, idx, field, key, id)"
            " VALUES (?, ?, ?, ?, ?)",
            [(kind, index, field, k, i) for k, i in items])
        tail = items[-CACHE_MAX:]
        for cache, pairs in (
                (self._fwd_cache, (((kind, index, field, k), i)
                                   for k, i in tail)),
                (self._rev_cache, (((kind, index, field, i), k)
                                   for k, i in tail))):
            cache.update(pairs)
            while len(cache) > CACHE_MAX:
                cache.popitem(last=False)
        if items:
            scope = (kind, index, field)
            top = max(i for _, i in items)
            nxt = self._next.get(scope)
            if nxt is None or top >= nxt:
                self._next[scope] = top + 1

    def next_id(self, kind: int, index: str, field: str) -> int:
        scope = (kind, index, field)
        nxt = self._next.get(scope)
        if nxt is None:
            row = self._db.execute(
                "SELECT MAX(id) FROM kv WHERE kind=? AND idx=? AND field=?",
                scope).fetchone()
            nxt = (int(row[0]) + 1) if row and row[0] is not None else 1
            self._next[scope] = nxt
        return nxt

    def items(self, kind: int, index: str,
              field: str) -> Iterator[tuple[str, int]]:
        cur = self._db.execute(
            "SELECT key, id FROM kv WHERE kind=? AND idx=? AND field=?",
            (kind, index, field))
        for key, id_ in cur:
            yield key, int(id_)

    def log_pos(self) -> int:
        row = self._db.execute(
            "SELECT v FROM meta WHERE k='log_pos'").fetchone()
        return int(row[0]) if row else 0

    def set_log_pos(self, pos: int) -> None:
        self._db.execute(
            "INSERT INTO meta (k, v) VALUES ('log_pos', ?)"
            " ON CONFLICT(k) DO UPDATE SET v=excluded.v", (pos,))

    def commit(self) -> None:
        self._db.commit()

    def rollback(self) -> None:
        """Drop the open transaction and the caches and next ids, which
        may hold puts the log never took."""
        self._db.rollback()
        self._fwd_cache.clear()
        self._rev_cache.clear()
        self._next.clear()

    def close(self) -> None:
        self._db.commit()
        self._db.close()


class TranslateStore:
    """`path` None: an in-memory store (an API without a server).
    Otherwise the log at `path` and its sqlite sidecar at
    `path + ".idx"`."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.RLock()
        self._file = None
        self._idx = None  # built in open()

    # -- lifecycle ----------------------------------------------------------

    def _new_index(self):
        if self.path:
            return _SqliteIndex(self.path + ".idx")
        return _DictIndex()

    def open(self) -> "TranslateStore":
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._idx = self._new_index()
        if self.path:
            start = self._idx.log_pos()
            size = (os.path.getsize(self.path)
                    if os.path.exists(self.path) else 0)
            if start > size:
                # the index is ahead of its log (a crash flushed the
                # sidecar first, or the log was replaced): the log is the
                # record, so the index is rebuilt from it
                self._idx.close()
                if isinstance(self._idx, _SqliteIndex):
                    for suffix in (".idx", ".idx-wal", ".idx-shm"):
                        try:
                            os.remove(self.path + suffix)
                        except FileNotFoundError:
                            pass
                self._idx = self._new_index()
                start = 0
            if start < size:
                with open(self.path, "rb") as f:
                    f.seek(start)
                    self._replay(f.read(), base_offset=start)
                self._idx.set_log_pos(size)
                self._idx.commit()
            self._file = open(self.path, "ab")
        return self

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._idx is not None:
            self._idx.close()
            self._idx = None

    def _replay(self, data: bytes, base_offset: int = 0) -> None:
        pos = 0
        n = len(data)
        while pos < n:
            try:
                kind, index, field, key, id_ = _unpack_record(data, pos)
            except (struct.error, ValueError):
                raise ValueError(
                    f"corrupt translate log at offset {base_offset + pos}")
            pos = _record_end(data, pos)
            self._idx.put(kind, index, field, key, id_)

    def _log(self, kind: int, index: str, field: str, items: list) -> None:
        """Append minted (key, id) records of one scope to the log, then
        commit the index; a failed write rolls the index back, so it never
        holds a mapping the log lacks."""
        if self._file is not None:
            try:
                self._file.write(_pack_records(kind, index, field, items))
                self._file.flush()
                self._idx.set_log_pos(self._file.tell())
            except Exception:
                self._idx.rollback()
                raise
        self._idx.commit()

    # -- translation --------------------------------------------------------

    def _translate_one(self, kind: int, index: str, field: str, key: str,
                       create: bool) -> Optional[int]:
        with self._lock:
            id_ = self._idx.get(kind, index, field, key)
            if id_ is None and create:
                id_ = self._idx.next_id(kind, index, field)
                self._idx.put(kind, index, field, key, id_)
                self._log(kind, index, field, [(key, id_)])
            return id_

    def _translate_batch(self, kind: int, index: str, field: str,
                         keys: list, create: bool) -> list:
        """Look up or mint a batch: the lookups batched, then one log
        write and one index commit for every key it mints (a keyed bulk
        import mints millions). New keys take ids in the order they first
        appear, as key-by-key minting gives them."""
        with self._lock:
            out = self._idx.get_many(kind, index, field, keys)
            if not create or all(v is not None for v in out):
                return out
            nxt = self._idx.next_id(kind, index, field)
            fresh: dict = {}
            minted = []
            for pos, k in enumerate(keys):
                if out[pos] is None:
                    id_ = fresh.get(k)
                    if id_ is None:
                        id_ = fresh[k] = nxt
                        nxt += 1
                        minted.append((k, id_))
                    out[pos] = id_
            self._idx.put_many(kind, index, field, minted)
            self._log(kind, index, field, minted)
            return out

    def translate_column(self, index: str, key: str,
                         create: bool = True) -> Optional[int]:
        return self._translate_one(KIND_COLUMN, index, "", key, create)

    def translate_columns(self, index: str, keys: list,
                          create: bool = True) -> list:
        return self._translate_batch(KIND_COLUMN, index, "", keys, create)

    def translate_column_to_string(self, index: str,
                                   id_: int) -> Optional[str]:
        with self._lock:
            return self._idx.get_rev(KIND_COLUMN, index, "", id_)

    def translate_columns_to_strings(self, index: str, ids) -> list:
        """Column keys of many ids, the lookups batched (None where an id
        has no key)."""
        with self._lock:
            return self._idx.get_rev_many(KIND_COLUMN, index, "",
                                          [int(i) for i in ids])

    def translate_row(self, index: str, field: str, key: str,
                      create: bool = True) -> Optional[int]:
        return self._translate_one(KIND_ROW, index, field, key, create)

    def translate_rows(self, index: str, field: str, keys: list,
                       create: bool = True) -> list:
        return self._translate_batch(KIND_ROW, index, field, keys, create)

    def translate_row_to_string(self, index: str, field: str,
                                id_: int) -> Optional[str]:
        with self._lock:
            return self._idx.get_rev(KIND_ROW, index, field, id_)

    def column_items(self, index: str) -> list[tuple[str, int]]:
        """Every (key, id) column mapping of an index (tests; walks the
        whole scope)."""
        with self._lock:
            return list(self._idx.items(KIND_COLUMN, index, ""))

    def log_size(self) -> int:
        if not self.path or not os.path.exists(self.path):
            return 0
        return os.path.getsize(self.path)


def _pack_record(kind: int, index: str, field: str, key: str,
                 id_: int) -> bytes:
    ib, fb, kb = index.encode(), field.encode(), key.encode()
    return struct.pack(f"<BH{len(ib)}sH{len(fb)}sH{len(kb)}sQ", kind,
                       len(ib), ib, len(fb), fb, len(kb), kb, id_)


def _pack_records(kind: int, index: str, field: str, items: list) -> bytes:
    """The records of (key, id) pairs of one scope, concatenated."""
    ib, fb = index.encode(), field.encode()
    head = struct.pack(f"<BH{len(ib)}sH{len(fb)}s", kind, len(ib), ib,
                       len(fb), fb)
    pack_len, pack_id = struct.Struct("<H").pack, struct.Struct("<Q").pack
    out = []
    for key, id_ in items:
        kb = key.encode()
        out += (head, pack_len(len(kb)), kb, pack_id(id_))
    return b"".join(out)


def _unpack_record(data: bytes, pos: int):
    (kind,) = struct.unpack_from("<B", data, pos)
    pos += 1
    out = []
    for _ in range(3):
        (ln,) = struct.unpack_from("<H", data, pos)
        pos += 2
        if pos + ln > len(data):
            raise ValueError("truncated record")
        out.append(data[pos:pos + ln].decode())
        pos += ln
    (id_,) = struct.unpack_from("<Q", data, pos)
    return kind, out[0], out[1], out[2], id_


def _record_end(data: bytes, pos: int) -> int:
    pos += 1
    for _ in range(3):
        (ln,) = struct.unpack_from("<H", data, pos)
        pos += 2 + ln
    return pos + 8
