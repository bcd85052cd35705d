"""Attribute storage: JSON attributes keyed by row or column id.

Copy of pilosa_tpu/utils/attrstore.py: one sqlite table `attrs (id
INTEGER PRIMARY KEY, data TEXT)` whose text is json.dumps(sort_keys=True),
so either package opens a store the other wrote. set_attrs merges into
what is stored, a None value deleting its key; blocks() and block_data()
are the content-hashed blocks of ATTR_BLOCK_SIZE ids a cluster diffs.

set_bulk_attrs merges a whole batch in one transaction (the JAX package
commits once per id: 2.5-3.3 ms a commit on the card machine's 9p file
system, `scripts/fs_probe.py`); what it stores is the same.
"""

from __future__ import annotations

import hashlib
import json
import os
import sqlite3
import threading
from typing import Iterable, Optional

ATTR_BLOCK_SIZE = 100


def merge_attrs(cur: dict, m: dict) -> dict:
    """`m` merged into a copy of `cur`: a None value deletes its key."""
    out = dict(cur)
    for k, v in m.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = v
    return out


class AttrStore:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._db: Optional[sqlite3.Connection] = None
        # one read-merge-write at a time (request threads share the store)
        self._mu = threading.Lock()

    def open(self) -> "AttrStore":
        target = self.path or ":memory:"
        if self.path:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._db = sqlite3.connect(target, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS attrs"
            " (id INTEGER PRIMARY KEY, data TEXT NOT NULL)")
        self._db.commit()
        return self

    def close(self) -> None:
        if self._db is not None:
            self._db.close()
            self._db = None

    def attrs(self, id_: int) -> dict:
        row = self._db.execute("SELECT data FROM attrs WHERE id = ?",
                               (id_,)).fetchone()
        return json.loads(row[0]) if row else {}

    def attrs_many(self, ids) -> dict:
        """{id: attrs} of the ids that have any, in one query per 500."""
        ids = [int(i) for i in ids]
        out: dict = {}
        for lo in range(0, len(ids), 500):
            part = ids[lo:lo + 500]
            q = ("SELECT id, data FROM attrs WHERE id IN ("
                 + ",".join("?" * len(part)) + ")")
            for id_, data in self._db.execute(q, part):
                out[int(id_)] = json.loads(data)
        return out

    def set_attrs(self, id_: int, m: dict) -> dict:
        with self._mu:
            cur = merge_attrs(self.attrs(id_), m)
            self._db.execute(
                "INSERT OR REPLACE INTO attrs (id, data) VALUES (?, ?)",
                (id_, json.dumps(cur, sort_keys=True)))
            self._db.commit()
            return cur

    def set_bulk_attrs(self, items: Iterable[tuple[int, dict]]) -> None:
        with self._mu:
            merged: dict = {}
            for id_, m in items:
                cur = merged.get(id_)
                if cur is None:
                    cur = self.attrs(id_)
                merged[id_] = merge_attrs(cur, m)
            self._db.executemany(
                "INSERT OR REPLACE INTO attrs (id, data) VALUES (?, ?)",
                [(id_, json.dumps(cur, sort_keys=True))
                 for id_, cur in merged.items()])
            self._db.commit()

    def ids(self) -> list[int]:
        return [r[0] for r in
                self._db.execute("SELECT id FROM attrs ORDER BY id")]

    def blocks(self) -> list[tuple[int, bytes]]:
        out: dict = {}
        for id_, data in self._db.execute(
                "SELECT id, data FROM attrs ORDER BY id"):
            blk = id_ // ATTR_BLOCK_SIZE
            h = out.get(blk)
            if h is None:
                h = out[blk] = hashlib.blake2b(digest_size=16)
            h.update(str(id_).encode() + b"\0" + data.encode() + b"\0")
        return [(blk, h.digest()) for blk, h in sorted(out.items())]

    def block_data(self, blk: int) -> list[tuple[int, dict]]:
        lo, hi = blk * ATTR_BLOCK_SIZE, (blk + 1) * ATTR_BLOCK_SIZE
        return [(id_, json.loads(data)) for id_, data in self._db.execute(
            "SELECT id, data FROM attrs WHERE id >= ? AND id < ? ORDER BY id",
            (lo, hi))]


class NopAttrStore:
    """A store that keeps nothing (pilosa_tpu/utils/attrstore.py:94)."""

    def open(self):
        return self

    def close(self):
        pass

    def attrs(self, id_):
        return {}

    def attrs_many(self, ids):
        return {}

    def set_attrs(self, id_, m):
        return {}

    def set_bulk_attrs(self, items):
        pass

    def ids(self):
        return []

    def blocks(self):
        return []

    def block_data(self, blk):
        return []
