"""Holder: the root container of all indexes.

Trimmed copy of pilosa_tpu/models/holder.py, same on-disk tree:
<data_dir>/<index>/<field>/views/<view>/fragments/<shard>. The open
holder flocks <data_dir>/.lock, so a second process cannot open the data
dir; its fragments hold no lock of their own (the JAX package locks each
fragment, which a time field of 1024 shards and 95 views would take past
the card machine's 20,000 open files) and keep their WAL open only within
a process-wide budget (storage/fragment.py WAL_FDS). Deleting an index does not
save the rank caches it is about to remove. flush_caches (:80) saves
every rank cache in place (a drain's step).
"""

from __future__ import annotations

import fcntl
import os
import shutil
import threading
from typing import Optional

from pilosa_tpu_torch.models.index import Index, validate_name


class Holder:
    def __init__(self, path: str, wal_fsync: bool = False):
        self.path = path
        # [storage] wal-fsync = "always": every fragment fsyncs its WAL
        # appends (handed down through Index, Field and View)
        self.wal_fsync = wal_fsync
        self.indexes: dict[str, Index] = {}
        self._mu = threading.Lock()
        self._lock_file = None
        # fn(index, field, shard) on every shard a field newly holds (the
        # server's create-shard announcement)
        self.shard_hook = None

    def open(self) -> "Holder":
        os.makedirs(self.path, exist_ok=True)
        self._lock_file = open(os.path.join(self.path, ".lock"), "ab")
        try:
            fcntl.flock(self._lock_file.fileno(),
                        fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._lock_file.close()
            self._lock_file = None
            raise RuntimeError(
                f"data dir locked by another holder: {self.path}")
        for name in sorted(os.listdir(self.path)):
            ipath = os.path.join(self.path, name)
            if os.path.isdir(ipath) and not name.startswith("."):
                self.indexes[name] = Index(
                    ipath, name, wal_fsync=self.wal_fsync).open()
        return self

    def close(self) -> None:
        for idx in self.indexes.values():
            idx.close()
        self.indexes.clear()
        if self._lock_file is not None:
            self._lock_file.close()  # releases the flock
            self._lock_file = None

    def index(self, name: str) -> Optional[Index]:
        return self.indexes.get(name)

    def create_index(self, name: str, keys: bool = False,
                     track_existence: bool = True) -> Index:
        validate_name(name)
        with self._mu:
            if name in self.indexes:
                raise ValueError(f"index already exists: {name}")
            idx = Index(os.path.join(self.path, name), name, keys=keys,
                        track_existence=track_existence,
                        wal_fsync=self.wal_fsync)
            idx.save_meta()
            self.indexes[name] = idx.open()
            idx.set_shard_hook(self.shard_hook)
            return idx

    def set_shard_hook(self, fn) -> None:
        self.shard_hook = fn
        for idx in self.indexes.values():
            idx.set_shard_hook(fn)

    def delete_index(self, name: str) -> None:
        with self._mu:
            idx = self.indexes.pop(name, None)
        if idx is None:
            raise KeyError(f"index not found: {name}")
        idx.close(save_caches=False)
        shutil.rmtree(idx.path, ignore_errors=True)

    def flush_caches(self) -> int:
        """Save every view's rank caches beside their fragments; returns
        how many were written."""
        n = 0
        for idx in list(self.indexes.values()):
            for f in list(idx.fields.values()):
                for view in list(f.views.values()):
                    n += view.flush_caches()
        return n

    def walk_fragments(self):
        """Every (index, field, view, shard, fragment), over copies of the
        tree (pilosa_tpu/models/holder.py:96): request threads create
        schema objects concurrently."""
        for iname, idx in list(self.indexes.items()):
            for fname, fld in list(idx.fields.items()):
                for vname, view in list(fld.views.items()):
                    for shard, frag in list(view.fragments.items()):
                        yield iname, fname, vname, shard, frag

    def damaged_fragments(self) -> list[dict]:
        """Fragments quarantined at open (rebuilt or not) or whose torn
        WAL tail was truncated (pilosa_tpu/models/holder.py:106)."""
        out = []
        for iname, fname, vname, shard, frag in self.walk_fragments():
            if frag.quarantine_path is None \
                    and not frag.wal_truncated_bytes:
                continue
            out.append({
                "index": iname, "field": fname, "view": vname,
                "shard": shard,
                "quarantinePath": frag.quarantine_path,
                "corruptionError": frag.corruption_error,
                "rebuiltFrom": frag.rebuilt_from,
                "needsRebuild": frag.needs_rebuild,
                "walTruncatedBytes": frag.wal_truncated_bytes,
                "walTruncateError": frag.wal_truncate_error,
            })
        return out

    def schema(self) -> list[dict]:
        return [idx.schema_dict() for _, idx in sorted(self.indexes.items())]
