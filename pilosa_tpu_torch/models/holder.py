"""Holder: the root container of all indexes.

Trimmed copy of pilosa_tpu/models/holder.py, same on-disk tree:
<data_dir>/<index>/<field>/views/<view>/fragments/<shard>. The open
holder flocks <data_dir>/.lock, so a second process cannot open the data
dir; its fragments hold no lock of their own (the JAX package locks each
fragment, which a time field of 1024 shards and 95 views would take past
the card machine's 20,000 open files) and keep their WAL open only within
a process-wide budget (storage/fragment.py WAL_FDS). Deleting an index does not
save the rank caches it is about to remove.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import threading
from typing import Optional

from pilosa_tpu_torch.models.index import Index, validate_name


class Holder:
    def __init__(self, path: str):
        self.path = path
        self.indexes: dict[str, Index] = {}
        self._mu = threading.Lock()
        self._lock_file = None

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
                self.indexes[name] = Index(ipath, name).open()
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
                        track_existence=track_existence)
            idx.save_meta()
            self.indexes[name] = idx.open()
            return idx

    def delete_index(self, name: str) -> None:
        with self._mu:
            idx = self.indexes.pop(name, None)
        if idx is None:
            raise KeyError(f"index not found: {name}")
        idx.close(save_caches=False)
        shutil.rmtree(idx.path, ignore_errors=True)

    def walk_fragments(self):
        """Every (index, field, view, shard, fragment), over copies of the
        tree (pilosa_tpu/models/holder.py:96): request threads create
        schema objects concurrently."""
        for iname, idx in list(self.indexes.items()):
            for fname, fld in list(idx.fields.items()):
                for vname, view in list(fld.views.items()):
                    for shard, frag in list(view.fragments.items()):
                        yield iname, fname, vname, shard, frag

    def schema(self) -> list[dict]:
        return [idx.schema_dict() for _, idx in sorted(self.indexes.items())]
