"""Holder: the root container of all indexes.

Trimmed copy of pilosa_tpu/models/holder.py, same on-disk tree:
<data_dir>/<index>/<field>/views/<view>/fragments/<shard>.
"""

from __future__ import annotations

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

    def open(self) -> "Holder":
        os.makedirs(self.path, exist_ok=True)
        for name in sorted(os.listdir(self.path)):
            ipath = os.path.join(self.path, name)
            if os.path.isdir(ipath) and not name.startswith("."):
                self.indexes[name] = Index(ipath, name).open()
        return self

    def close(self) -> None:
        for idx in self.indexes.values():
            idx.close()
        self.indexes.clear()

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
        idx.close()
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
