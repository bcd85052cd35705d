"""View: a named sub-bitmap of a field, owning fragments by shard.

Trimmed copy of pilosa_tpu/models/view.py: the standard view and an int
field's `bsig_<field>` BSI view, no rank caches (a view written here gets
its rank cache rebuilt from the fragments when the JAX package opens it).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.storage.fragment import Fragment

VIEW_STANDARD = "standard"
VIEW_BSI_PREFIX = "bsig_"


def view_path(field_path: str, name: str) -> str:
    return os.path.join(field_path, "views", name)


class View:
    def __init__(self, path: str, index: str, field: str, name: str):
        self.path = path
        self.index = index
        self.field = field
        self.name = name
        self.fragments: dict[int, Fragment] = {}
        self._frag_mu = threading.Lock()

    def open(self) -> "View":
        frag_dir = os.path.join(self.path, "fragments")
        if os.path.isdir(frag_dir):
            for fname in os.listdir(frag_dir):
                # data files are named by shard; sidecars (.cache, .lock,
                # .snapshotting, .corrupt-*) are skipped
                if fname.isdigit():
                    self._open_fragment(int(fname))
        return self

    def close(self) -> None:
        for frag in self.fragments.values():
            frag.close()
        self.fragments.clear()

    def _open_fragment(self, shard: int) -> Fragment:
        frag = Fragment(os.path.join(self.path, "fragments", str(shard)),
                        self.index, self.field, self.name, shard).open()
        self.fragments[shard] = frag
        return frag

    def fragment(self, shard: int) -> Optional[Fragment]:
        return self.fragments.get(shard)

    def create_fragment_if_not_exists(self, shard: int) -> Fragment:
        frag = self.fragments.get(shard)
        if frag is None:
            with self._frag_mu:
                frag = self.fragments.get(shard)
                if frag is None:
                    frag = self._open_fragment(shard)
        return frag

    def shards(self) -> list[int]:
        return sorted(self.fragments)

    def set_bit(self, row_id: int, column: int) -> bool:
        frag = self.create_fragment_if_not_exists(column // SHARD_WIDTH)
        return frag.set_bit(row_id, column % SHARD_WIDTH)

    def clear_bit(self, row_id: int, column: int) -> bool:
        frag = self.fragments.get(column // SHARD_WIDTH)
        if frag is None:
            return False
        return frag.clear_bit(row_id, column % SHARD_WIDTH)
