"""Index: a namespace of fields sharing one column space.

Trimmed copy of pilosa_tpu/models/index.py: fields, the `_exists`
existence field (read by Not()), `.meta` persistence, and the available
shards as the union of the fields' shard bitmaps.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Optional

import numpy as np

from pilosa_tpu_torch.constants import EXISTENCE_FIELD_NAME
from pilosa_tpu_torch.models.field import Field, FieldOptions

_NAME_RE = re.compile(r"^[a-z][a-z0-9_-]{0,63}$")


def validate_name(name: str) -> None:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid name: {name!r}")


class Index:
    def __init__(self, path: str, name: str, keys: bool = False,
                 track_existence: bool = True):
        validate_name(name)
        self.path = path
        self.name = name
        self.keys = keys
        self.track_existence = track_existence
        self.fields: dict[str, Field] = {}
        self._field_mu = threading.Lock()
        self._avail_cache = None  # (field shard versions, sorted shards)

    def open(self) -> "Index":
        os.makedirs(self.path, exist_ok=True)
        meta = os.path.join(self.path, ".meta")
        if os.path.exists(meta):
            with open(meta) as f:
                data = json.load(f)
            self.keys = data.get("keys", False)
            self.track_existence = data.get("trackExistence", True)
        else:
            self.save_meta()
        for fname in sorted(os.listdir(self.path)):
            fpath = os.path.join(self.path, fname)
            if os.path.isdir(fpath):
                self.fields[fname] = Field(fpath, self.name, fname).open()
        if self.track_existence and EXISTENCE_FIELD_NAME not in self.fields:
            f = Field(os.path.join(self.path, EXISTENCE_FIELD_NAME), self.name,
                      EXISTENCE_FIELD_NAME,
                      FieldOptions(type="set", cache_type="none"))
            self.fields[EXISTENCE_FIELD_NAME] = f.open()
        return self

    def close(self) -> None:
        for f in self.fields.values():
            f.close()
        self.fields.clear()

    def save_meta(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        with open(os.path.join(self.path, ".meta"), "w") as f:
            json.dump({"keys": self.keys,
                       "trackExistence": self.track_existence}, f)

    def field(self, name: str) -> Optional[Field]:
        return self.fields.get(name)

    def existence_field(self) -> Optional[Field]:
        return self.fields.get(EXISTENCE_FIELD_NAME)

    def create_field(self, name: str,
                     options: Optional[FieldOptions] = None) -> Field:
        validate_name(name)
        options = options or FieldOptions()
        options.validate()
        with self._field_mu:
            if name in self.fields:
                raise ValueError(f"field already exists: {name}")
            f = Field(os.path.join(self.path, name), self.name, name, options)
            f.save_meta()
            self.fields[name] = f.open()
            return f

    def available_shards_list(self) -> list[int]:
        """Sorted union of the fields' shards ([0] when empty), memoized on
        the fields' shard versions."""
        fields = list(self.fields.items())
        key = tuple((name, id(f), f.shards_version) for name, f in fields)
        cached = self._avail_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        shards = set()
        for _, f in fields:
            shards.update(f.shards())
        out = sorted(shards) or [0]
        self._avail_cache = (key, out)
        return out

    def mark_exists(self, columns) -> None:
        """Mark columns live in the existence field (Not() reads it)."""
        if not self.track_existence:
            return
        ef = self.existence_field()
        if ef is None:
            return
        cols = np.asarray(columns, dtype=np.uint64).reshape(-1)
        if cols.size == 1:
            ef.set_bit(0, int(cols[0]))
        elif cols.size:
            ef.import_bits(np.zeros(cols.size, dtype=np.uint64), cols)

    def schema_dict(self) -> dict:
        return {
            "name": self.name,
            "options": {"keys": self.keys,
                        "trackExistence": self.track_existence},
            "fields": [
                {"name": f.name, "options": {
                    "type": f.options.type,
                    "cacheType": f.options.cache_type,
                    "cacheSize": f.options.cache_size,
                    "min": f.options.min,
                    "max": f.options.max,
                    "timeQuantum": f.options.time_quantum,
                    "keys": f.options.keys,
                }}
                for name, f in sorted(self.fields.items())
                if name != EXISTENCE_FIELD_NAME
            ],
        }
