"""Row: the executor's bitmap result value.

Trimmed copy of pilosa_tpu/models/row.py: per-shard segments of sorted
uint64 global columns, carrying results to the JSON and protobuf
boundary, with the row's attributes and, on a keyed index, its column
keys once the API has rendered them; merge() joins the partials of a
distributed result.
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch.constants import SHARD_WIDTH


class Row:
    """Distributed bitmap result: {shard -> sorted uint64 global columns}."""

    __slots__ = ("segments", "attrs", "keys")

    def __init__(self):
        self.segments: dict[int, np.ndarray] = {}
        self.attrs: dict = {}
        self.keys: list[str] = []

    @classmethod
    def from_columns(cls, columns) -> "Row":
        """A Row of ascending global columns, split by shard."""
        row = cls()
        cols = np.asarray(columns, dtype=np.uint64).reshape(-1)
        if cols.size:
            shards = cols // np.uint64(SHARD_WIDTH)
            cuts = np.nonzero(np.diff(shards))[0] + 1
            for seg in np.split(cols, cuts):
                row.segments[int(seg[0]) // SHARD_WIDTH] = seg
        return row

    def merge(self, other: "Row") -> "Row":
        """Shard-wise union of two partials of a distributed result
        (pilosa_tpu/models/row.py:69); each node's partial covers its own
        shards, so segments are usually just taken over."""
        out = Row()
        out.segments = dict(self.segments)
        for shard, seg in other.segments.items():
            have = out.segments.get(shard)
            out.segments[shard] = (seg if have is None
                                   else np.union1d(have, seg))
        out.attrs = {**self.attrs, **other.attrs}
        return out

    def columns(self) -> np.ndarray:
        if not self.segments:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate([self.segments[s] for s in sorted(self.segments)])

    def to_json_dict(self) -> dict:
        d = {"columns": self.columns().tolist()}
        if self.attrs:
            d["attrs"] = self.attrs
        if self.keys:
            d["keys"] = self.keys
        return d
