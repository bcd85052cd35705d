"""Row: the executor's bitmap result value.

Trimmed copy of pilosa_tpu/models/row.py: per-shard segments of sorted
uint64 global columns, carrying results to the JSON boundary.
"""

from __future__ import annotations

import numpy as np


class Row:
    """Distributed bitmap result: {shard -> sorted uint64 global columns}."""

    __slots__ = ("segments", "attrs")

    def __init__(self):
        self.segments: dict[int, np.ndarray] = {}
        self.attrs: dict = {}

    def columns(self) -> np.ndarray:
        if not self.segments:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate([self.segments[s] for s in sorted(self.segments)])

    def to_json_dict(self) -> dict:
        d = {"columns": self.columns().tolist()}
        if self.attrs:
            d["attrs"] = self.attrs
        return d
