"""Device residency: an LRU cache of query leaves on the device.

Trimmed port of pilosa_tpu/parallel/residency.py DeviceResidency: each
leaf (one row over a shard set, a BSI plane slab, a Range mask) stays
resident keyed by its content generations, so repeat queries run without host->device transfers and a
write changes the key. Eviction is LRU by byte budget; a leaf costs its
tensor.nbytes.

The default budget is half of the card's memory
(torch.cuda.get_device_properties(0).total_memory // 2), leaving the rest
to query intermediates and the batcher's outputs. On the CPU (tests) it is
a fixed 1 GiB.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

BUDGET_FRACTION = 0.5
CPU_BUDGET_BYTES = 1 << 30


def default_budget(device: torch.device) -> int:
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        return int(total * BUDGET_FRACTION)
    return CPU_BUDGET_BYTES


class DeviceResidency:
    def __init__(self, runner):
        self.runner = runner
        self.budget = default_budget(runner.device)
        self._lru: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
        self._lock = threading.Lock()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.epoch = 0  # bumped by clear(); fences in-flight misses

    def leaf(self, key: tuple,
             make: Callable[[], "np.ndarray | torch.Tensor"]) -> torch.Tensor:
        """The device tensor for `key`, uploading make()'s host array on a
        miss (or keeping its device tensor: a BSI slab or a Range mask
        computed on the device). `key` must encode content generations."""
        with self._lock:
            arr = self._lru.get(key)
            if arr is not None:
                self._lru.move_to_end(key)
                self.hits += 1
                return arr
            epoch = self.epoch
        # built and uploaded outside the lock: concurrent misses of other
        # keys must not serialize behind one host->device transfer
        arr = make()
        if not isinstance(arr, torch.Tensor):
            arr = self.runner.put_leaf(arr)
        with self._lock:
            self.misses += 1
            if self.epoch != epoch:
                # clear() ran meanwhile (index/field deleted): serve, but
                # never cache what may describe deleted schema
                return arr
            displaced = self._lru.pop(key, None)
            if displaced is not None:
                self.bytes -= displaced.nbytes
            self._lru[key] = arr
            self.bytes += arr.nbytes
            while self.bytes > self.budget and len(self._lru) > 1:
                _, old = self._lru.popitem(last=False)
                self.bytes -= old.nbytes
                self.evictions += 1
        return arr

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()
            self.bytes = 0
            self.epoch += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"entries": len(self._lru), "bytes": self.bytes,
                    "budget": self.budget, "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions}
