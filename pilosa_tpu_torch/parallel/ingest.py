"""Write-side continuous batching: coalesced Set/Clear ingest.

Port of pilosa_tpu/parallel/ingest.py (:39-126) without its QoS class and
usage accounting (the port has neither). Concurrent Set/Clear requests
queue under one compatibility key per index; the first arrival leads, and
the whole batch is applied as per-fragment bulk operations
(Fragment.apply_batch): one WAL group commit, one sorted-dedup container
merge and one generation bump per fragment per batch instead of per bit.

Group commit is self-clocked: the admission window is zero, so a lone
writer cuts at once, while under concurrency arrivals pile up behind the
apply in flight (the batcher holds leadership through it), and the batch
size follows arrival rate x apply time.

PILOSA_TPU_TORCH_INGEST=0 is the kill switch, read on every call at the
executor's interception: mutations then take the per-bit path, with the
same answers.

ApplyFence is the port's own: it keeps reads of an index out while a
batch is applied to it and its resident leaves are patched. A batch bumps
the generations of thousands of fragments one after another (a 4,000-
mutation batch over 1024 shards touches about 3,000), so a read in that
window takes a key whose generations are half old, half new, misses every
resident leaf and rebuilds it from the host, 128 MiB of a dense row from
1024 fragments, once per reader. With the fence a read sees the state
before the batch or after its patches, never between: its leaves are
resident either way. The JAX package has no fence and the same window.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Callable

from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.parallel.batcher import ContinuousBatcher

# requests per batch (the cut counts payloads, as every batcher's does):
# bounds the host merge arrays and the WAL record burst; far above the
# read batchers' 512, a mutation being a dozen bytes
DEFAULT_MAX_BATCH = 4096


def ingest_env_enabled() -> bool:
    """False when PILOSA_TPU_TORCH_INGEST=0 (read on every call: the
    switch needs no restart). Batches in flight finish; new mutations take
    the per-bit path."""
    return os.environ.get("PILOSA_TPU_TORCH_INGEST", "1") != "0"


class Mutation:
    """One Set/Clear riding an ingest batch, with its ids resolved on the
    submitting thread."""

    __slots__ = ("is_set", "field_name", "row_id", "col")

    def __init__(self, is_set: bool, field_name: str, row_id: int, col: int):
        self.is_set = is_set
        self.field_name = field_name
        self.row_id = row_id
        self.col = col

    @property
    def shard(self) -> int:
        return self.col // SHARD_WIDTH


class IngestBatcher(ContinuousBatcher):
    """Continuous batcher over mutation payloads. A payload is one
    request's list of Mutations; `apply_fn(index_name, muts)` returns one
    outcome per mutation, ("ok", changed) or ("err", exception), and the
    batcher slices the outcomes back per request, so an error stays with
    the request whose mutation raised it."""

    HANDOFF_AT_CUT = False

    def __init__(self, apply_fn: Callable, max_batch: int = DEFAULT_MAX_BATCH):
        # no admission window: arrivals pile up behind the apply in flight
        super().__init__(max_batch=max_batch, admission_s=0.0)
        self._apply = apply_fn
        self.mutations = 0
        self.set_mutations = 0
        self.clear_mutations = 0

    def _dispatch(self, key: tuple, payloads: list):
        muts: list[Mutation] = []
        spans = []
        for p in payloads:
            spans.append((len(muts), len(p)))
            muts.extend(p)
        outcomes = self._apply(key[0], muts)
        if len(outcomes) != len(muts):
            raise RuntimeError(f"ingest apply returned {len(outcomes)} "
                               f"outcomes for {len(muts)} mutations")
        n_sets = sum(1 for m in muts if m.is_set)
        with self._lock:
            self.mutations += len(muts)
            self.set_mutations += n_sets
            self.clear_mutations += len(muts) - n_sets
        return [outcomes[off:off + n] for off, n in spans]

    def _finalize(self, key: tuple, handle, payloads: list) -> list:
        return handle

    def snapshot(self) -> dict:
        out = super().snapshot()
        with self._lock:
            out["mutations"] = self.mutations
            out["setMutations"] = self.set_mutations
            out["clearMutations"] = self.clear_mutations
        return out


class ApplyFence:
    """Shared by reads, exclusive to a batch apply. A waiting apply holds
    off new reads, so a stream of reads cannot starve it; reads that
    waited through an apply go in when it ends, ahead of the next one, so
    back-to-back batches cannot starve them either (a read waits for one
    apply at most). A thread already reading may read again (the count is
    per thread), so nested reads cannot deadlock behind a waiting
    apply."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._readers = 0
        self._writing = False
        self._waiting = 0
        self._applied = 0  # applies finished
        self._reads_waiting = 0
        self._admitted = 0  # waiting reads let in by the last apply's end
        self._mine = threading.local()

    @contextmanager
    def read(self):
        depth = getattr(self._mine, "depth", 0)
        if not depth:
            with self._cond:
                seen = self._applied
                self._reads_waiting += 1
                while self._writing or (self._waiting
                                        and self._applied == seen):
                    self._cond.wait()
                self._reads_waiting -= 1
                if self._applied != seen and self._admitted:
                    self._admitted -= 1
                self._readers += 1
        self._mine.depth = depth + 1
        try:
            yield
        finally:
            self._mine.depth = depth
            if not depth:
                with self._cond:
                    self._readers -= 1
                    if not self._readers:
                        self._cond.notify_all()

    @contextmanager
    def apply(self):
        with self._cond:
            self._waiting += 1
            while self._writing or self._readers or self._admitted:
                self._cond.wait()
            self._waiting -= 1
            self._writing = True
        try:
            yield
        finally:
            with self._cond:
                self._writing = False
                self._applied += 1
                self._admitted = self._reads_waiting
                self._cond.notify_all()
