"""Per-query profiles: the answer to "why was THIS query slow?".

Trimmed port of pilosa_tpu/utils/profile.py: QueryProfile (:60) rides a
contextvar, and every layer a query passes appends its record: one per
call (executor), the batched dispatch that served it with the batch size
it shared and its wall-time share (parallel/batcher.py), residency hits,
misses and host-to-device bytes (parallel/residency.py). to_dict() has
the JAX package's keys; on one node `fanout`, `plan`, `route` and
`remoteProfiles` stay empty, as they do in the JAX package without a
cluster, planner or router. QueryHistory (:243) is the slow-query ring of
GET /debug/query-history.

Disabled cost: one ContextVar.get() returning None per site.
"""

from __future__ import annotations

import collections
import contextvars
import threading
import time
from typing import Optional

# the profile being recorded for the current query, or None (profiling
# off: every site checks this and returns at once)
current_profile: contextvars.ContextVar[Optional["QueryProfile"]] = \
    contextvars.ContextVar("pilosa_torch_query_profile", default=None)

# the finished profile of the query a handler just ran: the API publishes
# it here so the HTTP layer can attach it to the response
last_profile: contextvars.ContextVar[Optional["QueryProfile"]] = \
    contextvars.ContextVar("pilosa_torch_last_profile", default=None)


class QueryProfile:
    """One query's attribution records. Appends are thread-safe: batcher
    leader threads record into a submitter's profile."""

    __slots__ = ("trace_id", "node_id", "index", "pql", "start",
                 "start_wall", "elapsed_ms", "calls", "dispatches",
                 "residency_hits", "residency_misses", "h2d_bytes", "_lock",
                 "_sealed", "_cached_dict")

    def __init__(self, trace_id: str = "", node_id: str = "",
                 index: str = "", pql: str = ""):
        self._sealed = False  # finish() seals: late records are dropped
        self._cached_dict: Optional[dict] = None
        self.trace_id = trace_id
        self.node_id = node_id
        self.index = index
        self.pql = pql
        self.start = time.perf_counter()
        self.start_wall = time.time()
        self.elapsed_ms: float = 0.0
        self.calls: list[dict] = []
        self.dispatches: list[dict] = []
        self.residency_hits = 0
        self.residency_misses = 0
        self.h2d_bytes = 0
        self._lock = threading.Lock()

    def record_call(self, name: str, ms: float) -> None:
        with self._lock:
            if self._sealed:
                return
            self.calls.append({"call": name, "ms": round(ms, 3)})

    def record_dispatch(self, batcher: str, seq: int, batch_size: int,
                        wall_ms: float) -> None:
        """This query's share of one batched dispatch: `seq` identifies the
        dispatch (shared by every co-batched query), the wall-time share
        divides its wall clock evenly over the batch."""
        with self._lock:
            if self._sealed:
                return
            self.dispatches.append({
                "batcher": batcher, "dispatch": seq,
                "batchSize": batch_size, "wallMs": round(wall_ms, 3),
                "shareMs": round(wall_ms / max(1, batch_size), 3)})

    def record_residency(self, hit: bool, nbytes: int = 0) -> None:
        with self._lock:
            if self._sealed:
                return
            if hit:
                self.residency_hits += 1
            else:
                self.residency_misses += 1
                self.h2d_bytes += int(nbytes)

    def finish(self) -> None:
        self.elapsed_ms = round((time.perf_counter() - self.start) * 1e3, 3)
        with self._lock:
            self._sealed = True

    def to_dict(self) -> dict:
        """The ?profile=true tree; memoized once sealed, so the response
        and the slow-query history share one serialization."""
        with self._lock:
            if self._cached_dict is not None:
                return self._cached_dict
            d = {
                "traceId": self.trace_id,
                "node": self.node_id,
                "index": self.index,
                "pql": self.pql,
                "startWall": self.start_wall,
                "elapsedMs": self.elapsed_ms,
                "calls": list(self.calls),
                "fanout": [],
                "dispatches": list(self.dispatches),
                "residency": {"hits": self.residency_hits,
                              "misses": self.residency_misses,
                              "hostToDeviceBytes": self.h2d_bytes},
                "plan": [],
                "route": [],
                "remoteProfiles": [],
            }
            if self._sealed:
                self._cached_dict = d
            return d


def truncate_pql(pql, limit: int = 256) -> str:
    """History PQL truncation: an import-sized PQL must not sit in the
    ring buffer in full."""
    s = pql if isinstance(pql, str) else str(pql)
    return s if len(s) <= limit else s[: limit - 3] + "..."


class QueryHistory:
    """The last `size` queries over long-query-time, newest first, each
    with trace id, truncated PQL, elapsed seconds and its profile."""

    def __init__(self, size: int = 100):
        self._lock = threading.Lock()
        self._entries: collections.deque = collections.deque(
            maxlen=max(1, int(size)))

    def append(self, entry: dict) -> None:
        with self._lock:
            self._entries.append(entry)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(reversed(self._entries))

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
