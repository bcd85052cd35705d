"""Tracing: an in-memory recording Tracer, its Span, and trace ids.

Trimmed port of pilosa_tpu/utils/tracing.py (the reference's
tracing/tracing.go:9-59): Span, Tracer (recording, keeps the last `limit`
finished spans), NopSpan/NopTracer, new_trace_id, the current_trace_id
contextvar and the X-Pilosa-Trace-Id header (read by the HTTP handler;
the port sends no requests to propagate it on). Span export
(SpanExporter, TraceExporter) is not ported: a Tracer here records and
never ships.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
from typing import Optional

TRACE_HEADER = "X-Pilosa-Trace-Id"

# process-seeded PRNG for trace ids: uniqueness, not cryptographic
# strength (uuid4 would cost an os.urandom syscall per traced query)
_trace_rng = random.Random()

# trace id of the request being served: the HTTP handler sets it from the
# incoming header, the API mints one for a profiled or slow-armed query
current_trace_id: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("pilosa_torch_trace_id", default=None)


def new_trace_id() -> str:
    """A fresh trace id (16 hex digits)."""
    return f"{_trace_rng.getrandbits(64):016x}"


class Span:
    __slots__ = ("tracer", "name", "trace_id", "start", "end", "tags",
                 "start_wall")

    def __init__(self, tracer, name: str, trace_id: str):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.start = time.monotonic()
        self.start_wall = time.time()
        self.end: Optional[float] = None
        self.tags: dict = {}

    def set_tag(self, key: str, value) -> None:
        self.tags[key] = value

    def finish(self) -> None:
        self.end = time.monotonic()
        self.tracer._record(self)

    def duration(self) -> float:
        end = self.end if self.end is not None else time.monotonic()
        return end - self.start

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()


class Tracer:
    """Recording tracer; keeps the last `limit` finished spans."""

    def __init__(self, limit: int = 1000):
        self.limit = limit
        self._lock = threading.Lock()
        self.spans: list[Span] = []

    def start_span(self, name: str, trace_id: Optional[str] = None) -> Span:
        return Span(self, name,
                    trace_id or current_trace_id.get() or new_trace_id())

    def _record(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)
            if len(self.spans) > self.limit:
                self.spans = self.spans[-self.limit:]

    def finished(self, name: Optional[str] = None) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if name is None or s.name == name]


class NopSpan:
    def set_tag(self, key, value): pass
    def finish(self): pass
    def duration(self): return 0.0
    def __enter__(self): return self
    def __exit__(self, *exc): pass


class NopTracer:
    """The tracer of an executor no server configured (tracing.go:38)."""

    def start_span(self, name, trace_id=None):
        return NopSpan()

    def finished(self, name=None):
        return []
