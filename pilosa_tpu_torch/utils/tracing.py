"""Tracing: a recording Tracer, its Span, trace ids, and span export.

Port of pilosa_tpu/utils/tracing.py (the reference's
tracing/tracing.go:9-59): Span, Tracer (recording, keeps the last `limit`
finished spans, and hands the spans its sampler passes to an exporter,
:459-516), NopSpan/NopTracer, new_trace_id, the current_trace_id
contextvar and the X-Pilosa-Trace-Id header (read by the HTTP handler,
sent on by net/client.py).

Export (:71-456), with the JAX records and wire formats:
- SpanExporter: flat spans POSTed as Jaeger-shaped JSON batches to the
  [tracing] agent endpoint;
- profile_to_spans: a cross-node query profile tree flattened into span
  records linked parent to child under the profile's one trace id, the
  remote nodes' trees grafted under the fan-out span of their node;
- spans_to_jaeger and spans_to_otlp: the two batch formats;
- TraceExporter ([metric] trace-export = file | http): batches of either
  format appended to a spool file, one JSON batch a line, or POSTed to a
  collector, with deterministic per-trace sampling (crc32 of the trace
  id, so every node of a trace decides alike). PILOSA_TPU_TRACE_EXPORT=0
  (trace_export_enabled, read per batch) and any I/O failure drop
  batches: export never blocks or fails a query.

Both exporters batch alike (_Shipper): on a timer (flush_interval
seconds) and, past batch_size records, on one background thread at a
time.
"""

from __future__ import annotations

import contextvars
import json
import os
import random
import threading
import time
import urllib.request
import zlib
from typing import Optional

from pilosa_tpu_torch.utils import threads

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


class _Shipper:
    """What both exporters share: records buffer in memory and flush()
    ships them every flush_interval seconds (0: only when asked), or on
    one background thread once batch_size wait, so the span's finisher
    (a request thread) never waits on a slow collector or disk."""

    def __init__(self, batch_size: int, flush_interval: float):
        self.batch_size = batch_size
        self.flush_interval = flush_interval
        self._buf: list[dict] = []
        self._lock = threading.Lock()
        self._timer: Optional[threading.Timer] = None
        self._flush_pending = False  # at most one batch-full flusher
        self._closed = False
        self._schedule()

    def _schedule(self) -> None:
        if self._closed or self.flush_interval <= 0:
            return
        self._timer = threads.ctx_timer(self.flush_interval, self._tick)
        self._timer.start()

    def _tick(self) -> None:
        try:
            self.flush()
        finally:
            self._schedule()

    def _push(self, records: list[dict]) -> None:
        if not records:
            return
        with self._lock:
            if self._closed:
                return
            self._buf.extend(records)
            spawn = (len(self._buf) >= self.batch_size
                     and not self._flush_pending)
            if spawn:
                self._flush_pending = True
        if spawn:
            threads.spawn(self._bg_flush, name="pilosa-torch-trace-flush")

    def _bg_flush(self) -> None:
        try:
            self.flush()
        finally:
            with self._lock:
                self._flush_pending = False

    def _take(self) -> list[dict]:
        with self._lock:
            batch, self._buf = self._buf, []
        return batch

    def flush(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """The last flush; later records are dropped."""
        if self._closed:
            return
        self._closed = True
        if self._timer is not None:
            self._timer.cancel()
        self.flush()


class SpanExporter(_Shipper):
    """Batched JSON-over-HTTP span shipper for the [tracing] agent
    endpoint (:71-163): finished spans are POSTed as

        {"process": {"serviceName": "pilosa-tpu"},
         "spans": [{"traceID", "operationName", "startTimeMicros",
                    "durationMicros", "tags"}]}

    A failed POST drops its batch."""

    def __init__(self, endpoint: str, batch_size: int = 64,
                 flush_interval: float = 2.0,
                 service_name: str = "pilosa-tpu"):
        self.endpoint = endpoint
        self.service_name = service_name
        self.exported = 0  # spans shipped
        super().__init__(batch_size, flush_interval)

    def export(self, span: "Span") -> None:
        self._push([{
            "traceID": span.trace_id,
            "operationName": span.name,
            "startTimeMicros": int(span.start_wall * 1e6),
            "durationMicros": int(span.duration() * 1e6),
            "tags": {k: str(v) for k, v in span.tags.items()},
        }])

    def flush(self) -> None:
        batch = self._take()
        if not batch:
            return
        body = json.dumps({"process": {"serviceName": self.service_name},
                           "spans": batch}).encode()
        req = urllib.request.Request(
            self.endpoint, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=2.0):
                pass
            self.exported += len(batch)
        except Exception:  # noqa: BLE001 — tracing never breaks serving
            pass


def trace_export_enabled() -> bool:
    """PILOSA_TPU_TRACE_EXPORT=0 stops all trace export (read per batch,
    so an operator can flip it while a collector misbehaves)."""
    return os.environ.get("PILOSA_TPU_TRACE_EXPORT", "1") != "0"


def _new_span_id() -> str:
    return f"{_trace_rng.getrandbits(64):016x}"


def profile_to_spans(profile: dict) -> list[dict]:
    """A cross-node profile tree (utils/profile.py to_dict) as span
    records under its one trace id (:176-254): traceID, spanID,
    parentSpanID ("" for the root), operationName, startTimeMicros,
    durationMicros, tags. One `pilosa.query` span a profile node, with
    child spans for its executor calls (call.<name>), its fan-out RPCs
    (fanout.<node>; a hedge or failover record is a tag-only
    fanout.<kind>) and its batched dispatches (dispatch.<batcher>); a
    remote node's tree is grafted under the fan-out span of its node (or
    the root when that record is missing)."""
    spans: list[dict] = []

    def emit(trace_id: str, name: str, start_us: int, dur_us: int,
             parent: str, tags: dict) -> str:
        sid = _new_span_id()
        spans.append({
            "traceID": trace_id, "spanID": sid, "parentSpanID": parent,
            "operationName": name,
            "startTimeMicros": int(start_us),
            "durationMicros": max(0, int(dur_us)),
            "tags": {k: str(v) for k, v in tags.items() if v is not None},
        })
        return sid

    def walk(node: dict, parent: str, trace_id: str) -> None:
        trace_id = node.get("traceId") or trace_id
        start_us = int(float(node.get("startWall") or 0.0) * 1e6)
        root = emit(trace_id, "pilosa.query", start_us,
                    float(node.get("elapsedMs") or 0.0) * 1e3, parent,
                    {"node": node.get("node"), "index": node.get("index"),
                     "pql": node.get("pql")})
        for c in node.get("calls", []):
            emit(trace_id, f"call.{c.get('call', '?')}", start_us,
                 float(c.get("ms") or 0.0) * 1e3, root, {})
        fanout_span_by_node: dict[str, str] = {}
        for fo in node.get("fanout", []):
            kind = fo.get("kind")
            if kind:
                emit(trace_id, f"fanout.{kind}", start_us, 0, root, fo)
                continue
            sid = emit(trace_id, f"fanout.{fo.get('node', '?')}", start_us,
                       float(fo.get("ms") or 0.0) * 1e3, root,
                       {"shards": fo.get("shards"),
                        "transport": fo.get("transport"),
                        "hedge": fo.get("hedge"),
                        "error": fo.get("error")})
            fanout_span_by_node.setdefault(str(fo.get("node")), sid)
        for d in node.get("dispatches", []):
            emit(trace_id, f"dispatch.{d.get('batcher', '?')}", start_us,
                 float(d.get("shareMs") or 0.0) * 1e3, root,
                 {"dispatch": d.get("dispatch"),
                  "batchSize": d.get("batchSize"),
                  "wallMs": d.get("wallMs")})
        for rem in node.get("remoteProfiles", []):
            frag = rem.get("profile")
            if not isinstance(frag, dict):
                continue
            # fan-out records name the node id; a remote tree is grafted
            # under its own node id, else the label it was filed under
            anchor = (fanout_span_by_node.get(str(frag.get("node")))
                      or fanout_span_by_node.get(str(rem.get("node")))
                      or root)
            walk(frag, anchor, trace_id)

    walk(profile, "", profile.get("traceId") or _new_span_id())
    return spans


def spans_to_jaeger(records: list[dict],
                    service_name: str = "pilosa-tpu") -> dict:
    """A Jaeger-JSON batch (:257-276): CHILD_OF references carry the
    parent links."""
    spans = []
    for r in records:
        refs = []
        if r.get("parentSpanID"):
            refs.append({"refType": "CHILD_OF", "traceID": r["traceID"],
                         "spanID": r["parentSpanID"]})
        spans.append({
            "traceID": r["traceID"], "spanID": r["spanID"],
            "operationName": r["operationName"],
            "references": refs,
            "startTime": r["startTimeMicros"],
            "duration": r["durationMicros"],
            "tags": [{"key": k, "type": "string", "value": v}
                     for k, v in sorted(r.get("tags", {}).items())],
        })
    return {"process": {"serviceName": service_name}, "spans": spans}


def spans_to_otlp(records: list[dict],
                  service_name: str = "pilosa-tpu") -> dict:
    """An OTLP/JSON ExportTraceServiceRequest (:279-299); the 64-bit
    trace ids are zero-padded on the left to OTLP's 128 bits."""
    spans = []
    for r in records:
        start_ns = r["startTimeMicros"] * 1000
        spans.append({
            "traceId": r["traceID"].rjust(32, "0"),
            "spanId": r["spanID"],
            "parentSpanId": r.get("parentSpanID", ""),
            "name": r["operationName"],
            "kind": 1,
            "startTimeUnixNano": str(start_ns),
            "endTimeUnixNano": str(start_ns + r["durationMicros"] * 1000),
            "attributes": [{"key": k, "value": {"stringValue": v}}
                           for k, v in sorted(r.get("tags", {}).items())],
        })
    return {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name",
             "value": {"stringValue": service_name}}]},
        "scopeSpans": [{"scope": {"name": "pilosa-tpu"}, "spans": spans}],
    }]}


class TraceExporter(_Shipper):
    """Trace egress for [metric] trace-export (:301-456): Jaeger-JSON or
    OTLP-JSON batches appended to a spool file (mode "file", one batch a
    line) or POSTed to a collector (mode "http"). Fed by the recording
    tracer's finished spans (as its exporter: flat spans) and by finished
    cross-node profile trees (export_profile: linked spans). `sample` is
    the fraction of trace ids exported, decided by crc32 of the id."""

    def __init__(self, mode: str = "file", path: str = "",
                 endpoint: str = "", fmt: str = "jaeger",
                 sample: float = 1.0, batch_size: int = 64,
                 flush_interval: float = 2.0,
                 service_name: str = "pilosa-tpu"):
        if mode not in ("file", "http"):
            raise ValueError(
                f"invalid trace-export mode {mode!r} (expected file | http)")
        if fmt not in ("jaeger", "otlp"):
            raise ValueError(
                f"invalid trace-export format {fmt!r} "
                "(expected jaeger | otlp)")
        if mode == "file" and not path:
            raise ValueError("trace-export = file requires a spool path")
        if mode == "http" and not endpoint:
            raise ValueError("trace-export = http requires an endpoint")
        self.mode = mode
        self.path = path
        self.endpoint = endpoint
        self.fmt = fmt
        self.sample = sample
        self.service_name = service_name
        self.exported = 0  # span records shipped
        self.dropped = 0   # span records lost to I/O failures
        super().__init__(batch_size, flush_interval)

    def sampled(self, trace_id: Optional[str]) -> bool:
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        h = zlib.crc32((trace_id or "").encode())
        return (h % 10_000) < self.sample * 10_000

    def export(self, span: "Span") -> None:
        """The recording tracer's hook: one flat finished span (the
        tracer's sampler has passed it)."""
        if not trace_export_enabled():
            return
        self._push([{
            "traceID": span.trace_id, "spanID": _new_span_id(),
            "parentSpanID": "",
            "operationName": span.name,
            "startTimeMicros": int(span.start_wall * 1e6),
            "durationMicros": int(span.duration() * 1e6),
            "tags": {k: str(v) for k, v in span.tags.items()},
        }])

    def export_profile(self, profile: dict) -> None:
        """One finished cross-node profile tree, as linked spans."""
        if not trace_export_enabled():
            return
        if not self.sampled(profile.get("traceId")):
            return
        try:
            self._push(profile_to_spans(profile))
        except Exception:  # noqa: BLE001 — export never breaks serving
            self.dropped += 1

    def flush(self) -> None:
        batch = self._take()
        if not batch or not trace_export_enabled():
            self.dropped += len(batch)
            return
        body_obj = (spans_to_jaeger(batch, self.service_name)
                    if self.fmt == "jaeger"
                    else spans_to_otlp(batch, self.service_name))
        try:
            if self.mode == "file":
                # one JSON batch a line: a torn write can only cut the last
                # line, which readers skip
                with open(self.path, "a") as f:
                    f.write(json.dumps(body_obj) + "\n")
            else:
                req = urllib.request.Request(
                    self.endpoint, data=json.dumps(body_obj).encode(),
                    method="POST",
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=2.0):
                    pass
            self.exported += len(batch)
        except Exception:  # noqa: BLE001 — drop the batch
            self.dropped += len(batch)


class Tracer:
    """Recording tracer; keeps the last `limit` finished spans and hands
    each one its sampler passes to `exporter`. The sampler is the
    reference's Jaeger one (server/config.go:96-104): "const" exports
    everything at param >= 1, "probabilistic" that fraction of trace ids
    (crc32 of the id, so every node of a trace agrees), "off" nothing.
    Recording happens whatever the sampler says."""

    def __init__(self, limit: int = 1000, exporter=None,
                 sampler_type: str = "const", sampler_param: float = 1.0):
        self.limit = limit
        self._lock = threading.Lock()
        self.spans: list[Span] = []
        self.exporter = exporter
        self.sampler_type = sampler_type
        self.sampler_param = sampler_param

    def start_span(self, name: str, trace_id: Optional[str] = None) -> Span:
        return Span(self, name,
                    trace_id or current_trace_id.get() or new_trace_id())

    def _sampled(self, span: Span) -> bool:
        if self.exporter is None or self.sampler_type == "off":
            return False
        if self.sampler_type == "probabilistic":
            h = zlib.crc32(span.trace_id.encode()) if span.trace_id else 0
            return (h % 10_000) < self.sampler_param * 10_000
        return self.sampler_param >= 1  # const

    def _record(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)
            if len(self.spans) > self.limit:
                self.spans = self.spans[-self.limit:]
        if self._sampled(span):
            self.exporter.export(span)

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
