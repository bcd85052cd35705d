"""HTTP surface: a stdlib ThreadingHTTPServer over the API.

Trimmed port of pilosa_tpu/net/http_server.py with the same routes and
JSON shapes for the public endpoints:

    GET         /index                         (the schema)
    GET/POST/DELETE /index/{i}
    POST/DELETE /index/{i}/field/{f}
    POST        /index/{i}/query               (raw PQL body, ?shards=,
                                                ?columnAttrs=true,
                                                ?excludeRowAttrs=true,
                                                ?excludeColumns=true,
                                                ?profile=true,
                                                ?explain=true)
    POST        /index/{i}/field/{f}/import    (JSON body: rowIDs or
                                                rowKeys, columnIDs or
                                                columnKeys, or values;
                                                timestamps for a time
                                                field, ?clear=true)
    POST        /index/{i}/field/{f}/import-roaring/{shard}
                                               (JSON body: views, each a
                                                base64 roaring bitmap, in
                                                Pilosa's format or the
                                                official one; ?clear=true)
    GET         /export                        (?index=&field=&shard=:
                                                text/csv)
    GET         /                              (name and version)
    GET         /info, /version, /schema, /status
    POST        /recalculate-caches
    POST        /cluster/drain                 (JSON {"abort"?}: this
                                                node's graceful drain)
    GET         /cluster/events                (?since=, ?limit=: every
                                                member's events merged in
                                                HLC order)
    GET         /cluster/stats, /cluster/usage, /cluster/hbm, /cluster/heat
                                               (the fleet view: every
                                                member's document merged;
                                                a peer without the route
                                                is "legacy")
    POST        /cluster/resize/abort
    POST        /cluster/resize/remove-node    (JSON {"id"})
    POST        /cluster/resize/set-coordinator (JSON {"id"})

Protobuf bodies (:440-475): a Content-Type of application/x-protobuf
sends a QueryRequest to /query, an ImportRequest or, on an int field, an
ImportValueRequest to /import (:541-560) and an ImportRoaringRequest to
/import-roaring; an Accept of it gets a QueryResponse from /query
(encoding/protobuf.py, no protobuf package needed).

and the observability surface (:610-1330), with the JAX paths, query
arguments and JSON keys, and only the blocks the port has:

    GET         /debug/vars                    (expvar JSON)
    GET         /metrics                       (Prometheus text)
    GET         /debug/hbm                     (?top=)
    GET         /debug/heat                    (?since=, ?limit=, ?top=,
                                                ?advice=true)
    GET         /debug/dashboard               (one self-contained HTML
                                                page)
    GET         /debug/timeseries              (?since=, ?limit=)
    GET         /debug/usage                   (?since=, ?limit=, ?top=)
    GET         /debug/events                  (?since=, ?limit=, ?type=,
                                                ?severity=)
    GET         /debug/query-history
    POST        /debug/device-profile          (?seconds=)
    GET         /debug/pprof[/goroutine|/profile]  (?seconds=)
    POST        /debug/net-coalesce            (the port's own: switch the
                                                fan-out coalescer)

and the cluster's internal routes (:63-79, handlers :1361-1460):

    POST        /internal/query-batch          (the coalesced fan-out
                                                envelope)
    POST        /internal/cluster/message      (schema, shard and node
                                                messages)
    GET         /internal/nodes, /internal/shards/max
    GET         /internal/probe                (?uri=)
    GET         /internal/stats                (this node's fleet-telemetry
                                                document)
    GET         /internal/fragment/nodes       (?index=&shard=)
    GET         /internal/fragment/blocks      (?index=&field=&view=&shard=:
                                                anti-entropy's checksums)
    GET         /internal/fragment/block/data  (the same and &block=)
    GET         /internal/fragment/data        (the fragment's roaring
                                                bytes, for a rebuild or a
                                                resize copy)
    GET         /internal/fragment/views       (?index=&field=&shard=: the
                                                views holding the shard)
    POST        /internal/index/{i}/attr/diff, /internal/index/{i}/field/
                {f}/attr/diff                  (JSON {"blocks",
                                                "blockRange"?}: the
                                                attributes that differ)
    GET         /internal/translate/data       (?offset=)
    POST        /internal/translate/keys       (JSON, or a protobuf
                                                TranslateKeysRequest)
    DELETE      /internal/index/{i}/field/{f}/remote-available-shards/{s}

/query takes ?remote=true (or QueryRequest.Remote): a fan-out
sub-request, run on this node's shards. An X-Pilosa-Trace-Id request
header becomes the request's trace id; the deadline of a request is the
strictest of an X-Pilosa-Deadline header (the remaining seconds of the
coordinator's query), a ?timeout= duration on /query and the server's
query timeout, and a query past it answers 504.

The drain gate (:131-145, :263-290): while this node drains, a new
external query (not ?remote=true, no X-Pilosa-Principal header) gets 503
{"error": "node is draining ...", "code": "shed"} with Retry-After: 1 and
X-Pilosa-Shed-Reason: draining, counted in drain_sheds; internal RPCs
go on. active_queries counts the work routes in flight (query, import,
query-batch), which the drain waits out. /debug/vars has the drain
block and /metrics the drain/draining and drain/activeQueries gauges
and the drain/shedQueries counter, under the JAX names, and /debug/vars
a gossip block (the port's own) while SWIM gossip runs.

Accounting and QoS (:201-394): every request installs its caller's usage
account (utils/accounting.py principal_from_headers: X-Pilosa-Principal,
X-API-Key, a digested Authorization, the remote address) and its QoS
priority (X-Pilosa-Priority, the principal's [qos.principals] override,
or the [qos] default class). An external query (not ?remote=true, no
X-Pilosa-Principal) gets the [qos] default-deadline when it has none and
passes the plane's admission before its body is parsed: a quota refusal
is 429 {"error", "code": "quota-exhausted"}, a shed 503 {"error", "code":
"shed"}, both with Retry-After (whole seconds, at most 30) and
X-Pilosa-Shed-Reason; a refused query, and one the drain shed, lands in
/debug/query-history with its `shed` reason, principal and priority.
Deliberate sheds, the API's cost shed among them, are left out of the
5xx count the health score reads.
/debug/vars has the usage, slo and qos blocks; /metrics the usage/*,
slo/* and qos/* families, every time, zeros included.

The event journal (:192-200, :704-707, :897-939, :1266-1276, :1506-1510):
with `events` (the server's EventJournal) the caller's X-Pilosa-HLC is
merged into the node's clock before dispatch and every response carries
the clock's next stamp; /debug/vars has the events block and /metrics
pilosa_events_total{type=} over the whole registry, zeros included, the
evictions by lane and the retained and spool gauges.

Failpoints (utils/failpoints.py): http.server.dispatch is evaluated
before a matched route's handler runs (:261), so an injected fault
answers a clean JSON 500; /debug/vars has the failpoints block once a
point has been evaluated or anything is armed (:730-736), and /metrics a
failpoints/<name> counter of each point that fired (:983-990). With
tls_certificate and tls_key the listener speaks HTTPS (:1543-1551); a
pair that does not load stops the start.
"""

from __future__ import annotations

import base64
import binascii
import collections
import json
import re
import sys
import threading
import time
import traceback
from datetime import datetime, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from pilosa_tpu_torch import planner as _planner
from pilosa_tpu_torch.analysis.advisor import advise
from pilosa_tpu_torch import qos
from pilosa_tpu_torch.api import API, ApiError
from pilosa_tpu_torch.encoding.protobuf import CONTENT_TYPE as PROTO_CONTENT_TYPE
from pilosa_tpu_torch.encoding.protobuf import Serializer
from pilosa_tpu_torch.models.field import FieldOptions
from pilosa_tpu_torch.net.dashboard import render_dashboard
from pilosa_tpu_torch.constants import KERNEL_FAMILY_REPS
from pilosa_tpu_torch.ops import _build, kernels
from pilosa_tpu_torch.utils import accounting
from pilosa_tpu_torch.utils import events as _events
from pilosa_tpu_torch.utils import failpoints
from pilosa_tpu_torch.utils import heat as _heat
from pilosa_tpu_torch.utils import profile as qprofile
from pilosa_tpu_torch.utils import qctx
from pilosa_tpu_torch.utils import telemetry as _telemetry
from pilosa_tpu_torch.utils import threads as _threads
from pilosa_tpu_torch.utils import tracing
from pilosa_tpu_torch.utils.duration import parse_duration
from pilosa_tpu_torch.utils.stats import prometheus_exposition

ROUTES: list[tuple[str, re.Pattern, str]] = [
    ("GET", re.compile(r"^/$"), "home"),
    ("POST", re.compile(r"^/cluster/drain$"), "post_cluster_drain"),
    ("POST", re.compile(r"^/cluster/resize/abort$"), "post_resize_abort"),
    ("POST", re.compile(r"^/cluster/resize/remove-node$"),
     "post_remove_node"),
    ("POST", re.compile(r"^/cluster/resize/set-coordinator$"),
     "post_set_coordinator"),
    ("GET", re.compile(r"^/export$"), "get_export"),
    ("GET", re.compile(r"^/index$"), "get_indexes"),
    ("GET", re.compile(r"^/index/(?P<index>[^/]+)$"), "get_index"),
    ("POST", re.compile(r"^/index/(?P<index>[^/]+)$"), "post_index"),
    ("DELETE", re.compile(r"^/index/(?P<index>[^/]+)$"), "delete_index"),
    ("POST", re.compile(r"^/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)$"),
     "post_field"),
    ("DELETE", re.compile(
        r"^/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)$"),
     "delete_field"),
    ("POST", re.compile(
        r"^/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/import$"),
     "post_import"),
    ("POST", re.compile(
        r"^/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/import-roaring/"
        r"(?P<shard>[0-9]+)$"), "post_import_roaring"),
    ("POST", re.compile(r"^/index/(?P<index>[^/]+)/query$"), "post_query"),
    ("GET", re.compile(r"^/info$"), "get_info"),
    ("POST", re.compile(r"^/recalculate-caches$"), "post_recalculate_caches"),
    ("GET", re.compile(r"^/schema$"), "get_schema"),
    ("GET", re.compile(r"^/status$"), "get_status"),
    ("GET", re.compile(r"^/version$"), "get_version"),
    ("GET", re.compile(r"^/cluster/stats$"), "get_cluster_stats"),
    ("GET", re.compile(r"^/cluster/usage$"), "get_cluster_usage"),
    ("GET", re.compile(r"^/cluster/heat$"), "get_cluster_heat"),
    ("GET", re.compile(r"^/cluster/hbm$"), "get_cluster_hbm"),
    ("GET", re.compile(r"^/debug/dashboard$"), "get_debug_dashboard"),
    ("GET", re.compile(r"^/debug/vars$"), "get_debug_vars"),
    ("GET", re.compile(r"^/debug/usage$"), "get_debug_usage"),
    ("GET", re.compile(r"^/debug/events$"), "get_debug_events"),
    ("GET", re.compile(r"^/cluster/events$"), "get_cluster_events"),
    ("GET", re.compile(r"^/debug/heat$"), "get_debug_heat"),
    ("GET", re.compile(r"^/debug/hbm$"), "get_debug_hbm"),
    ("POST", re.compile(r"^/debug/device-profile$"), "post_device_profile"),
    ("GET", re.compile(r"^/debug/query-history$"), "get_query_history"),
    ("GET", re.compile(r"^/debug/timeseries$"), "get_debug_timeseries"),
    ("GET", re.compile(r"^/metrics$"), "get_metrics"),
    ("GET", re.compile(r"^/debug/pprof(?:/(?P<profile>[^/]*))?$"),
     "get_debug_pprof"),
    ("POST", re.compile(r"^/debug/net-coalesce$"), "post_net_coalesce"),
    ("POST", re.compile(r"^/internal/cluster/message$"),
     "post_cluster_message"),
    ("GET", re.compile(r"^/internal/fragment/nodes$"), "get_fragment_nodes"),
    ("GET", re.compile(r"^/internal/fragment/block/data$"),
     "get_fragment_block_data"),
    ("GET", re.compile(r"^/internal/fragment/blocks$"), "get_fragment_blocks"),
    ("GET", re.compile(r"^/internal/fragment/data$"), "get_fragment_data"),
    ("GET", re.compile(r"^/internal/fragment/views$"), "get_fragment_views"),
    ("POST", re.compile(r"^/internal/index/(?P<index>[^/]+)/attr/diff$"),
     "post_column_attr_diff"),
    ("POST", re.compile(
        r"^/internal/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/"
        r"attr/diff$"), "post_row_attr_diff"),
    ("DELETE", re.compile(
        r"^/internal/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/"
        r"remote-available-shards/(?P<shard>\d+)$"),
     "delete_remote_available_shard"),
    ("GET", re.compile(r"^/internal/nodes$"), "get_nodes"),
    ("GET", re.compile(r"^/internal/probe$"), "get_internal_probe"),
    ("GET", re.compile(r"^/internal/stats$"), "get_internal_stats"),
    ("POST", re.compile(r"^/internal/query-batch$"), "post_query_batch"),
    ("GET", re.compile(r"^/internal/shards/max$"), "get_shards_max"),
    ("GET", re.compile(r"^/internal/translate/data$"), "get_translate_data"),
    ("POST", re.compile(r"^/internal/translate/keys$"),
     "post_translate_keys"),
]

# unknown query arguments on these routes are a 400 (a typo like ?shard=)
_FRAG_ARGS = frozenset({"index", "field", "view", "shard"})
ALLOWED_QUERY_ARGS = {"post_query": frozenset({"shards", "remote",
                                               "columnAttrs",
                                               "excludeRowAttrs",
                                               "excludeColumns", "timeout",
                                               "profile", "explain"}),
                      "get_fragment_nodes": frozenset({"index", "shard"}),
                      "get_fragment_blocks": _FRAG_ARGS,
                      "get_fragment_block_data": _FRAG_ARGS | {"block"},
                      "get_fragment_data": _FRAG_ARGS,
                      "get_fragment_views": frozenset({"index", "field",
                                                       "shard"}),
                      "get_translate_data": frozenset({"offset"}),
                      "get_export": frozenset({"index", "field", "shard"}),
                      "post_import": frozenset({"clear"}),
                      "post_import_roaring": frozenset({"clear", "remote"}),
                      "get_debug_pprof": frozenset({"seconds"}),
                      "get_debug_timeseries": frozenset({"since", "limit"}),
                      "get_debug_heat": frozenset({"since", "limit", "top",
                                                   "advice"}),
                      "get_debug_usage": frozenset({"since", "limit",
                                                    "top"}),
                      "get_debug_hbm": frozenset({"top"}),
                      "get_debug_events": frozenset({"since", "limit",
                                                     "type", "severity"}),
                      "get_cluster_events": frozenset({"since", "limit"}),
                      "post_device_profile": frozenset({"seconds"})}


class Handler:
    """Route dispatch against an API instance; `stats`, `telemetry` (the
    TelemetrySampler) and `device_profiler` back the observability
    routes, `cluster_message_fn` the cluster's messages, `query_timeout`
    (seconds, 0: none) caps every query's deadline, `qos_plane` (a
    qos.QosPlane, or None) admits external queries, and `events` (an
    EventJournal, or None) serves /debug/events and the HLC headers."""

    def __init__(self, api: API, stats=None, telemetry=None,
                 device_profiler=None, cluster_message_fn=None,
                 query_timeout: float = 0.0, qos_plane=None, events=None):
        self.api = api
        self.stats = stats
        self.telemetry = telemetry
        self.device_profiler = device_profiler
        self.cluster_message_fn = cluster_message_fn
        self.query_timeout = query_timeout
        self.qos = qos_plane
        self.events = events
        self.errors_5xx = 0  # 5xx answers, but deliberate sheds: health
        self.serializer = Serializer()
        self._local = threading.local()  # the request's headers
        # the drain gate (the server's drain sets it) and its counters
        self.draining = False
        self.drain_sheds = 0
        self.active_queries = 0
        self._counter_lock = threading.Lock()
        # fn() -> the gossip block of /debug/vars, while gossip runs
        self.gossip_status_fn = None

    # the routes a drain waits out (and counts as in-flight work)
    WORK_ROUTES = frozenset({"post_query", "post_query_batch",
                             "post_import", "post_import_roaring"})

    def dispatch(self, method: str, path: str, query: dict,
                 body: bytes, headers=None) -> tuple:
        """-> (status, content type, payload), and a dict of response
        headers as a fourth item where there are any. The request's trace
        id, usage account and priority are installed for its handler;
        the caller's address, the principal of last resort, is the one
        the listener set on this thread."""
        self._local.headers = headers
        client_addr = getattr(self._local, "client_addr", None)
        trace = headers.get(tracing.TRACE_HEADER) if headers else None
        token = tracing.current_trace_id.set(trace) if trace else None
        if self.events is not None and headers is not None:
            # what is recorded while serving sorts after the caller's
            stamp = _events.decode_hlc(headers.get(_events.HLC_HEADER))
            if stamp is not None:
                self.events.clock.update(stamp)
        acct_token = prio_token = None
        principal = None
        ledger = self.api.usage_ledger
        if ledger is not None and ledger.enabled and accounting.enabled():
            principal = accounting.principal_from_headers(headers,
                                                          client_addr)
            acct_token = accounting.current_account.set(
                accounting.Account(ledger, principal))
        plane = self.qos
        hdr_priority = self._header(qos.PRIORITY_HEADER) or None
        if qos.enabled() and (plane is not None or hdr_priority):
            if plane is not None:
                if principal is None:
                    principal = accounting.principal_from_headers(
                        headers, client_addr)
                pname = plane.priority_for(hdr_priority, principal)
            else:
                pname = (hdr_priority or "").strip().lower()
                pname = pname if pname in qos.PRIORITIES else None
            if pname:
                prio_token = qos.current_priority.set(pname)
        try:
            return self._route(method, path, query, body, principal)
        finally:
            if token is not None:
                tracing.current_trace_id.reset(token)
            if acct_token is not None:
                accounting.current_account.reset(acct_token)
            if prio_token is not None:
                qos.current_priority.reset(prio_token)
            self._local.headers = None

    def _set_deadline(self, route: str, query: dict):
        """The request's deadline (:148-182): the strictest of the
        coordinator's X-Pilosa-Deadline, a ?timeout= duration on /query
        and the query timeout; a contextvar token, or None."""
        candidates = []
        incoming = self._header(qctx.DEADLINE_HEADER)
        if incoming:
            try:
                candidates.append(float(incoming))
            except ValueError:
                pass  # a malformed header leaves the local sources
        if route == "post_query":
            arg = self._arg(query, "timeout")
            if arg:
                try:
                    secs = parse_duration(arg)
                except ValueError:
                    raise ApiError(f"invalid timeout: {arg!r}")
                if secs > 0:
                    candidates.append(secs)
            if self.query_timeout > 0:
                candidates.append(self.query_timeout)
        if not candidates:
            return None
        return qctx.deadline.set(time.monotonic() + min(candidates))

    def _header(self, name: str) -> str:
        h = getattr(self._local, "headers", None)
        return (h.get(name) or "") if h is not None else ""

    def _wants_proto(self) -> bool:
        """The client reads protobuf (an Accept header naming it)."""
        return PROTO_CONTENT_TYPE in self._header("Accept")

    def _sends_proto(self) -> bool:
        """The body is protobuf (its Content-Type)."""
        return PROTO_CONTENT_TYPE in self._header("Content-Type")

    def _route(self, method: str, path: str, query: dict, body: bytes,
               principal: Optional[str] = None) -> tuple:
        for m, rx, name in ROUTES:
            if m != method:
                continue
            match = rx.match(path)
            if match is None:
                continue
            allowed = ALLOWED_QUERY_ARGS.get(name)
            unknown = set(query) - allowed if allowed is not None else set()
            if unknown:
                return self._error(400, "invalid query argument(s): "
                                   + ", ".join(sorted(unknown)))
            dl_token = qos_dl_token = None
            shed = False
            is_work = name in self.WORK_ROUTES
            if is_work:
                with self._counter_lock:
                    self.active_queries += 1
            try:
                failpoints.hit("http.server.dispatch")
                dl_token = self._set_deadline(name, query)
                external = name == "post_query" and not self._inherited(query)
                if self.draining and external:
                    # a new external query: the client goes to another
                    # replica; a coordinator's fan-out entry finishes
                    shed = True
                    with self._counter_lock:
                        self.drain_sheds += 1
                    if self.qos is not None:
                        self.qos.record_drain_shed()
                    self._record_shed(match, body, principal, "draining",
                                      503)
                    resp = self._error(
                        503, "node is draining (graceful restart): retry "
                             "against another replica", code="shed") + ({
                                 "Retry-After": "1",
                                 "X-Pilosa-Shed-Reason": "draining"},)
                else:
                    rej = None
                    plane = self.qos
                    if plane is not None and qos.enabled() and external:
                        # the [qos] default deadline, for a query that
                        # came with none; then admission, before parsing
                        if (plane.default_deadline > 0
                                and qctx.deadline.get() is None):
                            qos_dl_token = qctx.deadline.set(
                                time.monotonic() + plane.default_deadline)
                        rej = plane.admit(
                            principal or "anonymous",
                            qos.current_priority.get()
                            or plane.default_priority,
                            qctx.remaining())
                    if rej is not None:
                        shed = True
                        self._record_shed(match, body, principal,
                                          rej.reason, rej.status)
                        resp = self._error(
                            rej.status, rej.message,
                            code=("quota-exhausted" if rej.status == 429
                                  else "shed")) + ({
                                "Retry-After":
                                    qos.retry_after_header(rej.retry_after),
                                "X-Pilosa-Shed-Reason": rej.reason},)
                    else:
                        resp = getattr(self, name)(match.groupdict(), query,
                                                   body)
            except qctx.QueryTimeoutError as e:
                resp = self._error(504, str(e))
            except ApiError as e:
                # the API's cost shed is a deliberate shed too (the JAX
                # handler counts it as a server error: ROADMAP Queue C)
                shed = shed or e.code == "shed"
                resp = self._error(e.status, str(e), e.code)
            except Exception as e:  # noqa: BLE001 — surface as a 500
                if self.stats is not None:
                    self.stats.count("http/serverErrors")
                resp = self._error(500, str(e))
            finally:
                if is_work:
                    with self._counter_lock:
                        self.active_queries -= 1
                if qos_dl_token is not None:
                    qctx.deadline.reset(qos_dl_token)
                if dl_token is not None:
                    qctx.deadline.reset(dl_token)
            if resp[0] >= 500 and not shed:
                # the health score's error rate; a shed would feed back
                # into more shedding
                with self._counter_lock:
                    self.errors_5xx += 1
            return resp
        if any(rx.match(path) for _, rx, _ in ROUTES):
            return 405, "application/json", b'{"error": "method not allowed"}'
        return 404, "application/json", b'{"error": "not found"}'

    def _inherited(self, query: dict) -> bool:
        """A query a coordinator fanned out (:359-371): ?remote=true, or
        the principal header every internal RPC carries. The coordinator
        admitted it; admitting it again would charge the user's quota
        once per node."""
        vals = query.get("remote")
        if vals and vals[0] in ("1", "true"):
            return True
        return bool(self._header(accounting.PRINCIPAL_HEADER))

    def _record_shed(self, match, body: bytes, principal, reason: str,
                     status: int) -> None:
        """A refused query into /debug/query-history (:373-394): its
        shed reason, principal, priority and the PQL that never ran."""
        self.api.query_history.append({
            "time": datetime.now(timezone.utc).isoformat(),
            "index": (match.groupdict() or {}).get("index", ""),
            "pql": qprofile.truncate_pql(
                body.decode("utf-8", "replace") if body else ""),
            "shed": reason,
            "status": status,
            "principal": principal or "anonymous",
            "priority": qos.current_priority.get() if qos.enabled()
            else None,
            "traceId": tracing.current_trace_id.get() or "-",
        })

    @staticmethod
    def _error(status: int, msg: str, code: str = ""):
        body = {"error": msg}
        if code:
            body["code"] = code
        return status, "application/json", json.dumps(body).encode()

    @staticmethod
    def _json(payload, status: int = 200):
        return status, "application/json", json.dumps(payload).encode()

    @staticmethod
    def _body_json(body: bytes) -> dict:
        if not body:
            return {}
        try:
            out = json.loads(body)
        except json.JSONDecodeError as e:
            raise ApiError(f"invalid JSON body: {e}")
        if not isinstance(out, dict):
            raise ApiError("JSON body must be an object")
        return out

    @staticmethod
    def _arg(query: dict, name: str, default=None):
        vals = query.get(name)
        return vals[0] if vals else default

    # -- handlers -----------------------------------------------------------

    def _flag(self, query: dict, name: str) -> bool:
        return self._arg(query, name) in ("1", "true")

    def post_query(self, params, query, body):
        """A PQL body, or a QueryRequest; JSON back, or a QueryResponse
        to a client that accepts protobuf (:451-500)."""
        if self._sends_proto():
            try:
                req = self.serializer.decode_query_request(body)
            except ValueError as e:
                raise ApiError(f"invalid QueryRequest: {e}")
            pql, shard_list = req["query"], req["shards"]
            remote = req["remote"]
            column_attrs = req["columnAttrs"]
            ex_attrs, ex_cols = req["excludeRowAttrs"], req["excludeColumns"]
            profile = req["profile"]
        else:
            shards = self._arg(query, "shards")
            try:
                shard_list = ([int(s) for s in shards.split(",")]
                              if shards else None)
            except ValueError:
                raise ApiError(f"invalid shards argument: {shards!r}")
            pql = body.decode()
            remote = self._flag(query, "remote")
            column_attrs = self._flag(query, "columnAttrs")
            ex_attrs = self._flag(query, "excludeRowAttrs")
            ex_cols = self._flag(query, "excludeColumns")
            profile = self._flag(query, "profile")
            if self._flag(query, "explain"):
                # the planned tree instead of the answer: nothing launches
                if self._wants_proto():
                    raise ApiError("explain=true requires a JSON response"
                                   " (drop the protobuf Accept header)")
                return self._json(self.api.explain(params["index"], pql,
                                                   shards=shard_list))
        if self._wants_proto():
            results = self.api.query_results(
                params["index"], pql, shards=shard_list, profile=profile,
                exclude_row_attrs=ex_attrs, exclude_columns=ex_cols,
                remote=remote)
            cas = (self.api.column_attr_sets(params["index"], results)
                   if column_attrs else None)
            prof = None
            if profile:
                got = qprofile.last_profile.get()
                prof = got.to_dict() if got is not None else None
            return 200, PROTO_CONTENT_TYPE, \
                self.serializer.encode_query_response(
                    results, column_attr_sets=cas, profile=prof)
        return self._json(self.api.query(
            params["index"], pql, shards=shard_list, profile=profile,
            column_attrs=column_attrs, exclude_row_attrs=ex_attrs,
            exclude_columns=ex_cols, remote=remote))

    def home(self, params, query, body):
        return self._json({"name": "pilosa-tpu",
                           "version": self.api.version()})

    def get_indexes(self, params, query, body):
        return self._json(self.api.schema())

    def get_index(self, params, query, body):
        for idx in self.api.schema()["indexes"]:
            if idx["name"] == params["index"]:
                return self._json(idx)
        raise ApiError(f"index not found: {params['index']}", status=404)

    def post_index(self, params, query, body):
        opts = self._body_json(body).get("options", {})
        self.api.create_index(params["index"], keys=opts.get("keys", False),
                              track_existence=opts.get("trackExistence", True))
        return self._json({"success": True})

    def delete_index(self, params, query, body):
        self.api.delete_index(params["index"])
        return self._json({"success": True})

    def post_field(self, params, query, body):
        o = self._body_json(body).get("options", {})
        options = FieldOptions(
            type=o.get("type", "set"),
            cache_type=o.get("cacheType", "ranked"),
            cache_size=o.get("cacheSize", 50000),
            min=o.get("min", 0),
            max=o.get("max", 0),
            time_quantum=o.get("timeQuantum", ""),
            keys=o.get("keys", False),
        )
        self.api.create_field(params["index"], params["field"], options)
        return self._json({"success": True})

    def delete_field(self, params, query, body):
        self.api.delete_field(params["index"], params["field"])
        return self._json({"success": True})

    def post_import(self, params, query, body):
        """A JSON body, or a protobuf ImportRequest (ImportValueRequest on
        an int field: the field's type picks the message, :541-560)."""
        if self._sends_proto():
            idx = self.api.holder.index(params["index"])
            fld = idx.field(params["field"]) if idx is not None else None
            try:
                if fld is not None and fld.options.type == "int":
                    req = self.serializer.decode_import_value_request(body)
                else:
                    req = self.serializer.decode_import_request(body)
            except ValueError as e:
                raise ApiError(f"invalid import request: {e}")
        else:
            req = self._body_json(body)
        remote = bool(req.get("remote", False))
        if "values" in req:
            self.api.import_values(params["index"], params["field"],
                                   column_ids=req.get("columnIDs"),
                                   values=req.get("values"),
                                   column_keys=req.get("columnKeys"),
                                   remote=remote)
            return self._json({})
        clear = (self._arg(query, "clear") == "true"
                 or bool(req.get("clear", False)))
        self.api.import_bits(params["index"], params["field"],
                             row_ids=req.get("rowIDs"),
                             column_ids=req.get("columnIDs"), clear=clear,
                             timestamps=req.get("timestamps"),
                             row_keys=req.get("rowKeys"),
                             column_keys=req.get("columnKeys"),
                             remote=remote)
        return self._json({})

    def post_import_roaring(self, params, query, body):
        """A JSON body {"views": {name: base64 roaring bytes}} or a
        protobuf ImportRoaringRequest (:571-586); clear from the query or
        the body."""
        if self._sends_proto():
            try:
                req = self.serializer.decode_import_roaring_request(body)
            except ValueError as e:
                raise ApiError(f"invalid ImportRoaringRequest: {e}")
            views = req["views"]
        else:
            req = self._body_json(body)
            try:
                views = {name: base64.b64decode(data)
                         for name, data in req.get("views", {}).items()}
            except (binascii.Error, TypeError, AttributeError) as e:
                raise ApiError(f"invalid views: {e}")
        self.api.import_roaring(
            params["index"], params["field"], int(params["shard"]), views,
            clear=(self._arg(query, "clear") == "true"
                   or bool(req.get("clear", False))),
            remote=(self._arg(query, "remote") == "true"
                    or bool(req.get("remote", False))))
        return self._json({})

    def get_export(self, params, query, body):
        index, field, shard = (self._arg(query, k)
                               for k in ("index", "field", "shard"))
        if index is None or field is None or shard is None:
            raise ApiError("index, field and shard are required")
        try:
            shard = int(shard)
        except ValueError:
            raise ApiError(f"invalid shard argument: {shard!r}")
        return 200, "text/csv", self.api.export_csv(index, field,
                                                    shard).encode()

    def get_schema(self, params, query, body):
        return self._json(self.api.schema())

    def get_status(self, params, query, body):
        return self._json(self.api.status())

    def get_info(self, params, query, body):
        return self._json(self.api.info())

    def get_version(self, params, query, body):
        return self._json({"version": self.api.version()})

    def post_recalculate_caches(self, params, query, body):
        self.api.recalculate_caches()
        return self._json({})

    # -- the cluster's internal routes ---------------------------------------

    def post_cluster_message(self, params, query, body):
        if self.cluster_message_fn is None:
            raise ApiError("cluster messages not supported", status=501)
        self.cluster_message_fn(self._body_json(body))
        return self._json({})

    def get_fragment_nodes(self, params, query, body):
        index = self._arg(query, "index")
        shard, = self._int_args(query, shard=0)
        return self._json(self.api.shard_nodes(index, shard))

    def _frag_args(self, query: dict) -> tuple:
        shard, = self._int_args(query, shard=0)
        return (self._arg(query, "index"), self._arg(query, "field"),
                self._arg(query, "view"), shard)

    def get_fragment_blocks(self, params, query, body):
        return self._json({"blocks": self.api.fragment_blocks(
            *self._frag_args(query))})

    def get_fragment_block_data(self, params, query, body):
        block, = self._int_args(query, block=0)
        return self._json(self.api.fragment_block_data(
            *self._frag_args(query), block))

    def get_fragment_views(self, params, query, body):
        index, field = self._arg(query, "index"), self._arg(query, "field")
        shard = int(self._arg(query, "shard", "0"))
        return self._json({"views": self.api.fragment_views(index, field,
                                                            shard)})

    # -- membership and lifecycle (:1333-1361) -------------------------------

    def post_cluster_drain(self, params, query, body):
        """Start this node's drain in the background and answer its status
        at once; {"abort": true} cancels a drain in progress."""
        req = self._body_json(body)
        return self._json(self.api.drain(abort=bool(req.get("abort"))))

    def post_resize_abort(self, params, query, body):
        self.api.resize_abort()
        return self._json({})

    def post_remove_node(self, params, query, body):
        node_id = self._body_json(body).get("id")
        if not node_id:
            raise ApiError("id is required")
        self.api.remove_node(node_id)
        return self._json({})

    def post_set_coordinator(self, params, query, body):
        node_id = self._body_json(body).get("id")
        if not node_id:
            raise ApiError("id is required")
        self.api.set_coordinator(node_id)
        return self._json({})

    def get_fragment_data(self, params, query, body):
        return (200, "application/octet-stream",
                self.api.fragment_data(*self._frag_args(query)))

    def post_column_attr_diff(self, params, query, body):
        req = self._body_json(body)
        attrs = self.api.column_attr_diff(params["index"],
                                          req.get("blocks", []),
                                          req.get("blockRange"))
        return self._json({"attrs": {str(k): v for k, v in attrs.items()}})

    def post_row_attr_diff(self, params, query, body):
        req = self._body_json(body)
        attrs = self.api.row_attr_diff(params["index"], params["field"],
                                       req.get("blocks", []),
                                       req.get("blockRange"))
        return self._json({"attrs": {str(k): v for k, v in attrs.items()}})

    def delete_remote_available_shard(self, params, query, body):
        self.api.delete_remote_available_shard(
            params["index"], params["field"], int(params["shard"]))
        return self._json({})

    def get_nodes(self, params, query, body):
        return self._json(self.api.hosts())

    def get_internal_probe(self, params, query, body):
        """Probe another node's /status for the asking node (an indirect
        ping)."""
        target = self._arg(query, "uri")
        if not target:
            raise ApiError("uri is required")
        return self._json({"alive": self.api.probe_peer(target)})

    def post_query_batch(self, params, query, body):
        """A coordinator's coalesced envelope (net/coalesce.py): its
        entries run concurrently through the usual query path; an entry's
        error rides its own QueryResponse.Err."""
        try:
            entries = self.serializer.decode_query_batch_request(body)
        except ValueError as e:
            raise ApiError(str(e))
        return (200, "application/json",
                self.serializer.encode_query_batch_response(
                    self.api.query_batch(entries)))

    def get_shards_max(self, params, query, body):
        return self._json({"standard": self.api.max_shards()})

    def get_translate_data(self, params, query, body):
        offset, = self._int_args(query, offset=0)
        return (200, "application/octet-stream",
                self.api.translate_data(offset))

    def post_translate_keys(self, params, query, body):
        if self._sends_proto():
            try:
                req = self.serializer.decode_translate_keys_request(body)
            except ValueError as e:
                raise ApiError(f"invalid TranslateKeysRequest: {e}")
        else:
            req = self._body_json(body)
        ids = self.api.translate_keys(req.get("index"), req.get("field"),
                                      req.get("keys", []),
                                      create=req.get("create", True))
        if self._wants_proto():
            return (200, PROTO_CONTENT_TYPE,
                    self.serializer.encode_translate_keys_response(ids))
        return self._json({"ids": ids})

    # -- observability ------------------------------------------------------

    def _int_args(self, query: dict, **defaults) -> list:
        try:
            return [int(self._arg(query, k, str(v)))
                    for k, v in defaults.items()]
        except ValueError:
            raise ApiError(" and ".join(defaults) + " must be integers")

    def get_debug_vars(self, params, query, body):
        """The expvar dump (:610-757): the stats snapshot and every block
        of the JAX package's /debug/vars that the port has."""
        snap = self.stats.snapshot() if self.stats is not None else {}
        ex = self.api.executor
        snap["deviceResidency"] = ex.residency.snapshot()
        snap["topnRecountRows"] = ex.topn_recount_rows
        snap["groupByHostSyncs"] = ex.groupby_host_syncs
        if ex.batcher is not None:
            snap["countBatcher"] = ex.batcher.snapshot()
        if ex.sum_batcher is not None:
            snap["planeSumBatcher"] = ex.sum_batcher.snapshot()
        if ex.minmax_batcher is not None:
            snap["minMaxBatcher"] = ex.minmax_batcher.snapshot()
        if ex.planner is not None:
            snap["planner"] = ex.planner.snapshot()
            snap["planner"]["calibration"] = _planner.calibration.snapshot()
        if ex.plan_cache is not None:
            snap["planCache"] = ex.plan_cache.snapshot()
        hbm = ex.hbm_snapshot(top=0)
        snap["hbm"] = {k: hbm[k] for k in (
            "budgetBytes", "residentBytes", "headroomBytes",
            "accountedBytes", "planCacheBytes", "wasteByRep", "allocator",
            "hbmDriftBytes")}
        snap["hybrid"] = ex.hybrid_snapshot()
        snap["ingest"] = ex.ingest_snapshot()
        if ex.heat is not None:
            snap["heat"] = ex.heat.snapshot(top=10)
        snap["kernels"] = _telemetry.kernels.snapshot()
        # the cluster's data plane (:628-690): fan-out coalescing, hedged
        # reads and the route counters
        if ex.coalescer is not None:
            snap["netCoalesce"] = ex.coalescer.snapshot()
        snap["hedges"] = ex.hedge_snapshot()
        snap["iciServing"] = ex.ici_snapshot()
        # hinted handoff and the rejoin read fence (:691-700)
        if ex.hints is not None:
            snap["writeHandoffs"] = ex.hints.snapshot()
        fence = ex.fence_snapshot()
        if any(fence.values()):
            snap["readFence"] = fence
        snap.setdefault("gauges", {}).update(self._process_gauges())
        if self.device_profiler is not None:
            snap["deviceProfiler"] = self.device_profiler.snapshot()
        # frozen bulk loads are not durable until snapshotted (:711-724):
        # the fragments that would lose acknowledged writes on a restart,
        # and how many they have taken
        vol = [{"index": i, "field": f, "view": v, "shard": shard,
                "mutations": frag.volatile_mutations}
               for i, f, v, shard, frag in self.api.holder.walk_fragments()
               if frag._volatile]
        if vol:
            snap["volatileFragments"] = vol
        # quarantined fragments and truncated WAL tails (:726-729)
        damaged = self.api.holder.damaged_fragments()
        if damaged:
            snap["damagedFragments"] = damaged
        fps = failpoints.snapshot()
        if fps["points"] or fps["armed"]:
            snap["failpoints"] = fps
        # this node's drain (:701-703), and gossip while it runs
        if self.api.drain_status_fn is not None:
            snap["drain"] = self.api.drain_status_fn()
        if self.gossip_status_fn is not None:
            g = self.gossip_status_fn()
            if g is not None:
                snap["gossip"] = g
        if self.events is not None:
            snap["events"] = self.events.snapshot()
        # usage, SLO burn rates and the QoS plane (:737-749)
        snap["usage"] = self.api.usage_ledger.snapshot(top=20)
        snap["slo"] = self.api.slo.evaluate()
        if self.qos is not None:
            snap["qos"] = self.qos.snapshot()
        return self._json(snap)

    def get_debug_usage(self, params, query, body):
        """The usage ledger (:838-862): principals by device ms (?top=
        of them, 0: all), exact totals, the delta ring since ?since= and
        the SLO evaluation."""
        since, limit, top = self._int_args(query, since=0, limit=0, top=0)
        ledger = self.api.usage_ledger
        out = ledger.snapshot(top=top)
        out.update(ledger.since(since, limit))
        out["enabled"] = ledger.enabled and accounting.enabled()
        out["slo"] = self.api.slo.evaluate()
        return self._json(out)

    def get_debug_events(self, params, query, body):
        """The event feed (:897-926): events newer than ?since=, the newest
        ?limit=, of one ?type= or ?severity= (lane)."""
        since, limit = self._int_args(query, since=0, limit=0)
        etype = self._arg(query, "type")
        severity = self._arg(query, "severity")
        if severity and severity not in _events.LANES:
            raise ApiError(
                f"invalid severity {severity!r} (expected "
                f"{' | '.join(_events.LANES)})")
        if etype and etype not in _events.EVENT_TYPES:
            raise ApiError(f"unknown event type {etype!r}")
        if self.events is None:
            return self._json({"seq": 0, "enabled": False, "node": "",
                               "events": []})
        out = self.events.since(since, limit, etype=etype,
                                severity=severity)
        out["enabled"] = _events.enabled()
        out["node"] = self.events.node_id
        return self._json(out)

    def get_internal_stats(self, params, query, body):
        """This node's fleet-telemetry document (:958-964), which a peer's
        /cluster/stats fetches; a node without the route answers 404 and
        is reported as legacy."""
        if self.api.node_stats_fn is None:
            raise ApiError("node stats not supported", status=501)
        return self._json(self.api.node_stats_fn())

    def get_cluster_stats(self, params, query, body):
        """The fleet document (:966-972, Server.cluster_stats)."""
        if self.api.cluster_stats_fn is None:
            raise ApiError("cluster stats not supported", status=501)
        return self._json(self.api.cluster_stats_fn())

    def get_cluster_usage(self, params, query, body):
        """The fleet's per-principal usage (:950-956,
        Server.cluster_usage)."""
        if self.api.cluster_usage_fn is None:
            raise ApiError("cluster usage not supported", status=501)
        return self._json(self.api.cluster_usage_fn())

    def get_cluster_hbm(self, params, query, body):
        """The fleet's residency maps (:777-784, Server.cluster_hbm)."""
        if self.api.cluster_hbm_fn is None:
            raise ApiError("cluster hbm not supported", status=501)
        return self._json(self.api.cluster_hbm_fn())

    def get_cluster_heat(self, params, query, body):
        """The fleet's heat map (:941-948, Server.cluster_heat)."""
        if self.api.cluster_heat_fn is None:
            raise ApiError("cluster heat not supported", status=501)
        return self._json(self.api.cluster_heat_fn())

    def get_debug_dashboard(self, params, query, body):
        """The self-contained fleet dashboard (:831-836,
        net/dashboard.py)."""
        return 200, "text/html; charset=utf-8", render_dashboard().encode()

    def get_cluster_events(self, params, query, body):
        """The merged cluster timeline (:928-939, Server.cluster_events)."""
        if self.api.cluster_events_fn is None:
            raise ApiError("cluster events not supported", status=501)
        try:
            limit = int(self._arg(query, "limit", "0"))
        except ValueError:
            raise ApiError("limit must be an integer")
        return self._json(self.api.cluster_events_fn(limit=limit))

    def _process_gauges(self) -> dict:
        """Gauges of this process: the fan-out pool's occupancy, each
        kernel wrapper's launches and the seconds nvcc took for the kernel
        library this process loaded (0: it was built already)."""
        pool = self.api.executor.fanout_pool_stats()
        g = {f"fanoutPool/{k}": float(v) for k, v in pool.items()}
        g.update({f"kernelLaunches/{k}": float(v)
                  for k, v in kernels.launch_counts().items()})
        g["kernelBuild/seconds"] = float(_build.build_info["seconds"])
        client = self.api.executor.client
        if client is not None:
            g["internalClient/bytesSent"] = float(client.bytes_sent)
            g["internalClient/bytesReceived"] = float(client.bytes_received)
        return g

    def post_net_coalesce(self, params, query, body):
        """Switch the fan-out coalescer on or off ({"enabled": bool}; the
        port's run-time form of the JAX bench's in-process switch) and
        answer its snapshot."""
        coal = self.api.executor.coalescer
        if coal is None:
            raise ApiError("no coalescer (PILOSA_TPU_TORCH_NET_COALESCE=0 "
                           "or no cluster)", status=501)
        enabled = self._body_json(body).get("enabled")
        if not isinstance(enabled, bool):
            raise ApiError("enabled must be true or false")
        coal.enabled = enabled
        return self._json(coal.snapshot())

    def get_debug_hbm(self, params, query, body):
        """Device memory by what the residency accounts (:759), joined
        with the CUDA allocator; ?top= bounds the per-field list (default
        64, 0: all)."""
        top, = self._int_args(query, top=64)
        return self._json(self.api.executor.hbm_snapshot(top=top))

    def post_device_profile(self, params, query, body):
        """?seconds= of live traffic under torch.profiler (:786): the
        capture's spool path, the device's busy ms and idle share, and the
        port's kernels the trace names; "busy" or "disabled" answer 200
        too."""
        try:
            seconds = float(self._arg(query, "seconds", "2"))
        except ValueError:
            raise ApiError("seconds must be a number")
        if self.device_profiler is None:
            raise ApiError("device profile not supported", status=501)
        return self._json(self.device_profiler.capture(seconds))

    def get_query_history(self, params, query, body):
        """The queries over long-query-time, newest first (:801)."""
        return self._json({"queries": self.api.query_history.snapshot()})

    def get_debug_timeseries(self, params, query, body):
        """The sampler's ring since the ?since= cursor (:810)."""
        since, limit = self._int_args(query, since=0, limit=0)
        if self.telemetry is None:
            return self._json({"seq": 0, "interval": 0.0, "ringSize": 0,
                               "enabled": False, "samples": []})
        out = self.telemetry.ring.since(since, limit)
        out["interval"] = self.telemetry.interval
        out["ringSize"] = self.telemetry.ring.size
        out["enabled"] = _telemetry.enabled() and self.telemetry.running
        return self._json(out)

    def get_debug_heat(self, params, query, body):
        """The fragment heat map (:861-898): hot and cold lists, exact
        totals, the distribution and skew, and the summary ring since
        ?since=; ?advice=true adds the placement advisor's dry run
        (analysis/advisor.py) over the whole table. With heat off
        (PILOSA_TPU_TORCH_HEAT=0) an empty document."""
        since, limit, top = self._int_args(query, since=0, limit=0, top=20)
        tracker = self.api.executor.heat
        if tracker is None:
            return self._json({"enabled": False, "hot": [], "cold": [],
                               "totals": {}, "trackedFragments": 0,
                               "spilledFragments": 0, "hotFragments": 0,
                               "skew": 1.0, "seq": 0, "samples": []})
        full = (tracker.snapshot(top=0)
                if self._arg(query, "advice") in ("1", "true") else None)
        # with ?top=0 the document and the advice read one snapshot, so
        # advise() of the document gives the advice it carries
        out = (dict(full) if full is not None and top == 0
               else tracker.snapshot(top=top))
        out.update(tracker.since(since, limit))
        out["enabled"] = tracker.enabled and _heat.enabled()
        if full is not None:
            res = self.api.executor.residency
            out["advice"] = advise(full, residency=res.snapshot(),
                                   budget_bytes=res.budget)
        return self._json(out)

    def get_metrics(self, params, query, body):
        """Prometheus text exposition (:974-1287): the stats snapshot with
        the residency, batcher, ingest, hybrid, heat, kernel and device
        memory families merged in, each family the port shares with the
        JAX server under the same name and type; families of full label
        spaces are emitted with zeros, so no alert waits for a first
        event."""
        snap = self.stats.snapshot() if self.stats is not None else {}
        counts = dict(snap.get("counts", {}))
        gauges = dict(snap.get("gauges", {}))
        counts.update({f"failpoints/{name}": c["fired"]
                       for name, c in failpoints.counters().items()
                       if c["fired"]})
        ex = self.api.executor
        res = ex.residency
        rs = res.snapshot()
        gauges["residency/bytes"] = rs["bytes"]
        gauges["residency/budget"] = float(res.budget)
        gauges["residency/entries"] = rs["entries"]
        latest = (self.telemetry.ring.latest()
                  if self.telemetry is not None else {})
        lookups = rs["hits"] + rs["misses"]
        gauges["residency/hitRate"] = latest.get(
            "residency.hit_rate", rs["hits"] / lookups if lookups else 1.0)
        counts["residency/hits"] = rs["hits"]
        counts["residency/misses"] = rs["misses"]
        counts["residency/evictions"] = rs["evictions"]
        counts["residency/heatEvictions"] = rs["heatEvictions"]
        for b, kind in ((ex.batcher, "count"), (ex.sum_batcher, "planeSum"),
                        (ex.minmax_batcher, "minMax")):
            if b is None:
                continue
            bs = b.snapshot()
            counts[f"batcher/{kind}/batches"] = bs["batches"]
            counts[f"batcher/{kind}/queries"] = bs["batched_queries"]
            gauges[f"batcher/{kind}/queueDepth"] = bs["queue_depth"]
        # the planner and the plan cache, zeros included (:1062-1080)
        if ex.planner is not None:
            ps = ex.planner.snapshot()
            counts["planner/plans"] = ps["plans"]
            counts["planner/reorders"] = ps["reorders"]
            counts["planner/pushdowns"] = ps["pushdowns"]
            counts["planner/shortCircuits"] = ps["shortCircuits"]
        pc_bytes = 0
        if ex.plan_cache is not None:
            cs = ex.plan_cache.snapshot()
            counts["planCache/hits"] = cs["hits"]
            counts["planCache/misses"] = cs["misses"]
            counts["planCache/evictions"] = cs["evictions"]
            gauges["planCache/bytes"] = cs["bytes"]
            gauges["planCache/entries"] = cs["entries"]
            pc_bytes = cs["bytes"]
        hs = ex.hedge_snapshot()
        counts["hedges/fired"] = hs["hedgesFired"]
        counts["hedges/won"] = hs["hedgesWon"]
        counts["hedges/cancelled"] = hs["hedgesCancelled"]
        isnap = ex.ici_snapshot()
        counts["iciServing,route:slice_local"] = isnap["sliceLocal"]
        counts["iciServing,route:cross_slice"] = isnap["crossSlice"]
        counts["iciServing,route:fallback"] = isnap["fallback"]
        gauges["iciServing/mode"] = {"off": 0.0, "auto": 1.0,
                                     "on": 2.0}.get(isnap["mode"], 1.0)
        # hinted handoff and the rejoin fence, zeros included (:1106-1129)
        if ex.hints is not None:
            hsnap = ex.hints.snapshot()
            counts["writeHandoffs/queued"] = hsnap["queued"]
            counts["writeHandoffs/replayed"] = hsnap["replayed"]
            counts["writeHandoffs/dropped"] = hsnap["dropped"]
            counts["writeHandoffs/replayFailures"] = hsnap["replayFailures"]
            gauges["writeHandoffs/pendingBytes"] = hsnap["pendingBytes"]
            gauges["writeHandoffs/pendingTargets"] = len(
                hsnap["pendingTargets"])
        fence = ex.fence_snapshot()
        counts["readFence/rerouted"] = fence["rerouted"]
        counts["readFence/refusedRemote"] = fence["refusedRemote"]
        counts["readFence/servedStale"] = fence["servedStale"]
        gauges["readFence/fencedShards"] = fence["fencedShards"]
        damaged = self.api.holder.damaged_fragments()
        gauges["damagedFragments"] = len(damaged)
        gauges["damagedFragmentsNeedingRebuild"] = sum(
            1 for d in damaged if d["needsRebuild"])
        gauges.update(self._process_gauges())
        ing = ex.ingest_snapshot()
        counts["ingest,op:set"] = ing["setMutations"]
        counts["ingest,op:clear"] = ing["clearMutations"]
        counts["ingestBatches,kind:applied"] = ing["appliedBatches"]
        counts["ingestBatches,kind:remote"] = ing["remoteBatches"]
        counts["ingestWal/appends"] = ing["walAppends"]
        counts["ingestWal/ops"] = ing["walOps"]
        counts["ingestPatch,kind:dense"] = ing["patchedDense"]
        counts["ingestPatch,kind:sparse"] = ing["patchedSparse"]
        counts["ingestPatch,kind:dropped"] = ing["patchDropped"]
        counts["ingest/errors"] = ing["errors"]
        gauges["ingest/queueDepth"] = ing["queue_depth"]
        gauges["ingest/enabled"] = 1.0 if ing["enabled"] else 0.0
        hy = ex.hybrid_snapshot()
        counts["hybrid,rep:sparse"] = hy["sparseUploads"]
        counts["hybrid,rep:run"] = hy["runUploads"]
        counts["hybrid,rep:dense"] = hy["denseUploads"]
        counts["hybrid,transition:promoted"] = hy["promoted"]
        counts["hybrid,transition:demoted"] = hy["demoted"]
        counts["hybrid,transition:materialized"] = hy["materialized"]
        counts["hybrid,transition:run"] = hy["runTransitions"]
        for rep, name in (("sparse", "Sparse"), ("run", "Run"),
                          ("dense", "DenseRow")):
            gauges[f"hybridLeaves,rep:{rep}"] = hy[f"resident{name}Leaves"]
            gauges[f"hybridBytes,rep:{rep}"] = hy[f"resident{name}Bytes"]
        gauges["hybrid/threshold"] = float(hy["threshold"])
        gauges["hybrid/runThreshold"] = float(hy["runThreshold"])
        gauges["hybrid/enabled"] = 1.0 if hy["enabled"] else 0.0
        if ex.heat is not None:
            hsnap = ex.heat.snapshot(top=0)
            for f, v in hsnap["totals"].items():
                counts[f"heat/{f}"] = round(v, 3)
            gauges["heat/trackedFragments"] = hsnap["trackedFragments"]
            gauges["heat/spilledFragments"] = hsnap["spilledFragments"]
            gauges["heat/hotFragments"] = hsnap["hotFragments"]
            gauges["heat/skew"] = hsnap["skew"]
            for le, n in hsnap["distribution"].items():
                gauges[f"heatDistribution/score,le:{le}"] = float(n)
        for fam, rep in sorted(KERNEL_FAMILY_REPS.items()):
            for k in ("kernelsDispatches", "kernelsWaitMs", "kernelsWaited",
                      "kernelsH2dBytes", "kernelsD2hBytes"):
                counts.setdefault(f"{k}/{fam},rep:{rep}", 0)
        kcounts, ktimings = _telemetry.kernels.metrics_view()
        counts.update(kcounts)
        timings = dict(snap.get("timings", {}))
        timings.update(ktimings)
        hbm_rep_of = {"row": "dense", "sparse": "sparse", "run": "run"}
        for rep in ("dense", "sparse", "run", "other"):
            gauges[f"hbmResidentBytes,rep:{rep}"] = 0.0
            gauges[f"hbmResidentEntries,rep:{rep}"] = 0.0
        for kind, e in rs["by_kind"].items():
            rep = hbm_rep_of.get(kind, "other")
            gauges[f"hbmResidentBytes,rep:{rep}"] += float(e["bytes"])
            gauges[f"hbmResidentEntries,rep:{rep}"] += float(e["entries"])
        gauges["hbmPlanCacheBytes"] = float(pc_bytes)
        gauges["hbmBudgetBytes"] = float(res.budget)
        gauges["hbmHeadroomBytes"] = float(max(0, res.budget - rs["bytes"]))
        drift = ex.hbm_snapshot(top=1)["hbmDriftBytes"]
        gauges["hbmDriftBytes"] = float(drift) if drift is not None else 0.0
        # usage, SLO and QoS, zeros included (:1217-1254)
        us = self.api.usage_ledger.snapshot()
        for f, v in us["totals"].items():
            counts[f"usage/{f}"] = round(v, 3)
        gauges["usage/trackedPrincipals"] = us["trackedPrincipals"]
        gauges["usage/spilledPrincipals"] = us["spilledPrincipals"]
        for p, e in list(us["principals"].items())[:20]:
            for f in ("deviceMs", "hbmBytes", "rpcBytes", "queueMs",
                      "queries", "errors"):
                counts[f"usage/{f},principal:{p}"] = round(e[f], 3)
        worst = 0.0
        for name, ob in self.api.slo.evaluate().items():
            gauges[f"slo/burnShort,objective:{name}"] = ob["burnShort"]
            gauges[f"slo/burnLong,objective:{name}"] = ob["burnLong"]
            level = {"green": 0.0, "yellow": 1.0, "red": 2.0}[ob["status"]]
            gauges[f"slo/status,objective:{name}"] = level
            worst = max(worst, level)
        gauges["slo/worst"] = worst
        if self.qos is not None:
            qc, qg = self.qos.metrics_series()
            counts.update(qc)
            gauges.update(qg)
        # the drain, zeros included (:1255-1261)
        if self.api.drain_status_fn is not None:
            ds = self.api.drain_status_fn()
            gauges["drain/draining"] = 1.0 if ds["draining"] else 0.0
            gauges["drain/activeQueries"] = ds["activeQueries"]
            counts["drain/shedQueries"] = ds["shedQueries"]
        # the event families over the whole registry, zeros included
        # (:1266-1276)
        if self.events is not None:
            es = self.events.snapshot()
            for t in sorted(_events.EVENT_TYPES):
                counts[f"events,type:{t}"] = es["byType"].get(t, 0)
            for lane, n in es["evicted"].items():
                counts[f"events/evicted,lane:{lane}"] = n
            gauges["events/retained"] = float(
                sum(es["retained"].values()))
            gauges["events/spoolBytes"] = float(es["spoolBytes"])
        snap = dict(snap, counts=counts, gauges=gauges, timings=timings)
        return (200, "text/plain; version=0.0.4; charset=utf-8",
                prometheus_exposition(snap).encode())

    def get_debug_pprof(self, params, query, body):
        """Runtime profiling (:1288): `goroutine` is every thread's stack,
        `profile` samples every thread's frame for ?seconds= (default 2,
        at most 30) and reports the hottest sites."""
        profile = params.get("profile") or ""
        if profile in ("", "index"):
            return self._json({"profiles": ["goroutine", "profile"]})
        if profile == "goroutine":
            stacks = {str(tid): traceback.format_stack(frame)
                      for tid, frame in sys._current_frames().items()}
            return self._json({"threads": len(stacks), "stacks": stacks})
        if profile == "profile":
            try:
                seconds = min(float(self._arg(query, "seconds", 2)), 30.0)
            except ValueError:
                raise ApiError("seconds must be a number")
            hits: collections.Counter = collections.Counter()
            me = threading.get_ident()
            deadline = time.monotonic() + seconds
            samples = 0
            while time.monotonic() < deadline:
                for tid, frame in sys._current_frames().items():
                    if tid == me:
                        continue
                    code = frame.f_code
                    hits[f"{code.co_filename}:{frame.f_lineno} "
                         f"{code.co_name}"] += 1
                samples += 1
                time.sleep(0.005)
            return self._json({"samples": samples, "top": [
                {"site": site, "samples": n}
                for site, n in hits.most_common(50)]})
        return self._error(404, f"unknown profile: {profile}")


class _RequestHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    handler: Handler = None  # injected by HTTPServer

    def _handle(self, method: str):
        if getattr(self.server, "shutting_down", False):
            # a kept-alive connection of a closed server: drop it without
            # an answer, as the process's exit would (:1480-1491)
            self.close_connection = True
            return
        parsed = urlparse(self.path)
        length = int(self.headers.get("Content-Length", 0) or 0)
        body = self.rfile.read(length) if length else b""
        self.handler._local.client_addr = self.client_address[0]
        resp = self.handler.dispatch(
            method, parsed.path, parse_qs(parsed.query), body, self.headers)
        status, ctype, payload = resp[:3]
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        events = self.handler.events
        if events is not None:
            # the caller merges it: its later events sort after this
            # node's
            self.send_header(_events.HLC_HEADER,
                             _events.encode_hlc(events.clock.now()))
        for k, v in (resp[3] if len(resp) > 3 else {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):
        self._handle("GET")

    def do_POST(self):
        self._handle("POST")

    def do_DELETE(self):
        self._handle("DELETE")

    def log_message(self, fmt, *args):
        pass


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # the stdlib backlog of 5 resets connections under a client burst
    request_queue_size = 1024


class HTTPServer:
    """Threaded HTTP server with a background serve loop."""

    def __init__(self, handler: Handler, host: str = "localhost",
                 port: int = 0, tls_certificate: str = "",
                 tls_key: str = ""):
        cls = type("BoundHandler", (_RequestHandler,), {"handler": handler})
        self._srv = _Server((host, port), cls)
        self._scheme = "http"
        if tls_certificate and tls_key:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            try:
                ctx.load_cert_chain(tls_certificate, tls_key)
            except BaseException:
                self._srv.server_close()
                raise
            self._srv.socket = ctx.wrap_socket(self._srv.socket,
                                               server_side=True)
            self._scheme = "https"
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    @property
    def uri(self) -> str:
        return f"{self._scheme}://{self._srv.server_address[0]}:{self.port}"

    def serve_background(self) -> None:
        self._thread = _threads.spawn(self._srv.serve_forever,
                                      name="pilosa-torch-http")

    def close(self) -> None:
        self._srv.shutting_down = True
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
