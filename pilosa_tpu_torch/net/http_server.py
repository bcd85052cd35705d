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
    GET         /info, /version, /schema, /status
    POST        /recalculate-caches

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
    GET         /debug/heat                    (?since=, ?limit=, ?top=)
    GET         /debug/timeseries              (?since=, ?limit=)
    GET         /debug/query-history
    POST        /debug/device-profile          (?seconds=)
    GET         /debug/pprof[/goroutine|/profile]  (?seconds=)

An X-Pilosa-Trace-Id request header becomes the request's trace id.
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
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from pilosa_tpu_torch import planner as _planner
from pilosa_tpu_torch.api import API, ApiError
from pilosa_tpu_torch.encoding.protobuf import CONTENT_TYPE as PROTO_CONTENT_TYPE
from pilosa_tpu_torch.encoding.protobuf import Serializer
from pilosa_tpu_torch.models.field import FieldOptions
from pilosa_tpu_torch.constants import KERNEL_FAMILY_REPS
from pilosa_tpu_torch.utils import heat as _heat
from pilosa_tpu_torch.utils import profile as qprofile
from pilosa_tpu_torch.utils import telemetry as _telemetry
from pilosa_tpu_torch.utils import tracing
from pilosa_tpu_torch.utils.stats import prometheus_exposition

ROUTES: list[tuple[str, re.Pattern, str]] = [
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
    ("GET", re.compile(r"^/debug/vars$"), "get_debug_vars"),
    ("GET", re.compile(r"^/debug/heat$"), "get_debug_heat"),
    ("GET", re.compile(r"^/debug/hbm$"), "get_debug_hbm"),
    ("POST", re.compile(r"^/debug/device-profile$"), "post_device_profile"),
    ("GET", re.compile(r"^/debug/query-history$"), "get_query_history"),
    ("GET", re.compile(r"^/debug/timeseries$"), "get_debug_timeseries"),
    ("GET", re.compile(r"^/metrics$"), "get_metrics"),
    ("GET", re.compile(r"^/debug/pprof(?:/(?P<profile>[^/]*))?$"),
     "get_debug_pprof"),
]

# unknown query arguments on these routes are a 400 (a typo like ?shard=)
ALLOWED_QUERY_ARGS = {"post_query": frozenset({"shards", "columnAttrs",
                                               "excludeRowAttrs",
                                               "excludeColumns", "profile",
                                               "explain"}),
                      "get_export": frozenset({"index", "field", "shard"}),
                      "post_import": frozenset({"clear"}),
                      "post_import_roaring": frozenset({"clear", "remote"}),
                      "get_debug_pprof": frozenset({"seconds"}),
                      "get_debug_timeseries": frozenset({"since", "limit"}),
                      "get_debug_heat": frozenset({"since", "limit", "top"}),
                      "get_debug_hbm": frozenset({"top"}),
                      "post_device_profile": frozenset({"seconds"})}


class Handler:
    """Route dispatch against an API instance; `stats`, `telemetry` (the
    TelemetrySampler) and `device_profiler` back the observability
    routes."""

    def __init__(self, api: API, stats=None, telemetry=None,
                 device_profiler=None):
        self.api = api
        self.stats = stats
        self.telemetry = telemetry
        self.device_profiler = device_profiler
        self.serializer = Serializer()
        self._local = threading.local()  # the request's headers

    def dispatch(self, method: str, path: str, query: dict,
                 body: bytes, headers=None) -> tuple[int, str, bytes]:
        """-> (status, content type, payload)."""
        self._local.headers = headers
        trace = headers.get(tracing.TRACE_HEADER) if headers else None
        token = tracing.current_trace_id.set(trace) if trace else None
        try:
            return self._route(method, path, query, body)
        finally:
            if token is not None:
                tracing.current_trace_id.reset(token)
            self._local.headers = None

    def _header(self, name: str) -> str:
        h = getattr(self._local, "headers", None)
        return (h.get(name) or "") if h is not None else ""

    def _wants_proto(self) -> bool:
        """The client reads protobuf (an Accept header naming it)."""
        return PROTO_CONTENT_TYPE in self._header("Accept")

    def _sends_proto(self) -> bool:
        """The body is protobuf (its Content-Type)."""
        return PROTO_CONTENT_TYPE in self._header("Content-Type")

    def _route(self, method: str, path: str, query: dict,
               body: bytes) -> tuple[int, str, bytes]:
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
            try:
                return getattr(self, name)(match.groupdict(), query, body)
            except ApiError as e:
                return self._error(e.status, str(e), e.code)
            except Exception as e:  # noqa: BLE001 — surface as a 500
                if self.stats is not None:
                    self.stats.count("http/serverErrors")
                return self._error(500, str(e))
        if any(rx.match(path) for _, rx, _ in ROUTES):
            return 405, "application/json", b'{"error": "method not allowed"}'
        return 404, "application/json", b'{"error": "not found"}'

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
                exclude_row_attrs=ex_attrs, exclude_columns=ex_cols)
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
            exclude_columns=ex_cols))

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
        if "values" in req:
            self.api.import_values(params["index"], params["field"],
                                   column_ids=req.get("columnIDs"),
                                   values=req.get("values"),
                                   column_keys=req.get("columnKeys"))
            return self._json({})
        clear = (self._arg(query, "clear") == "true"
                 or bool(req.get("clear", False)))
        self.api.import_bits(params["index"], params["field"],
                             row_ids=req.get("rowIDs"),
                             column_ids=req.get("columnIDs"), clear=clear,
                             timestamps=req.get("timestamps"),
                             row_keys=req.get("rowKeys"),
                             column_keys=req.get("columnKeys"))
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
                   or bool(req.get("clear", False))))
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
        return self._json(snap)

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
        """The fragment heat map (:861): hot and cold lists, exact totals,
        the distribution and skew, and the summary ring since ?since=.
        With heat off (PILOSA_TPU_TORCH_HEAT=0) an empty document."""
        since, limit, top = self._int_args(query, since=0, limit=0, top=20)
        tracker = self.api.executor.heat
        if tracker is None:
            return self._json({"enabled": False, "hot": [], "cold": [],
                               "totals": {}, "trackedFragments": 0,
                               "spilledFragments": 0, "hotFragments": 0,
                               "skew": 1.0, "seq": 0, "samples": []})
        out = tracker.snapshot(top=top)
        out.update(tracker.since(since, limit))
        out["enabled"] = tracker.enabled and _heat.enabled()
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
        ing = ex.ingest_snapshot()
        counts["ingest,op:set"] = ing["setMutations"]
        counts["ingest,op:clear"] = ing["clearMutations"]
        counts["ingestBatches,kind:applied"] = ing["appliedBatches"]
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
        parsed = urlparse(self.path)
        length = int(self.headers.get("Content-Length", 0) or 0)
        body = self.rfile.read(length) if length else b""
        status, ctype, payload = self.handler.dispatch(
            method, parsed.path, parse_qs(parsed.query), body, self.headers)
        self.send_response(status)
        self.send_header("Content-Type", ctype)
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
                 port: int = 0):
        cls = type("BoundHandler", (_RequestHandler,), {"handler": handler})
        self._srv = _Server((host, port), cls)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    @property
    def uri(self) -> str:
        return f"http://{self._srv.server_address[0]}:{self.port}"

    def serve_background(self) -> None:
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        name="pilosa-torch-http", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
