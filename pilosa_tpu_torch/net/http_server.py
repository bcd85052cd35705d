"""HTTP surface: a stdlib ThreadingHTTPServer over the API.

Trimmed port of pilosa_tpu/net/http_server.py with the same routes and
JSON shapes for the endpoints of this slice:

    POST/DELETE /index/{i}
    POST        /index/{i}/field/{f}
    POST        /index/{i}/query               (raw PQL body, ?shards=)
    POST        /index/{i}/field/{f}/import    (JSON body: rowIDs or values)
    GET         /schema
    GET         /status
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from pilosa_tpu_torch.api import API, ApiError
from pilosa_tpu_torch.models.field import FieldOptions

ROUTES: list[tuple[str, re.Pattern, str]] = [
    ("POST", re.compile(r"^/index/(?P<index>[^/]+)$"), "post_index"),
    ("DELETE", re.compile(r"^/index/(?P<index>[^/]+)$"), "delete_index"),
    ("POST", re.compile(r"^/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)$"),
     "post_field"),
    ("POST", re.compile(
        r"^/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/import$"),
     "post_import"),
    ("POST", re.compile(r"^/index/(?P<index>[^/]+)/query$"), "post_query"),
    ("GET", re.compile(r"^/schema$"), "get_schema"),
    ("GET", re.compile(r"^/status$"), "get_status"),
]

# unknown query arguments on these routes are a 400 (a typo like ?shard=)
ALLOWED_QUERY_ARGS = {"post_query": frozenset({"shards"}),
                      "post_import": frozenset({"clear"})}


class Handler:
    """Route dispatch against an API instance."""

    def __init__(self, api: API):
        self.api = api

    def dispatch(self, method: str, path: str, query: dict,
                 body: bytes) -> tuple[int, str, bytes]:
        """-> (status, content type, payload)."""
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

    def post_query(self, params, query, body):
        shards = self._arg(query, "shards")
        try:
            shard_list = ([int(s) for s in shards.split(",")]
                          if shards else None)
        except ValueError:
            raise ApiError(f"invalid shards argument: {shards!r}")
        return self._json(self.api.query(params["index"], body.decode(),
                                         shards=shard_list))

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

    def post_import(self, params, query, body):
        req = self._body_json(body)
        for key in ("rowKeys", "columnKeys", "timestamps"):
            if req.get(key):
                raise ApiError(f"import with {key} not ported yet")
        if "values" in req:
            self.api.import_values(params["index"], params["field"],
                                   column_ids=req.get("columnIDs"),
                                   values=req.get("values"))
            return self._json({})
        clear = (self._arg(query, "clear") == "true"
                 or bool(req.get("clear", False)))
        self.api.import_bits(params["index"], params["field"],
                             row_ids=req.get("rowIDs"),
                             column_ids=req.get("columnIDs"), clear=clear)
        return self._json({})

    def get_schema(self, params, query, body):
        return self._json(self.api.schema())

    def get_status(self, params, query, body):
        return self._json(self.api.status())


class _RequestHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    handler: Handler = None  # injected by HTTPServer

    def _handle(self, method: str):
        parsed = urlparse(self.path)
        length = int(self.headers.get("Content-Length", 0) or 0)
        body = self.rfile.read(length) if length else b""
        status, ctype, payload = self.handler.dispatch(
            method, parsed.path, parse_qs(parsed.query), body)
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
