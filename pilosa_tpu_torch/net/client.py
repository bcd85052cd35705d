"""InternalClient: the node-to-node RPCs over HTTP.

Trimmed port of pilosa_tpu/net/client.py: ClientError (:73) with the
peer's status, error code, Retry-After and X-Pilosa-Shed-Reason;
parse_retry_after and backoff_delay (:35-67); and InternalClient (:91):
per-thread keep-alive connections, one transparent retry when a kept-alive
connection turns out stale (only for failures before a response header
arrived: once headers arrive the peer has run the request, so a failure
while reading the body is terminal and nothing is re-sent), the capped,
jittered retry of a 429/503 that carries Retry-After, the trace id and
the remaining deadline sent along as X-Pilosa-Trace-Id and
X-Pilosa-Deadline (the socket timeout is bounded by the deadline too),
and the calls the data plane makes: query_proto (:317), query_batch_raw
(the coalesced envelope), import_bits (:383), import_roaring,
send_message, nodes, status, translate_keys and translate_data; and those
of liveness and healing (:397-463): fragment_blocks, block_data,
column_attr_diff, row_attr_diff, retrieve_shard and probe_indirect; and
resize's fragment_views (:431). A peer's error code
(`fragment-not-found`, `read-fenced`) rides ClientError.code.

Every request carries the request's usage principal as
X-Pilosa-Principal and its QoS priority as X-Pilosa-Priority (:164-175),
so a remote node charges and orders the work as the original caller's;
query_proto charges its request and response bytes to the caller's
account (rpc_bytes, :337-341).

With `hlc` set (the server's HybridLogicalClock, utils/events.py) every
request carries a fresh stamp as X-Pilosa-HLC and the stamp of every
response, an error's included, is merged (:176-181, :256-264), so what
this node records after an RPC sorts after what the peer recorded while
serving it. debug_events (:483) fetches a peer's /debug/events for the
merged /cluster/events.

Left out: the other calls of the federation (stats, usage, heat, hbm;
ROADMAP Queue A 7g); the failpoint hooks (7j).
"""

from __future__ import annotations

import base64
import http.client
import json
import random
import socket
import threading
import time
import urllib.parse
from typing import Optional

from pilosa_tpu_torch import qos
from pilosa_tpu_torch.utils import accounting
from pilosa_tpu_torch.utils import events as _events
from pilosa_tpu_torch.utils import profile as qprofile
from pilosa_tpu_torch.utils import qctx, tracing

# how many times one RPC is re-issued after a backpressure rejection, and
# the longest Retry-After honored before the error goes back to the caller
# (whose per-shard failover takes over)
BACKPRESSURE_RETRIES = 2
RETRY_AFTER_CAP_S = 2.0
SHED_REASON_HEADER = "X-Pilosa-Shed-Reason"


def parse_retry_after(value: Optional[str]) -> Optional[float]:
    """A Retry-After header -> seconds: delta-seconds or an HTTP date
    (floored at 0); None when absent or unparseable."""
    if not value:
        return None
    value = value.strip()
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    from datetime import datetime, timezone
    from email.utils import parsedate_to_datetime
    try:
        dt = parsedate_to_datetime(value)
    except (TypeError, ValueError):
        return None
    if dt is None:
        return None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return max(0.0, (dt - datetime.now(timezone.utc)).total_seconds())


def backoff_delay(retry_after: float, cap: float = RETRY_AFTER_CAP_S,
                  rng=random.random) -> float:
    """The peer's Retry-After, capped, times a factor in [0.5, 1.0] so
    throttled callers do not return in one burst."""
    base = min(max(retry_after, 0.05), cap)
    return base * (0.5 + 0.5 * rng())


class ClientError(Exception):
    def __init__(self, msg: str, status: int = 0, code: str = "",
                 retry_after: Optional[float] = None,
                 shed_reason: str = ""):
        super().__init__(msg)
        self.status = status
        self.code = code  # the peer's ApiError code
        self.retry_after = retry_after  # seconds, on a 429/503
        # "draining": go to the next replica now, without a backoff
        self.shed_reason = shed_reason


class InternalClient:
    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout
        # per-thread keep-alive connections keyed by (scheme, host:port)
        self._local = threading.local()
        # request and response body bytes of every RPC
        self.bytes_sent = 0
        self.bytes_received = 0
        self._bytes_lock = threading.Lock()
        self.hlc = None  # the node's HybridLogicalClock, set by the server

    # -- low level ----------------------------------------------------------

    def _request(self, method: str, uri: str, path: str,
                 body: Optional[bytes] = None,
                 content_type: str = "application/json",
                 accept: Optional[str] = None,
                 timeout: Optional[float] = None) -> bytes:
        """One RPC. A 429/503 with Retry-After was refused before any
        handler ran, so it is re-sent after a capped, jittered wait, while
        the query's deadline allows; any other error propagates."""
        for attempt in range(BACKPRESSURE_RETRIES + 1):
            try:
                return self._request_once(method, uri, path, body=body,
                                          content_type=content_type,
                                          accept=accept, timeout=timeout)
            except ClientError as e:
                if e.shed_reason == "draining":
                    raise
                if (e.status not in (429, 503) or e.retry_after is None
                        or attempt >= BACKPRESSURE_RETRIES):
                    raise
                delay = backoff_delay(e.retry_after)
                rem = qctx.remaining()
                if rem is not None and delay >= rem:
                    raise
                time.sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover

    def _request_once(self, method: str, uri: str, path: str,
                      body: Optional[bytes] = None,
                      content_type: str = "application/json",
                      accept: Optional[str] = None,
                      timeout: Optional[float] = None) -> bytes:
        headers = {"Content-Type": content_type} if body is not None else {}
        if accept:
            headers["Accept"] = accept
        trace_id = tracing.current_trace_id.get()
        if trace_id:
            headers[tracing.TRACE_HEADER] = trace_id
        acct = accounting.current_account.get()
        if acct is not None:
            headers[accounting.PRINCIPAL_HEADER] = acct.principal
        priority = qos.current_priority.get() if qos.enabled() else None
        if priority:
            headers[qos.PRIORITY_HEADER] = priority
        if self.hlc is not None:
            headers[_events.HLC_HEADER] = _events.encode_hlc(self.hlc.now())
        sock_timeout = timeout if timeout is not None else self.timeout
        rem = qctx.remaining()
        if rem is not None:
            # the remote node re-applies the remaining budget, and a hung
            # peer costs at most the same budget
            if rem <= 0:
                raise qctx.QueryTimeoutError("query deadline exceeded")
            headers[qctx.DEADLINE_HEADER] = f"{rem:.3f}"
            sock_timeout = min(sock_timeout, rem + 0.25)
        split = urllib.parse.urlsplit(uri)
        key = (split.scheme, split.netloc)
        for attempt in (0, 1):
            conn, fresh = self._conn_for(key, sock_timeout)
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
            except socket.timeout as e:
                self._drop_conn(key)
                raise ClientError(f"{method} {path}: timed out: {e}")
            except (ConnectionError, BrokenPipeError,
                    http.client.BadStatusLine,
                    http.client.CannotSendRequest,
                    http.client.RemoteDisconnected) as e:
                self._drop_conn(key)
                if fresh or attempt:
                    raise ClientError(
                        f"{method} {path}: {type(e).__name__}: {e}")
                continue  # a stale keep-alive: reconnect once
            except (OSError, http.client.HTTPException) as e:
                self._drop_conn(key)
                raise ClientError(f"{method} {path}: {type(e).__name__}: {e}")
            # headers arrived: the peer ran the request, nothing from here
            # on is re-sent
            try:
                data = resp.read()
            except socket.timeout as e:
                self._drop_conn(key)
                raise ClientError(f"{method} {path}: timed out: {e}")
            except (OSError, http.client.HTTPException) as e:
                self._drop_conn(key)
                raise ClientError(f"{method} {path}: {type(e).__name__}: {e}")
            clen = resp.getheader("Content-Length")
            if clen is not None and clen.isdigit() and len(data) != int(clen):
                # a body cut at a field boundary can decode cleanly with
                # fields missing: never hand it on
                self._drop_conn(key)
                raise ClientError(f"{method} {path}: short body: read "
                                  f"{len(data)} of {clen} bytes")
            if self.hlc is not None:
                stamp = _events.decode_hlc(resp.getheader(_events.HLC_HEADER))
                if stamp is not None:
                    self.hlc.update(stamp)
            if resp.will_close:
                self._drop_conn(key)
            with self._bytes_lock:
                self.bytes_sent += len(body) if body is not None else 0
                self.bytes_received += len(data)
            if resp.status >= 400:
                detail = data.decode(errors="replace")
                code = ""
                try:
                    code = json.loads(detail).get("code", "")
                except (ValueError, AttributeError):
                    pass
                raise ClientError(
                    f"{method} {path}: {resp.status}: {detail}",
                    status=resp.status, code=code,
                    retry_after=parse_retry_after(
                        resp.getheader("Retry-After")),
                    shed_reason=resp.getheader(SHED_REASON_HEADER) or "")
            return data
        raise AssertionError("unreachable")  # pragma: no cover

    def _conn_for(self, key: tuple, sock_timeout: float):
        """(this thread's connection to key, whether it was just made: a
        send failure on a new connection is a real error)."""
        pool = getattr(self._local, "conns", None)
        if pool is None:
            pool = self._local.conns = {}
        conn = pool.get(key)
        fresh = conn is None
        if fresh:
            scheme, netloc = key
            if scheme == "https":
                conn = http.client.HTTPSConnection(netloc,
                                                   timeout=sock_timeout)
            else:
                conn = http.client.HTTPConnection(netloc,
                                                  timeout=sock_timeout)
            pool[key] = conn
        conn.timeout = sock_timeout
        if conn.sock is not None:
            conn.sock.settimeout(sock_timeout)
        return conn, fresh

    def _drop_conn(self, key: tuple) -> None:
        pool = getattr(self._local, "conns", None)
        conn = pool.pop(key, None) if pool else None
        if conn is not None:
            conn.close()

    def _json(self, method: str, uri: str, path: str, payload=None,
              timeout: Optional[float] = None):
        body = json.dumps(payload).encode() if payload is not None else None
        out = self._request(method, uri, path, body, timeout=timeout)
        return json.loads(out) if out else {}

    # -- the data plane -----------------------------------------------------

    def query_proto(self, uri: str, index: str, pql: str,
                    shards: Optional[list] = None,
                    remote: bool = False) -> list:
        """A query over the protobuf codec; the decoded results. A
        profiled caller asks for the peer's profile and grafts it onto its
        own tree."""
        from pilosa_tpu_torch.encoding.protobuf import CONTENT_TYPE, Serializer
        s = Serializer()
        prof = qprofile.current_profile.get()
        body = s.encode_query_request(pql, shards=shards, remote=remote,
                                      profile=prof is not None)
        # ?remote=true beside the body's flag: a draining node's gate
        # (either package's) reads the URL, and lets a fan-out entry in
        out = self._request("POST", uri, f"/index/{index}/query"
                            + ("?remote=true" if remote else ""), body,
                            CONTENT_TYPE, accept=CONTENT_TYPE)
        acct = accounting.current_account.get()
        if acct is not None:
            acct.charge(rpc_bytes=len(body) + len(out))
        resp = s.decode_query_response(out)
        if resp["err"]:
            raise ClientError(f"remote query: {resp['err']}")
        if prof is not None and resp.get("profile"):
            prof.add_remote_fragment(uri, resp["profile"])
        return resp["results"]

    def query_batch_raw(self, uri: str, entries: list) -> list:
        """The coalesced envelope: read-only entries in one
        POST /internal/query-batch; one serialized QueryResponse per
        entry. Reads only: a stale keep-alive re-sends the envelope."""
        from pilosa_tpu_torch.encoding.protobuf import Serializer
        s = Serializer()
        out = self._request("POST", uri, "/internal/query-batch",
                            s.encode_query_batch_request(entries),
                            "application/json", accept="application/json")
        try:
            return s.decode_query_batch_response_raw(out)
        except Exception as e:  # noqa: BLE001 — fail over like transport
            raise ClientError(
                f"query-batch: malformed response: {type(e).__name__}: {e}")

    def import_bits(self, uri: str, index: str, field: str,
                    payload: dict) -> None:
        self._json("POST", uri, f"/index/{index}/field/{field}/import",
                   payload)

    def import_roaring(self, uri: str, index: str, field: str, shard: int,
                       views: dict, clear: bool = False,
                       remote: bool = False) -> None:
        self._json("POST", uri,
                   f"/index/{index}/field/{field}/import-roaring/{shard}",
                   {"views": {k: base64.b64encode(v).decode()
                              for k, v in views.items()},
                    "clear": clear, "remote": remote})

    def send_message(self, uri: str, message: dict) -> None:
        self._json("POST", uri, "/internal/cluster/message", message)

    # -- liveness and healing -------------------------------------------------

    def fragment_blocks(self, uri: str, index: str, field: str, view: str,
                        shard: int) -> list:
        """[{"id", "checksum"}] of a peer's fragment (hex checksums)."""
        out = self._json("GET", uri,
                         f"/internal/fragment/blocks?index={index}"
                         f"&field={field}&view={view}&shard={shard}")
        return out.get("blocks", [])

    def block_data(self, uri: str, index: str, field: str, view: str,
                   shard: int, block: int) -> dict:
        """{"rowIDs", "columnIDs"} of one block of a peer's fragment."""
        return self._json("GET", uri,
                          f"/internal/fragment/block/data?index={index}"
                          f"&field={field}&view={view}&shard={shard}"
                          f"&block={block}")

    def column_attr_diff(self, uri: str, index: str, blocks: list,
                         block_range=None) -> dict:
        """The peer's column attributes in the blocks whose checksums
        differ from `blocks`; block_range [lo, hi) pages the pull (hi
        None: unbounded)."""
        req: dict = {"blocks": blocks}
        if block_range is not None:
            req["blockRange"] = list(block_range)
        out = self._json("POST", uri, f"/internal/index/{index}/attr/diff",
                         req)
        return {int(k): v for k, v in out.get("attrs", {}).items()}

    def row_attr_diff(self, uri: str, index: str, field: str,
                      blocks: list, block_range=None) -> dict:
        req: dict = {"blocks": blocks}
        if block_range is not None:
            req["blockRange"] = list(block_range)
        out = self._json(
            "POST", uri, f"/internal/index/{index}/field/{field}/attr/diff",
            req)
        return {int(k): v for k, v in out.get("attrs", {}).items()}

    def fragment_views(self, uri: str, index: str, field: str,
                       shard: int) -> list:
        """The views of a peer's field that hold a fragment of the shard
        (a resize follower's first question to its donor)."""
        out = self._json("GET", uri,
                         f"/internal/fragment/views?index={index}"
                         f"&field={field}&shard={shard}")
        return out.get("views", [])

    def retrieve_shard(self, uri: str, index: str, field: str, view: str,
                       shard: int) -> bytes:
        """A peer's fragment as roaring bytes (RetrieveShardFromURI)."""
        return self._request(
            "GET", uri,
            f"/internal/fragment/data?index={index}&field={field}"
            f"&view={view}&shard={shard}")

    def probe_indirect(self, uri: str, target_uri: str,
                       timeout: Optional[float] = None) -> bool:
        """Whether peer `uri` reaches target_uri's /status (an indirect
        ping: a dead node, or only a broken link to it)."""
        out = self._request(
            "GET", uri,
            "/internal/probe?uri=" + urllib.parse.quote(target_uri, safe=""),
            timeout=timeout)
        return bool(json.loads(out).get("alive")) if out else False

    def nodes(self, uri: str, timeout: Optional[float] = None) -> list:
        return json.loads(self._request("GET", uri, "/internal/nodes",
                                        timeout=timeout))

    def status(self, uri: str, timeout: Optional[float] = None) -> dict:
        out = self._request("GET", uri, "/status", timeout=timeout)
        return json.loads(out) if out else {}

    def debug_events(self, uri: str,
                     timeout: Optional[float] = None) -> dict:
        """A peer's event feed (GET /debug/events) for /cluster/events; a
        peer without the route answers 404, which the caller reports as
        a legacy node."""
        out = self._request("GET", uri, "/debug/events", timeout=timeout)
        return json.loads(out) if out else {}

    def fenced_shards(self, uri: str,
                      timeout: Optional[float] = None) -> int:
        """The shards a peer's rejoin read fence holds (/debug/vars
        readFence, which both packages show while it is not all zero)."""
        out = self._request("GET", uri, "/debug/vars", timeout=timeout)
        snap = json.loads(out) if out else {}
        return int(snap.get("readFence", {}).get("fencedShards", 0))

    def translate_keys(self, uri: str, index: str, field: Optional[str],
                       keys: list, create: bool = True) -> list:
        out = self._json("POST", uri, "/internal/translate/keys",
                         {"index": index, "field": field, "keys": keys,
                          "create": create})
        return out.get("ids", [])

    def translate_data(self, uri: str, offset: int = 0) -> bytes:
        return self._request("GET", uri,
                             f"/internal/translate/data?offset={offset}")
