"""The port's cluster data plane at unit level, against the JAX package.

Placement (fnv64a, jump_hash, partition, shard_nodes over node counts 1-7
and replicas 1-3) equals the JAX functions; `.id` files written by each
package are read by the other; the internal messages' bytes decode under
the JAX Serializer and google.protobuf to the same values, and the JAX
bytes under the port's codec. The NodeCoalescer and the InternalClient
mirror tests/test_coalesce.py: single-flight dedup to one wire entry, the
404 fallback and its TTL, a per-entry error, the disabled coalescer, the
stale keep-alive retry and a mid-response failure that is never re-sent.
Two- and three-node port clusters (on the CPU, in-process) show the
executor's side: a node that dies mid-batch fails over shard by shard, a
hedge wins without counting twice, writes are never hedged nor
coalesced, and the trace id reaches the remote node.
"""

import json
import socket
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.encoding.protobuf import Serializer as JaxSerializer
from pilosa_tpu.parallel import cluster as jax_cluster
from pilosa_tpu.parallel import placement as jax_placement
from pilosa_tpu.proto import pilosa_pb2 as pb
from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu_torch.encoding import protobuf as codec
from pilosa_tpu_torch.encoding.protobuf import Serializer
from pilosa_tpu_torch.net.client import ClientError, InternalClient
from pilosa_tpu_torch.net.coalesce import NodeCoalescer
from pilosa_tpu_torch.parallel import cluster, placement
from pilosa_tpu_torch.server import Server

SW = 1 << 20


# ---------------------------------------------------------------- placement


def test_hashes_match_jax():
    rng = np.random.default_rng(5)
    for _ in range(200):
        data = rng.integers(0, 256, int(rng.integers(0, 40))).astype(
            np.uint8).tobytes()
        assert placement.fnv64a(data) == jax_placement.fnv64a(data)
    for key in rng.integers(0, 1 << 62, 300).tolist():
        for n in range(1, 8):
            assert placement.jump_hash(key, n) == \
                jax_placement.jump_hash(key, n)
    for index in ("i", "d", "startrace", "logins"):
        for shard in list(range(64)) + rng.integers(0, 1 << 40, 64).tolist():
            assert placement.partition(index, shard) == \
                jax_placement.partition(index, shard)


@pytest.mark.parametrize("replicas", [1, 2, 3])
def test_shard_nodes_match_jax(replicas):
    rng = np.random.default_rng(replicas)
    for n_nodes in range(1, 8):
        ids = sorted({f"{rng.integers(1 << 30):x}" for _ in range(n_nodes)})
        ours = cluster.Cluster(ids[0], replica_n=replicas)
        theirs = jax_cluster.Cluster(ids[0], replica_n=replicas)
        ours.set_static([cluster.Node(i, f"http://h{i}") for i in ids])
        theirs.set_static([jax_cluster.Node(i, f"http://h{i}") for i in ids])
        assert ours.coordinator_id == theirs.coordinator_id
        for index in ("i", "d"):
            shards = list(range(300))
            for s in shards:
                assert [n.id for n in ours.shard_nodes(index, s)] == \
                    [n.id for n in theirs.shard_nodes(index, s)]
            assert ours.shards_by_node(index, shards) == \
                theirs.shards_by_node(index, shards)


def test_id_files_cross_read(tmp_path):
    ours = Server(str(tmp_path / "p"), device="cpu")
    pid = ours._load_or_create_id()
    jid = JaxServer._load_or_create_id(
        types.SimpleNamespace(data_dir=str(tmp_path / "j")))
    assert JaxServer._load_or_create_id(
        types.SimpleNamespace(data_dir=str(tmp_path / "p"))) == pid
    assert Server(str(tmp_path / "j"), device="cpu")._load_or_create_id() \
        == jid


# -------------------------------------------------------------------- codec


def test_translate_keys_messages_both_ways():
    ours, theirs = Serializer(), JaxSerializer()
    keys = ["Go", "", "Rust", "é"]
    raw = ours.encode_translate_keys_request("i", "lang", keys)
    assert theirs.decode_translate_keys_request(raw) == \
        {"index": "i", "field": "lang", "keys": keys}
    assert ours.decode_translate_keys_request(
        theirs.encode_translate_keys_request("i", None, keys)) == \
        {"index": "i", "field": None, "keys": keys}
    ids = [1, 2, 1 << 40]
    assert theirs.decode_translate_keys_response(
        ours.encode_translate_keys_response(ids)) == ids
    assert ours.decode_translate_keys_response(
        theirs.encode_translate_keys_response(ids)) == ids
    m = pb.TranslateKeysResponse()
    m.ParseFromString(ours.encode_translate_keys_response(ids))
    assert list(m.IDs) == ids


def test_query_batch_envelope_both_ways():
    ours, theirs = Serializer(), JaxSerializer()
    entries = [{"index": "i", "query": "Count(Row(f=1))", "shards": [0, 3],
                "timeout": 1.5, "traceId": "t1", "profile": True},
               {"index": "i", "query": "TopN(f, n=2)"}]
    assert json.loads(ours.encode_query_batch_request(entries)) == \
        json.loads(theirs.encode_query_batch_request(entries))
    assert ours.decode_query_batch_request(
        theirs.encode_query_batch_request(entries)) == \
        theirs.decode_query_batch_request(
            ours.encode_query_batch_request(entries))
    answers = [([7], ""), (None, "boom"), ([True], "", {"node": "a"})]
    for enc, dec in ((ours, theirs), (theirs, ours)):
        got = dec.decode_query_batch_response(
            enc.encode_query_batch_response(answers))
        assert [g["err"] for g in got] == ["", "boom", ""]
        assert got[0]["results"] == [7] and got[2]["results"] == [True]
        assert got[2]["profile"] == {"node": "a"}


def _proto_fields(message: str) -> dict:
    """{number: (name, type, repeated)} of a message of pilosa.proto."""
    import re
    from pathlib import Path

    text = (Path(pb.__file__).parent / "pilosa.proto").read_text()
    body = re.search(r"message %s \{(.*?)\}" % message, text, re.S).group(1)
    out = {}
    for rep, typ, name, num in re.findall(
            r"^\s*(repeated\s+)?(\w+)\s+(\w+)\s*=\s*(\d+);", body, re.M):
        out[int(num)] = (name, typ, bool(rep))
    return out


@pytest.mark.parametrize("message,schema", [
    ("QueryBatchEntry", codec.QUERY_BATCH_ENTRY),
    ("QueryBatchRequest", codec.QUERY_BATCH_REQUEST),
    ("QueryBatchResponse", codec.QUERY_BATCH_RESPONSE),
    ("TranslateKeysRequest", codec.TRANSLATE_KEYS_REQUEST),
    ("TranslateKeysResponse", codec.TRANSLATE_KEYS_RESPONSE)])
def test_internal_schemas_match_the_proto(message, schema):
    declared = _proto_fields(message)
    assert set(declared) == set(schema)
    for num, (name, typ, rep) in declared.items():
        ours = schema[num]
        assert (ours[0], ours[2]) == (name, rep), (message, num)
        assert (ours[1] == typ if isinstance(ours[1], str)
                else typ in ("QueryBatchEntry", "QueryResponse")), num
    m = codec.decode(codec.QUERY_BATCH_REQUEST, codec.encode(
        codec.QUERY_BATCH_REQUEST, {"Queries": [
            {"Index": "i", "Query": "Count(Row(f=1))", "Shards": [0, 5],
             "Remote": True, "Timeout": 2.5}]}))["Queries"][0]
    assert (m["Index"], m["Query"], m["Shards"].tolist(), m["Remote"],
            m["Timeout"]) == ("i", "Count(Row(f=1))", [0, 5], True, 2.5)


# ------------------------------------------------------ coalescer, client


class FakeClient:
    """query_batch_raw answers an entry with its pql's length (distinct
    pqls, distinct results); query_proto records per-query traffic."""

    def __init__(self, batch_status: int = 0, err_for: str = ""):
        self.batch_calls: list = []
        self.proto_calls: list = []
        self.batch_status = batch_status
        self.err_for = err_for
        self.ser = Serializer()
        self.lock = threading.Lock()

    def query_batch_raw(self, uri, entries):
        with self.lock:
            self.batch_calls.append(list(entries))
        if self.batch_status:
            raise ClientError("scripted", status=self.batch_status)
        return [self.ser.encode_query_response([], err="boom")
                if self.err_for and e["query"] == self.err_for else
                self.ser.encode_query_response([len(e["query"])])
                for e in entries]

    def query_proto(self, uri, index, pql, shards=None, remote=False):
        with self.lock:
            self.proto_calls.append((uri, index, pql))
        return [len(pql)]


def _run_threads(n, fn):
    errs = []

    def wrap(i):
        try:
            fn(i)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]


def test_singleflight_dedup_one_wire_entry():
    fc = FakeClient()
    co = NodeCoalescer(fc, window_s=0.05)
    out, lock = [], threading.Lock()

    def go(i):
        r = co.query("http://n1:1", "idx", "Count(Row(f=7))")
        with lock:
            out.append(r)

    _run_threads(10, go)
    assert all(r == [len("Count(Row(f=7))")] for r in out)
    assert sum(len(b) for b in fc.batch_calls) < 10
    assert co.snapshot()["deduped_queries"] > 0
    assert len({id(r) for r in out}) == len(out)  # decoded per waiter


def test_404_fallback_and_legacy_ttl():
    fc = FakeClient(batch_status=404)
    co = NodeCoalescer(fc, window_s=0.02, legacy_ttl=0.2)

    def go(i):
        pql = "Count(Row(f=%d))" % i
        assert co.query("http://old:1", "idx", pql) == [len(pql)]

    _run_threads(8, go)
    assert len(fc.proto_calls) == 8 and len(fc.batch_calls) >= 1
    snap = co.snapshot()
    assert snap["legacy_nodes"] == 1 and snap["batches"] == 0
    before = len(fc.batch_calls)
    assert co.query("http://old:1", "idx", "Count(Row(f=1))") == \
        [len("Count(Row(f=1))")]
    assert len(fc.batch_calls) == before  # legacy: straight per query
    time.sleep(0.25)
    assert not co._is_legacy("http://old:1")  # the TTL re-probes


def test_per_entry_error_and_disabled_coalescer():
    fc = FakeClient(err_for="Count(Row(f=13))")
    co = NodeCoalescer(fc, window_s=0.05)
    oks, errors = [], []

    def go(i):
        try:
            oks.append(co.query("http://n1:1", "idx", "Count(Row(f=%d))" % i))
        except ClientError as e:
            errors.append((i, str(e)))

    _run_threads(16, go)
    assert len(errors) == 1 and errors[0][0] == 13 and "boom" in errors[0][1]
    assert len(oks) == 15
    fc2 = FakeClient()
    off = NodeCoalescer(fc2)
    off.enabled = False
    assert off.query("http://n1:1", "idx", "Count(Row(f=1))") == \
        [len("Count(Row(f=1))")]
    assert fc2.batch_calls == [] and len(fc2.proto_calls) == 1


class BatchEchoServer:
    """Just enough HTTP for /internal/query-batch: every entry answers
    its pql's length. Scripted per request: "ok", "close-after" (a stale
    keep-alive) or "truncate" (a body cut short after the headers)."""

    def __init__(self, script):
        self.script = list(script)
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.connections = self.requests = 0
        self._lock = threading.Lock()
        self._ser = Serializer()
        threading.Thread(target=self._serve, daemon=True).start()

    @property
    def uri(self):
        return f"http://127.0.0.1:{self.port}"

    def _serve(self):
        self.sock.settimeout(10)
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            with self._lock:
                self.connections += 1
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    @staticmethod
    def _read(conn):
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = conn.recv(65536)
            if not chunk:
                return None
            data += chunk
        head, body = data.split(b"\r\n\r\n", 1)
        clen = 0
        for line in head.decode().split("\r\n"):
            if line.lower().startswith("content-length:"):
                clen = int(line.split(":", 1)[1])
        while len(body) < clen:
            chunk = conn.recv(65536)
            if not chunk:
                return None
            body += chunk
        return body

    def _handle(self, conn):
        try:
            while True:
                body = self._read(conn)
                if body is None:
                    return
                with self._lock:
                    self.requests += 1
                    action = self.script.pop(0) if self.script else "ok"
                resp = self._ser.encode_query_batch_response(
                    [([len(e["query"])], "")
                     for e in json.loads(body)["queries"]])
                payload = (b"HTTP/1.1 200 OK\r\nContent-Type: "
                           b"application/json\r\nContent-Length: "
                           + str(len(resp)).encode() + b"\r\n\r\n" + resp)
                if action == "truncate":
                    conn.sendall(payload[:len(payload) - len(resp) // 2])
                    conn.close()
                    return
                conn.sendall(payload)
                if action == "close-after":
                    conn.close()
                    return
        except OSError:
            pass

    def close(self):
        self.sock.close()


def test_stale_keepalive_retry_is_transparent():
    srv = BatchEchoServer(["close-after"] + ["ok"] * 50)
    try:
        co = NodeCoalescer(InternalClient(timeout=5), window_s=0.01)
        assert co.query(srv.uri, "idx", "Count(Row(f=1))") == \
            [len("Count(Row(f=1))")]
        assert co.query(srv.uri, "idx", "Count(Row(f=2))") == \
            [len("Count(Row(f=2))")]
        assert srv.connections == 2 and srv.requests == 2
    finally:
        srv.close()


def test_mid_response_failure_is_terminal():
    srv = BatchEchoServer(["truncate"])
    try:
        with pytest.raises(ClientError):
            InternalClient(timeout=5).query_batch_raw(
                srv.uri, [{"index": "idx", "query": "Count(Row(f=1))"}])
        time.sleep(0.05)
        assert srv.requests == 1  # never re-sent after the headers
    finally:
        srv.close()


# ------------------------------------------------- executor, in a cluster


def jpost(uri, path, raw: bytes, headers=None):
    req = urllib.request.Request(uri + path, data=raw, method="POST",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _port_cluster(tmp, n_nodes: int, replica_n: int):
    """Pinned ids ("a", "b", ...): this placement splits index "i"'s
    shards over every node."""
    servers = [Server(str(tmp / f"n{i}"), port=0, device="cpu",
                      replica_n=replica_n, node_id=chr(ord("a") + i)).open()
               for i in range(n_nodes)]
    uris = [s.uri for s in servers]
    for s in servers:
        s.cluster_hosts = uris
        s.refresh_membership()
    rng = np.random.default_rng(61)
    universe = rng.choice(6 * SW, 2400, replace=False)
    sets = {}
    rows, cols = [], []
    jpost(uris[0], "/index/i", b"{}")
    jpost(uris[0], "/index/i/field/f", b"{}")
    for row in range(3):
        c = np.unique(rng.choice(universe, 1200))
        sets[row] = set(c.tolist())
        rows += [row] * c.size
        cols += c.tolist()
    st, _ = jpost(uris[0], "/index/i/field/f/import",
                  json.dumps({"rowIDs": rows, "columnIDs": cols}).encode())
    assert st == 200
    expect = len(sets[0] & sets[1])
    deadline = time.monotonic() + 20
    for uri in uris:  # the create-shard announcements are asynchronous
        while jpost(uri, "/index/i/query",
                    b"Count(Intersect(Row(f=0), Row(f=1)))")[1][
                        "results"][0] != expect:
            assert time.monotonic() < deadline
            time.sleep(0.05)
    return servers, uris, sets


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    servers, uris, sets = _port_cluster(tmp_path_factory.mktemp("pair"), 2, 2)
    yield servers, uris, sets
    for s in servers:
        s.close()


def test_hedge_wins_without_double_counting(pair):
    servers, uris, sets = pair
    ex = servers[0].executor
    h = servers[1].handler
    orig = h.post_query_batch

    def slow(params, query, body):
        time.sleep(0.6)
        return orig(params, query, body)

    h.post_query_batch = slow
    ex.hedge_delay = 0.05
    fired, won = ex.hedges_fired, ex.hedges_won
    try:
        t0 = time.perf_counter()
        st, out = jpost(uris[0], "/index/i/query",
                        b"Count(Intersect(Row(f=0), Row(f=1)))")
        assert st == 200 and out["results"][0] == len(sets[0] & sets[1])
        assert time.perf_counter() - t0 < 0.55
        assert ex.hedges_fired > fired and ex.hedges_won > won
    finally:
        ex.hedge_delay = 0.0
        h.post_query_batch = orig


def test_writes_never_hedged_or_coalesced(pair):
    servers, uris, sets = pair
    ex = servers[0].executor
    coal = ex.coalescer
    seen = []
    orig = coal.query

    def spy(uri, index, pql, shards=None):
        seen.append(pql)
        return orig(uri, index, pql, shards=shards)

    base = jpost(uris[0], "/index/i/query",
                 b"Count(Row(f=0))")[1]["results"][0]
    coal.query = spy
    ex.hedge_delay = 0.001  # every read would hedge
    fired = ex.hedges_fired
    try:
        col = 7 * SW + 4242  # past the imported shards: a new shard
        for pql in (f"Set({col}, f=0)", f"Clear({col + 1}, f=1)",
                    "Store(Row(f=2), f=9)", "ClearRow(f=9)",
                    "SetRowAttrs(f, 1, hot=true)",
                    f'SetColumnAttrs({col}, note="x")'):
            assert jpost(uris[0], "/index/i/query", pql.encode())[0] == 200
        assert ex.hedges_fired == fired
        assert not [p for p in seen
                    if any(p.startswith(w) for w in ex.WRITE_CALLS)]
        ex.hedge_delay = 0.0
        for uri in uris:  # the Set landed once, and on every node
            assert jpost(uri, "/index/i/query", b"Count(Row(f=0))")[1][
                "results"][0] == base + 1
    finally:
        ex.hedge_delay = 0.0
        coal.query = orig


def test_trace_id_reaches_the_remote_node(pair):
    servers, uris, sets = pair
    h = servers[1].handler
    seen = []
    orig = h.dispatch

    def spy(method, path, query, body, headers=None):
        if path == "/internal/query-batch":
            seen.append(headers.get("X-Pilosa-Trace-Id"))
        return orig(method, path, query, body, headers)

    h.dispatch = spy
    try:
        st, _ = jpost(uris[0], "/index/i/query", b"Count(Row(f=1))",
                      {"X-Pilosa-Trace-Id": "trace-xyz"})
        assert st == 200 and "trace-xyz" in seen
    finally:
        h.dispatch = orig


def test_mid_batch_node_death_fails_over_per_shard(tmp_path):
    servers, uris, sets = _port_cluster(tmp_path, 3, 2)
    try:
        servers[2].http.close()  # the node dies; membership still lists it
        corpus = [("Count(Intersect(Row(f=0), Row(f=1)))",
                   len(sets[0] & sets[1])),
                  ("Count(Union(Row(f=0), Row(f=2)))", len(sets[0] | sets[2])),
                  ("Count(Difference(Row(f=1), Row(f=2)))",
                   len(sets[1] - sets[2]))]

        def go(i):
            for pql, want in corpus:
                st, out = jpost(uris[i % 2], "/index/i/query", pql.encode())
                assert st == 200 and out["results"][0] == want, (pql, out)

        _run_threads(6, go)
        st, out = jpost(uris[0], "/index/i/query?profile=true",
                        b"Count(Row(f=0))")
        assert out["results"][0] == len(sets[0])
        kinds = [f.get("kind") for f in out["profile"]["fanout"]]
        assert "failover" in kinds or all(
            f["node"] != "c" for f in out["profile"]["fanout"])
    finally:
        for s in servers:
            s.close()


def test_deadline_crosses_nodes(pair):
    """?timeout= becomes the query's deadline, sent on to the remote node
    as X-Pilosa-Deadline (the seconds left); a spent deadline is a 504."""
    servers, uris, sets = pair
    h = servers[1].handler
    seen = []
    orig = h.dispatch

    def spy(method, path, query, body, headers=None):
        if path == "/internal/query-batch":
            seen.append(headers.get("X-Pilosa-Deadline"))
        return orig(method, path, query, body, headers)

    h.dispatch = spy
    try:
        st, out = jpost(uris[0], "/index/i/query?timeout=30s",
                        b"Count(Row(f=2))")
        assert st == 200 and out["results"][0] == len(sets[2])
        assert seen and all(0 < float(s) <= 30 for s in seen), seen
        st, out = jpost(uris[0], "/index/i/query?timeout=1ns",
                        b"Count(Row(f=2))")
        assert st == 504 and "deadline" in out["error"]
    finally:
        h.dispatch = orig


def test_keyed_write_without_the_primary_is_refused(tmp_path):
    """A key the translation primary (node "a") cannot mint fails the
    write through node "b"; it is never acknowledged as unchanged."""
    servers = [Server(str(tmp_path / f"n{i}"), port=0, device="cpu",
                      replica_n=2, node_id=chr(ord("a") + i)).open()
               for i in range(2)]
    try:
        uris = [s.uri for s in servers]
        for s in servers:
            s.cluster_hosts = uris
            s.refresh_membership()
        assert jpost(uris[1], "/index/k", b"{}")[0] == 200
        assert jpost(uris[1], "/index/k/field/lang",
                     b'{"options": {"keys": true}}')[0] == 200
        assert jpost(uris[1], "/index/k/query",
                     b'Set(1, lang="Go")') == (200, {"results": [True]})
        servers[0].http.close()
        st, out = jpost(uris[1], "/index/k/query", b'Set(2, lang="Rust")')
        assert st != 200 and "translation primary" in out["error"], out
        st, out = jpost(uris[1], "/index/k/field/lang/import",
                        b'{"rowKeys": ["Zig"], "columnIDs": [3]}')
        assert st == 503 and "translation primary" in out["error"], out
    finally:
        for s in servers:
            s.close()
