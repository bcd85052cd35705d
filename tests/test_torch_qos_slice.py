"""The port's write-count limit, QoS plane, usage accounting, SLOs and
health over HTTP, against the JAX server's.

Both servers run in-process on the CPU. The write limit: 5000 and 5001
Set() calls, and 5001 each wrapped in Options(), give the same status and
body from both, and a refused request applies no bit. Servers built from
the same [qos] and [slo] TOML (each package's own config loader) give the
same status, body, Retry-After and shed reason for a quota throttle, a
cost shed, a health-red shed and an expired deadline; the priority rides
?profile=true and /debug/vars; observe mode counts without refusing; the
kill switch turns enforcement off; /debug/usage, the /metrics families
and /status health have the JAX names. In port-only and mixed port/JAX
three-node clusters a remote node inherits the caller's principal, its
priority and the shrinking deadline, and an entry whose deadline has
expired is shed on the remote before any launch.
"""

import dataclasses
import http.client
import json
import os
import re
import time
from pathlib import Path
from urllib.parse import urlparse

import numpy as np
import pytest

from pilosa_tpu.cli.config import load_config as jax_load_config
from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu.utils import qctx as jqctx
from pilosa_tpu_torch.cli.config import load_config
from pilosa_tpu_torch.cli.main import server_kwargs
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.utils import qctx as pqctx

SW = 1 << 20


def _req(uri: str, method: str, path: str, body=b"", headers=None):
    """-> (status, response headers, JSON body)."""
    if not isinstance(body, bytes):
        body = (body if isinstance(body, str) else json.dumps(body)).encode()
    u = urlparse(uri)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        raw = resp.read()
        hdrs = {k: v for k, v in resp.getheaders()}
        if resp.getheader("Content-Type", "").startswith("text/plain"):
            return resp.status, hdrs, raw.decode()
        return resp.status, hdrs, json.loads(raw or b"null")
    finally:
        conn.close()


def _query(uri: str, pql: str, headers=None, args: str = ""):
    return _req(uri, "POST", f"/index/i/query{args}", pql, headers)


def _shed_headers(h: dict) -> tuple:
    return h.get("Retry-After"), h.get("X-Pilosa-Shed-Reason")


def _pair(tmp: Path, toml: str = "") -> tuple:
    """A port and a JAX server built by each package's config loader from
    the same TOML, each with index i, field f (rows 0-3 over 3 shards)."""
    cfg = tmp / "n.toml"
    cfg.write_text(toml)
    pc = load_config(str(cfg), environ={})
    kw = server_kwargs(pc)
    kw.update(port=0, device="cpu")
    port = Server(str(tmp / "port"), **kw).open()
    jc = jax_load_config(str(cfg), environ={})
    jkw = {f"qos_{k}": v for k, v in dataclasses.asdict(jc.qos).items()}
    jkw.update({f"slo_{k}": v
                for k, v in dataclasses.asdict(jc.slo).items()})
    jax = JaxServer(str(tmp / "jax"), port=0,
                    max_writes_per_request=jc.max_writes_per_request,
                    **jkw).open()
    rng = np.random.default_rng(3)
    for srv in (port, jax):
        assert _req(srv.uri, "POST", "/index/i", {})[0] == 200
        assert _req(srv.uri, "POST", "/index/i/field/f", {})[0] == 200
    for r in range(4):
        cols = np.unique(rng.choice(3 * SW, 3000 + 500 * r)).tolist()
        for srv in (port, jax):
            st, _, out = _req(srv.uri, "POST", "/index/i/field/f/import",
                              {"rowIDs": [r] * len(cols),
                               "columnIDs": cols})
            assert st == 200, out
    return port, jax


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    port, jax = _pair(tmp_path_factory.mktemp("plain"))
    yield port, jax
    port.close()
    jax.close()


@pytest.mark.parametrize("n,wrapped", [(5000, False), (5001, False),
                                       (5001, True)])
def test_write_limit_matches_jax(plain, n, wrapped):
    base = {5000: 4 * SW, 5001: 5 * SW}[n] + (1 << 19) * wrapped
    calls = [f"Set({base + 7 * k}, f=9)" for k in range(n)]
    if wrapped:
        calls = [f"Options({c}, excludeColumns=false)" for c in calls]
    pql = "".join(calls)
    answers = []
    for srv in plain:
        before = _query(srv.uri, "Count(Row(f=9))")[2]
        st, _, body = _query(srv.uri, pql)
        after = _query(srv.uri, "Count(Row(f=9))")[2]
        answers.append((st, body))
        if n > 5000:
            assert st == 400 and body == {
                "error": f"too many writes in a single request: {n} > "
                         "5000"}, body
            assert after == before  # nothing applied
        else:
            assert st == 200 and body == {"results": [True] * n}
            assert after["results"][0] == before["results"][0] + n
    assert answers[0] == answers[1]


def test_write_limit_zero_means_none(tmp_path):
    cfg = tmp_path / "n.toml"
    cfg.write_text("max-writes-per-request = 0\n")
    kw = server_kwargs(load_config(str(cfg), environ={}))
    kw.update(port=0, device="cpu")
    srv = Server(str(tmp_path / "d"), **kw).open()
    try:
        assert srv.api.max_writes_per_request == 0
        _req(srv.uri, "POST", "/index/i", {})
        _req(srv.uri, "POST", "/index/i/field/f", {})
        st, _, body = _query(srv.uri, "".join(
            f"Set({k}, f=1)" for k in range(5003)))
        assert st == 200 and len(body["results"]) == 5003
    finally:
        srv.close()


_ENFORCE = """
[qos]
mode = "enforce"
[qos.principals."key:slow"]
queries-per-s = 0.01
priority = "batch"
"""


@pytest.fixture(scope="module")
def enforce(tmp_path_factory):
    port, jax = _pair(tmp_path_factory.mktemp("enforce"), _ENFORCE)
    yield port, jax
    port.close()
    jax.close()


def test_quota_throttle_matches_jax(enforce):
    got = []
    for srv in enforce:
        st, h, body = _query(srv.uri, "Count(Row(f=1))",
                             {"X-API-Key": "slow"})
        got.append((st, _shed_headers(h), body))
        # the refusal is in the query history, with its principal
        hist = _req(srv.uri, "GET", "/debug/query-history")[2]["queries"]
        assert any(q.get("shed") == "queriesPerS"
                   and q.get("principal") == "key:slow"
                   and q.get("priority") == "batch" for q in hist), hist
    assert got[0] == got[1]
    assert got[0] == (429, ("30", "queriesPerS"), {
        "error": "query rate quota exhausted for key:slow",
        "code": "quota-exhausted"})
    # another principal is admitted
    for srv in enforce:
        assert _query(srv.uri, "Count(Row(f=1))",
                      {"X-API-Key": "fast"})[0] == 200


def test_cost_shed_matches_jax(enforce):
    got = []
    errors = []
    for srv in enforce:
        srv.qos._class_cost_ms["count"] = 60000.0
        try:
            before = srv.qos.shed["estimatedCost"]
            errors0 = srv.handler.errors_5xx
            st, h, body = _query(srv.uri, "Count(Row(f=2))",
                                 args="?timeout=10s")
            assert srv.qos.shed["estimatedCost"] == before + 1
            errors.append(srv.handler.errors_5xx - errors0)
        finally:
            srv.qos._class_cost_ms.pop("count")
        body["error"] = re.sub(r"deadline \d+ ms", "deadline N ms",
                               body["error"])
        got.append((st, _shed_headers(h), body))
    assert got[0] == got[1]
    assert got[0] == (503, (None, None), {
        "error": "query shed: estimated cost 60000 ms exceeds remaining "
                 "deadline N ms", "code": "shed"})
    # the port leaves the shed out of the health score's 5xx count; the
    # JAX handler counts it (ROADMAP Queue C, faults of the JAX package)
    assert errors == [0, 1]


def test_cost_shed_launches_nothing_on_the_port(enforce):
    port = enforce[0]
    port.qos._class_cost_ms["topn"] = 60000.0
    calls = []
    orig = port.executor.execute
    port.executor.execute = lambda *a, **k: calls.append(a) or orig(*a, **k)
    try:
        before = kernels.launch_counts()
        st, _, _ = _query(port.uri, "TopN(f, n=2)", args="?timeout=5s")
        assert st == 503 and not calls
        assert kernels.launch_counts() == before
    finally:
        del port.executor.execute
        port.qos._class_cost_ms.pop("topn")


def test_expired_deadline_is_shed_before_planning(enforce):
    got = []
    for srv in enforce:
        before = srv.qos.shed["deadline"]
        st, h, body = _query(srv.uri, "Count(Row(f=1))",
                             {"X-Pilosa-Deadline": "-1"})
        got.append((st, _shed_headers(h), body))
        assert srv.qos.shed["deadline"] == before + 1
    assert got[0] == got[1]
    assert got[0] == (503, ("1", "deadline"), {
        "error": "deadline already expired", "code": "shed"})


def test_priority_rides_profile_and_vars(enforce):
    got = []
    for srv in enforce:
        before = _req(srv.uri, "GET", "/debug/vars")[2]["qos"]["admitted"]
        st, _, body = _query(srv.uri, "Count(Row(f=3))",
                             {"X-API-Key": "p", "X-Pilosa-Priority":
                              "batch"}, args="?profile=true")
        assert st == 200
        after = _req(srv.uri, "GET", "/debug/vars")[2]["qos"]["admitted"]
        assert after["batch"] == before["batch"] + 1
        assert after["interactive"] == before["interactive"]
        qnode = body["profile"]["qos"]
        got.append((qnode["priority"], qnode["deadlineMs"],
                    sorted(qnode)))
    assert got[0] == got[1] == ("batch", None,
                                ["deadlineMs", "estimatedWaitMs",
                                 "priority"])


def test_kill_switch_turns_enforcement_off(enforce, monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_TORCH_QOS", "0")
    monkeypatch.setenv("PILOSA_TPU_QOS", "0")
    for srv in enforce:
        assert _query(srv.uri, "Count(Row(f=1))",
                      {"X-API-Key": "slow"})[0] == 200


def test_observe_mode_counts_without_rejecting(tmp_path):
    port, jax = _pair(tmp_path, _ENFORCE.replace("enforce", "observe"))
    try:
        for srv in (port, jax):
            for _ in range(2):
                st, _, _ = _query(srv.uri, "Count(Row(f=1))",
                                  {"X-API-Key": "slow"})
                assert st == 200
        vp = _req(port.uri, "GET", "/debug/vars")[2]["qos"]
        vj = _req(jax.uri, "GET", "/debug/vars")[2]["qos"]
        assert vp["wouldThrottled"] == vj["wouldThrottled"] == {
            "queriesPerS": 2, "deviceMsPerS": 0, "bytesPerS": 0}
        assert vp["throttled"] == vj["throttled"]
        assert sorted(vp) == sorted(vj)
    finally:
        port.close()
        jax.close()


def _families(text: str) -> set:
    """The (name, label names) of the usage, qos and slo samples."""
    out = set()
    for line in text.splitlines():
        m = re.match(r"^(pilosa_(?:usage|qos|qosPrincipal|slo)\w*)"
                     r"(\{[^}]*\})? ", line)
        if m:
            labels = tuple(sorted(re.findall(r'(\w+)="([^"]*)"',
                                             m.group(2) or "")))
            out.add((m.group(1), labels))
    return out


def test_usage_metrics_and_health_have_the_jax_names(tmp_path,
                                                    monkeypatch):
    # the JAX input the port has no counterpart of: its process-wide
    # recompile-storm detector, which other tests' compiles can trip
    from pilosa_tpu.utils import telemetry as jtelemetry
    monkeypatch.setattr(jtelemetry.xla, "storm_active", lambda: False)
    port, jax = _pair(tmp_path, "[slo]\ncount-latency-ms = 0.001\n"
                                "[qos]\nmode = \"enforce\"\n")
    try:
        for srv in (port, jax):
            st, _, st_doc = _req(srv.uri, "GET", "/status")
            assert st_doc["health"] == {"score": "green", "reasons": []}
            for key in ("tenant-a", "tenant-b", "tenant-a"):
                assert _query(srv.uri, "Count(Intersect(Row(f=0), "
                              "Row(f=1)))", {"X-API-Key": key})[0] == 200
        docs = [_req(s.uri, "GET", "/debug/usage?top=5")[2]
                for s in (port, jax)]
        assert sorted(docs[0]) == sorted(docs[1])
        for d in docs:
            assert d["principals"]["key:tenant-a"]["queries"] == 2
            assert d["principals"]["key:tenant-b"]["queries"] == 1
            assert d["slo"]["count-latency"]["status"] == "red"
        assert sorted(docs[0]["principals"]["key:tenant-a"]) == \
            sorted(docs[1]["principals"]["key:tenant-a"])
        assert docs[0]["slo"] == docs[1]["slo"]
        dv = [_req(s.uri, "GET", "/debug/vars")[2] for s in (port, jax)]
        for block in ("usage", "slo", "qos"):
            assert sorted(dv[0][block]) == sorted(dv[1][block]), block
        fams = [_families(_req(s.uri, "GET", "/metrics")[2])
                for s in (port, jax)]
        assert fams[0] == fams[1]
        assert ("pilosa_usage_total", (("key", "queries"),
                                       ("principal", "key:tenant-a"))) \
            in fams[0]
        assert ("pilosa_slo", (("key", "status"),
                               ("objective", "count-latency"))) in fams[0]
        # the SLO burns both windows: health red, then healthRed sheds
        got = []
        for srv in (port, jax):
            health = _req(srv.uri, "GET", "/status")[2]["health"]
            assert health["score"] == "red"
            assert health["reasons"][0].startswith("SLO count-latency")
            # the plane's cached verdict expires (as after HEALTH_TTL_S)
            srv.qos._health = (0.0, "green")
            st, h, body = _query(srv.uri, "Count(Row(f=1))",
                                 {"X-API-Key": "tenant-a"})
            got.append((health, st, _shed_headers(h), body))
        assert got[0] == got[1]
        assert got[0][1:] == (503, ("1", "healthRed"), {
            "error": "node health is red; shedding load", "code": "shed"})
    finally:
        port.close()
        jax.close()


def test_served_keys_reach_the_server(tmp_path):
    """[storage] wal-fsync, [ingest], [cluster] query-history-size,
    [metric] telemetry-ring and usage-*, served from the TOML, and
    GET / answered as the JAX server answers it."""
    cfg = tmp_path / "n.toml"
    cfg.write_text('[storage]\nwal-fsync = "always"\n'
                   '[ingest]\nbatch-window = "5ms"\nmax-batch = 64\n'
                   '[cluster]\nquery-history-size = 7\n'
                   '[metric]\ntelemetry-ring = 9\nusage-ring = 11\n'
                   'usage-max-principals = 3\n')
    kw = server_kwargs(load_config(str(cfg), environ={}))
    kw.update(port=0, device="cpu")
    srv = Server(str(tmp_path / "d"), **kw).open()
    jax = JaxServer(str(tmp_path / "j"), port=0).open()
    try:
        assert srv.executor.ingest.admission_s == 0.005
        assert srv.executor.ingest.max_batch == 64
        assert srv.api.query_history._entries.maxlen == 7
        assert srv.telemetry.ring.size == 9
        assert srv.usage.ring.size == 11 and srv.usage.max_principals == 3
        _req(srv.uri, "POST", "/index/i", {})
        _req(srv.uri, "POST", "/index/i/field/f", {})
        assert _query(srv.uri, "Set(3, f=1)")[0] == 200
        frag = srv.holder.index("i").field("f").views["standard"] \
            .fragments[0]
        assert frag.wal_fsync is True
        got, want = _req(srv.uri, "GET", "/"), _req(jax.uri, "GET", "/")
        assert (got[0], got[2]) == (want[0], want[2]) == (
            200, {"name": "pilosa-tpu", "version": "0.1.0"})
    finally:
        srv.close()
        jax.close()


# ------------------------------------------------------------ the clusters


def _cluster(tmp: Path, kinds: str) -> list:
    """Nodes "a", "b", "c" ('p' a port node, 'j' a JAX node), replicas 1,
    field f over 6 shards."""
    nodes = []
    for i, k in enumerate(kinds):
        d = str(tmp / f"n{i}")
        if k == "p":
            os.makedirs(d)
            Path(d, ".id").write_text("abc"[i])
            nodes.append(Server(d, port=0, device="cpu").open())
        else:
            nodes.append(JaxServer(d, port=0, node_id="abc"[i]).open())
    uris = [n.uri for n in nodes]
    for n in nodes:
        n.cluster_hosts = uris
        n.refresh_membership()
    rng = np.random.default_rng(7)
    assert _req(uris[0], "POST", "/index/i", {})[0] == 200
    assert _req(uris[0], "POST", "/index/i/field/f", {})[0] == 200
    cols = np.unique(rng.choice(6 * SW, 4000)).tolist()
    assert _req(uris[0], "POST", "/index/i/field/f/import",
                {"rowIDs": [0] * len(cols), "columnIDs": cols})[0] == 200
    deadline = time.monotonic() + 30
    for u in uris:  # the create-shard announcements are asynchronous
        while _query(u, "Count(Row(f=0))")[2] != {"results": [len(cols)]}:
            assert time.monotonic() < deadline
            time.sleep(0.05)
    return nodes


@pytest.fixture(scope="module", params=["ppp", "pjp"])
def cluster(request, tmp_path_factory):
    nodes = _cluster(tmp_path_factory.mktemp(request.param), request.param)
    yield nodes
    for n in nodes:
        n.close()


def _spy(nodes, attr: str, record):
    """Wrap each remote node's api.<attr>; -> a function restoring them."""
    saved = []
    for n in nodes[1:]:
        orig = getattr(n.api, attr)
        saved.append((n.api, attr, orig))

        def spy(*a, _orig=orig, _node=n, **k):
            record(_node, a, k)
            return _orig(*a, **k)
        setattr(n.api, attr, spy)

    def restore():
        for api, name, _ in saved:
            delattr(api, name)
    return restore


def test_remote_inherits_principal_and_priority(cluster):
    entries = []
    restore = _spy(cluster, "query_batch",
                   lambda node, a, k: entries.extend(a[0]))
    try:
        for _ in range(2):
            st, _, _ = _query(cluster[0].uri, "Count(Row(f=0))",
                              {"X-API-Key": "tenant-c",
                               "X-Pilosa-Priority": "batch"})
            assert st == 200
    finally:
        restore()
    assert entries and all(e.get("priority") == "batch"
                           and e.get("principal") == "key:tenant-c"
                           for e in entries), entries
    for n in cluster[1:]:
        p = n.usage.snapshot()["principals"].get("key:tenant-c")
        assert p is not None and p["queries"] >= 1, n.uri


def test_remote_sees_the_shrinking_deadline(cluster):
    seen = []

    def record(node, a, k):
        if k.get("remote"):
            mod = pqctx if isinstance(node, Server) else jqctx
            seen.append(mod.remaining())

    restore = _spy(cluster, "query_results", record)
    budget = 5.0
    try:
        t0 = time.monotonic()
        st, _, _ = _query(cluster[0].uri, "Count(Row(f=0))",
                          args=f"?timeout={budget:g}s")
        elapsed = time.monotonic() - t0
        assert st == 200
    finally:
        restore()
    assert seen and all(r is not None and 0 < r < budget
                        and r >= budget - elapsed - 0.5 for r in seen), seen


def test_expired_entry_is_shed_remotely_without_a_launch(cluster):
    port_client = next(n for n in cluster if isinstance(n, Server)).client
    for n in cluster[1:]:
        before = n.qos.shed["deadlineRemote"]
        batches = n.executor.batcher.batches
        launches = kernels.launch_counts()
        raw = port_client.query_batch_raw(n.uri, [
            {"index": "i", "query": "Count(Row(f=0))", "remote": True,
             "timeout": 0.0, "principal": "key:doomed",
             "priority": "interactive"}])
        from pilosa_tpu_torch.encoding.protobuf import Serializer
        resp = Serializer().decode_query_response(raw[0])
        assert "deadline" in resp["err"], resp
        assert n.qos.shed["deadlineRemote"] == before + 1
        assert n.executor.batcher.batches == batches
        assert kernels.launch_counts() == launches
