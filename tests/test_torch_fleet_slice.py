"""The fleet view on running clusters: the port's against the JAX
package's, and mixed clusters of both.

A port and a JAX three-node cluster (in-process, the same seeded data and
the same queries, periodic work off) serve GET /internal/stats,
/cluster/stats, /cluster/usage, /cluster/hbm, /cluster/heat,
/debug/heat?advice=true and /debug/dashboard; each document is held
against the JAX one (exact equality of what both can know alike: ids,
states, health scores and reasons, statuses, key sets, merged counts), a
peer marked down, answering 404, draining or failing degrades alike, and
each merge equals its nodes' own documents. A mixed cluster merges from
either side with every node ok and renders under either dashboard. A
profiled query through a port coordinator with [metric] trace-export
exports one trace with every node's spans; a JAX generate-config file
with export on starts a port node; the advise subcommand prints what the
JAX one prints for the same heat document.
"""

import io
import json
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from chip_smoke import _free_ports
from pilosa_tpu.analysis import advisor as jadv
from pilosa_tpu.cli import main as jcli
from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu.utils import telemetry as jtel
from pilosa_tpu_torch.analysis import advisor as tadv
from pilosa_tpu_torch.cli import main as tcli
from pilosa_tpu_torch.net.client import ClientError
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.utils import heat as theat

ROOT = Path(__file__).resolve().parent.parent
SW = 1 << 20
IDS = ("a", "b", "c")
SHARDS = 4
# no periodic work: samples are taken by the test
QUIET = dict(membership_interval=0.0, telemetry_interval=0.0,
             anti_entropy_interval=0.0, replica_n=2)
PRINCIPALS = ("alice", "bob")


def _req(uri: str, path: str, body: bytes = b"", method: str = "GET",
         headers: dict | None = None) -> tuple:
    req = urllib.request.Request(uri + path, data=body or None,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers.get("Content-Type", ""), \
                resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def _get(uri: str, path: str) -> dict:
    st, _ct, body = _req(uri, path)
    assert st == 200, (path, st, body[:300])
    return json.loads(body)


def _post(uri: str, path: str, body, headers=None) -> dict:
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
    elif isinstance(body, str):
        body = body.encode()
    st, _ct, out = _req(uri, path, body, "POST", headers)
    assert st == 200, (path, st, out[:300])
    return json.loads(out)


def _wait(cond, timeout: float = 30.0, what: str = "") -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.05)


def _legacy(params, query, body):
    return 404, "application/json", b'{"error": "not found"}'


class Trio:
    """Nodes a, b and c, each "p" (the port, on the CPU) or "j" (JAX), on
    fixed ports, loaded with the same seeded rows and asked the same
    queries; `extra[i]` are node i's own keywords."""

    def __init__(self, tmp: Path, kinds: str, extra: dict | None = None):
        self.kinds = kinds
        ports = _free_ports(3)
        self.uris = [f"http://127.0.0.1:{p}" for p in ports]
        self.nodes = []
        for i, kind in enumerate(kinds):
            d = str(tmp / f"{kinds}{i}")
            os.makedirs(d, exist_ok=True)
            kw = dict(port=ports[i], node_id=IDS[i], cluster_hosts=self.uris,
                      **QUIET, **(extra or {}).get(i, {}))
            cls = Server if kind == "p" else JaxServer
            self.nodes.append(cls(d, **kw, **(
                {"device": "cpu"} if kind == "p" else {})).open())
        for n in self.nodes:
            n.refresh_membership()
        _wait(lambda: all(len(n.cluster.nodes) == 3 for n in self.nodes),
              what="membership")
        self._load()

    def _load(self) -> None:
        u = self.uris[0]
        _post(u, "/index/d", {})
        _post(u, "/index/d/field/f", {})
        rng = np.random.default_rng(11)
        rows, cols = [], []
        for r in range(4):
            c = np.unique(rng.integers(0, SHARDS * SW, size=3000 + 500 * r))
            rows += [r] * c.size
            cols += c.tolist()
        _post(u, "/index/d/field/f/import",
              {"rowIDs": rows, "columnIDs": cols})
        _wait(lambda: all(_post(x, "/index/d/query", "Count(Row(f=0))")
                          == _post(u, "/index/d/query", "Count(Row(f=0))")
                          for x in self.uris), what="loaded")
        for k in range(12):
            who = PRINCIPALS[k % 2]
            pql = (f"Count(Intersect(Row(f={k % 4}), Row(f={(k + 1) % 4})))"
                   if k % 3 else f"Count(Row(f={k % 4}))")
            _post(self.uris[k % 2], "/index/d/query", pql,
                  {"X-API-Key": who})
        self.sample()

    def sample(self) -> None:
        jtel.xla.reset()  # no recompile storm from other tests' shapes
        for n in self.nodes:
            n.telemetry.sample_once()

    def close(self) -> None:
        for n in self.nodes:
            if not n.closed:
                n.close()


@pytest.fixture(scope="module")
def trios(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    out = {}
    try:
        for kinds in ("ppp", "jjj"):
            spool = tmp / f"{kinds}-spool.jsonl"
            out[kinds] = Trio(tmp, kinds, {0: dict(
                trace_export="file", trace_export_path=str(spool))})
            out[kinds].spool = spool
        yield out
    finally:
        for t in out.values():
            t.close()


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    t = Trio(tmp_path_factory.mktemp("fleet_mixed"), "pjp")
    yield t
    t.close()


# -- /internal/stats and /cluster/stats ---------------------------------------


def _stats_view(doc: dict) -> dict:
    """What a port and a JAX node report alike."""
    # the JAX input recompileStormActive has no port counterpart (no XLA)
    inputs = {k: v for k, v in doc["healthInputs"].items()
              if k != "recompileStormActive"}
    return {"id": doc["id"], "state": doc["state"], "health": doc["health"],
            "healthInputs": inputs,
            "damagedFragments": doc["damagedFragments"],
            "counters": sorted(doc["counters"]),
            "timeseries": sorted(doc["timeseries"]),
            "samples": len(doc["timeseries"]["samples"])}


def test_internal_stats_matches_jax(trios):
    p, j = (_get(t.uris[1], "/internal/stats") for t in
            (trios["ppp"], trios["jjj"]))
    assert _stats_view(p) == _stats_view(j)
    assert p["uri"] == trios["ppp"].uris[1]
    assert set(p) == set(j)
    # the port compiles nothing per shape: no XLA block; its launches
    # are gauges
    assert p["xla"] is None and j["xla"]["compiles"] >= 0
    assert "residency.bytes" in p["gauges"]
    assert "kernels.dispatches_per_s" in p["gauges"]
    assert "device.bytes_in_use" not in p["gauges"]  # no card here
    assert p["deviceMemory"] == []


def _fleet_view(doc: dict) -> dict:
    f = doc["fleet"]
    return {"health": f["health"], "counts": f["counts"],
            "generatedBy": doc["generatedBy"],
            "nodes": [(n["id"], n["state"], n["health"]) for n in
                      f["nodes"]]}


def test_cluster_stats_matches_jax(trios):
    p, j = (_get(t.uris[0], "/cluster/stats") for t in
            (trios["ppp"], trios["jjj"]))
    assert _fleet_view(p) == _fleet_view(j)
    assert _fleet_view(p)["health"] == "green"
    assert p["fleet"]["counts"] == {"green": 3}
    assert p["fleet"]["nodes"][1]["timeseries"]["samples"]


def _fault(t: Trio, case: str):
    """Put node c in `case` as node a sees it; -> the undo."""
    a, c = t.nodes[0], t.nodes[2]
    if case == "down":
        a.cluster.mark_down("c")
        return lambda: a.cluster.mark_up("c")
    if case == "legacy":
        c.handler.get_internal_stats = _legacy
        return lambda: delattr(c.handler, "get_internal_stats")
    if case == "draining":  # c drains and still answers
        c.draining = True
        return lambda: setattr(c, "draining", False)
    if case == "drained-away":  # a drained peer that stopped answering
        a.cluster.mark_draining("c")
        a.cluster.mark_down("c")

        def undo():
            a.cluster.mark_up("c")
            a.cluster.clear_draining("c")
        return undo
    if case == "failing":
        def boom(params, query, body):
            raise RuntimeError("stats broke")
        c.handler.get_internal_stats = boom
        return lambda: delattr(c.handler, "get_internal_stats")
    raise ValueError(case)


@pytest.mark.parametrize("case,score", [
    ("down", "red"), ("legacy", "legacy"), ("draining", "yellow"),
    ("drained-away", "yellow"), ("failing", "yellow")])
def test_cluster_stats_degrades_like_jax(trios, case, score):
    views = {}
    for kinds in ("ppp", "jjj"):
        t = trios[kinds]
        undo = _fault(t, case)
        try:
            doc = _get(t.uris[0], "/cluster/stats")
        finally:
            undo()
        c = doc["fleet"]["nodes"][2]
        # a failed fetch's reason quotes each package's own error text
        views[kinds] = (doc["fleet"]["health"], doc["fleet"]["counts"],
                        c["id"], c["state"], c["health"]["score"],
                        c["health"]["reasons"] if case != "failing"
                        else len(c["health"]["reasons"]))
    assert views["ppp"] == views["jjj"]
    assert views["ppp"][4] == score
    # legacy never worsens the fleet
    assert views["ppp"][0] == ("green" if score == "legacy" else score)


def test_stats_fetch_is_bounded(trios):
    """A peer that hangs past the fetch timeout is yellow, and the merge
    returns within max(2, probe_timeout) + 1 seconds."""
    t = trios["ppp"]
    c = t.nodes[2]

    def slow(params, query, body):
        time.sleep(4.0)
        return _legacy(params, query, body)

    c.handler.get_internal_stats = slow
    try:
        t0 = time.monotonic()
        doc = t.nodes[0].cluster_stats()
        took = time.monotonic() - t0
    finally:
        del c.handler.get_internal_stats
    assert took < max(2.0, t.nodes[0].probe_timeout) + 1.5
    assert doc["fleet"]["nodes"][2]["health"]["score"] == "yellow"


# -- /cluster/usage, /cluster/hbm, /cluster/heat ------------------------------


def test_cluster_usage_sums_the_nodes_like_jax(trios):
    got = {}
    for kinds in ("ppp", "jjj"):
        t = trios[kinds]
        doc = _get(t.uris[1], "/cluster/usage")
        assert [(n["id"], n["status"]) for n in doc["nodes"]] == \
            [(i, "ok") for i in IDS]
        ledgers = [_get(u, "/debug/usage")["principals"] for u in t.uris]
        for name, e in doc["principals"].items():
            assert e["queries"] == sum(
                led.get(name, {"queries": 0.0})["queries"]
                for led in ledgers)
            assert e["nodes"] == sum(1 for led in ledgers if name in led)
        assert doc["totals"]["queries"] == sum(
            _get(u, "/debug/usage")["totals"]["queries"] for u in t.uris)
        assert doc["generatedBy"] == "b"
        got[kinds] = {k: doc["principals"][f"key:{k}"]["queries"]
                      for k in PRINCIPALS}
        assert set(doc) == {"principals", "totals", "spilledPrincipals",
                            "nodes", "generatedBy", "asOf"}
    # each API key's queries, its fan-out sub-requests included
    assert got["ppp"] == got["jjj"]


@pytest.mark.parametrize("route,handler", [
    ("/cluster/usage", "get_debug_usage"), ("/cluster/hbm", "get_debug_hbm"),
    ("/cluster/heat", "get_debug_heat")])
def test_fleet_merges_mark_a_404_peer_legacy(trios, route, handler):
    for kinds in ("ppp", "jjj"):
        t = trios[kinds]
        setattr(t.nodes[2].handler, handler, _legacy)
        try:
            doc = _get(t.uris[0], route)
        finally:
            delattr(t.nodes[2].handler, handler)
        assert {n["id"]: n["status"] for n in doc["nodes"]} == {
            "a": "ok", "b": "ok", "c": "legacy"}, kinds


def test_fleet_merges_skip_a_down_peer(trios):
    for kinds in ("ppp", "jjj"):
        t = trios[kinds]
        t.nodes[0].cluster.mark_down("c")
        try:
            docs = [_get(t.uris[0], r) for r in
                    ("/cluster/usage", "/cluster/hbm", "/cluster/heat",
                     "/cluster/events")]
        finally:
            t.nodes[0].cluster.mark_up("c")
        for doc in docs:
            assert {n["id"]: n["status"] for n in doc["nodes"]} == {
                "a": "ok", "b": "ok", "c": "down"}


def test_client_404_is_a_client_error_with_its_status(trios):
    t = trios["ppp"]
    client = t.nodes[0].client
    for call, handler in (("node_stats", "get_internal_stats"),
                          ("debug_usage", "get_debug_usage"),
                          ("debug_heat", "get_debug_heat"),
                          ("debug_hbm", "get_debug_hbm")):
        assert isinstance(getattr(client, call)(t.uris[2], 5.0), dict)
        setattr(t.nodes[2].handler, handler, _legacy)
        try:
            with pytest.raises(ClientError) as e:
                getattr(client, call)(t.uris[2], 5.0)
            assert e.value.status == 404
        finally:
            delattr(t.nodes[2].handler, handler)


def test_cluster_hbm_sums_the_nodes(trios):
    keys = {}
    for kinds in ("ppp", "jjj"):
        t = trios[kinds]
        doc = _get(t.uris[0], "/cluster/hbm")
        own = [_get(u, "/debug/hbm?top=0") for u in t.uris]
        assert doc["totals"] == {
            f: sum(int(d.get(f, 0) or 0) for d in own)
            for f in ("residentBytes", "budgetBytes", "headroomBytes",
                      "planCacheBytes", "entries")}
        assert sorted(doc["byNode"]) == list(IDS)
        assert doc["totals"]["residentBytes"] > 0
        keys[kinds] = (sorted(doc), sorted(doc["totals"]))
    assert keys["ppp"] == keys["jjj"]


def test_cluster_heat_merges_the_nodes_like_jax(trios):
    frags = {}
    for kinds in ("ppp", "jjj"):
        t = trios[kinds]
        doc = _get(t.uris[0], "/cluster/heat")
        own = {i: _get(u, "/debug/heat?top=0") for i, u in
               zip(IDS, t.uris)}
        want = (theat.merge_heat_docs(own) if kinds == "ppp" else
                __import__("pilosa_tpu.utils.heat").utils.heat
                .merge_heat_docs(own))
        # cumulative charges summed over the replicas; scores decay
        # between the reads

        def view(d):
            return {(e["index"], e["field"], e["view"], e["shard"]):
                    (e["nodes"], [e[f] for f in theat.FIELDS])
                    for e in d["hot"]}

        assert view(doc) == view(want)
        assert doc["totals"] == want["totals"]
        nodes = {n["id"]: n for n in doc["nodes"]}
        for i in IDS:
            assert nodes[i]["status"] == "ok"
            assert nodes[i]["trackedFragments"] == \
                own[i]["trackedFragments"]
        frags[kinds] = {k: v[0] for k, v in view(doc).items()}
    # the same fragments, each on as many nodes, in both packages
    assert frags["ppp"] == frags["jjj"] and frags["ppp"]


def _reader(t: Trio) -> str:
    """The URI of a node that read fragments as a first owner (of 4
    shards, a node may own none first)."""
    return next(u for u in t.uris if _get(u, "/debug/heat?top=0")["hot"])


def test_debug_heat_advice_is_advise_of_its_document(trios):
    t = trios["ppp"]
    doc = _get(_reader(t), "/debug/heat?advice=true&top=0")
    adv = doc["advice"]
    res = adv["residency"]
    want = jadv.advise(doc, residency=res, budget_bytes=res["budget"])
    assert adv == tadv.advise(doc, residency=res,
                              budget_bytes=res["budget"]) == want
    assert adv["dryRun"] and adv["hbmPinSet"]
    jdoc = _get(_reader(trios["jjj"]), "/debug/heat?advice=true")
    assert sorted(jdoc["advice"]) == sorted(adv)
    assert sorted(_get(t.uris[0], "/debug/heat?advice=1")) == sorted(jdoc)
    for kinds in ("ppp", "jjj"):
        st, _ct, _b = _req(trios[kinds].uris[0], "/debug/heat?hot=1")
        assert st == 400


# -- mixed clusters -----------------------------------------------------------


def _renders(doc: dict) -> None:
    """The fields either dashboard's fleet table reads, with their
    types (a missing gauge renders as a dash)."""
    for n in doc["fleet"]["nodes"]:
        assert isinstance(n["health"]["score"], str)
        assert isinstance(n["health"]["reasons"], list)
        assert isinstance(n["id"], str) and isinstance(n["uri"], str)
        assert isinstance(n["gauges"], dict)
        assert isinstance(n["timeseries"]["samples"], list)
        assert isinstance(n["uptimeSeconds"], int)
        assert isinstance(n["damagedFragments"], int)


@pytest.mark.parametrize("via", [0, 1], ids=["port-merges-jax",
                                             "jax-merges-port"])
def test_mixed_cluster_merges_from_either_side(mixed, via):
    mixed.sample()
    u = mixed.uris[via]
    stats = _get(u, "/cluster/stats")
    assert stats["fleet"]["counts"] == {"green": 3}
    _renders(stats)
    xla = [n["xla"] for n in stats["fleet"]["nodes"]]
    assert xla[0] is None and xla[2] is None and xla[1]["compiles"] >= 0
    for route in ("/cluster/usage", "/cluster/hbm", "/cluster/heat",
                  "/cluster/events"):
        doc = _get(u, route)
        assert [(n["id"], n["status"]) for n in doc["nodes"]] == \
            [(i, "ok") for i in IDS], route
    hbm = _get(u, "/cluster/hbm")
    assert hbm["totals"]["residentBytes"] == sum(
        _get(x, "/debug/hbm?top=0")["residentBytes"] for x in mixed.uris)
    usage = _get(u, "/cluster/usage")
    assert usage["totals"]["queries"] == sum(
        _get(x, "/debug/usage")["totals"]["queries"] for x in mixed.uris)
    heat = _get(u, "/cluster/heat")
    assert heat["hot"] and {n["id"] for n in heat["nodes"]} == set(IDS)


# -- trace export ---------------------------------------------------------------


def _tags(s: dict) -> dict:
    return {t["key"]: t["value"] for t in s.get("tags", [])}


def _exported(t: Trio, trace_id: str) -> list:
    t.nodes[0].trace_exporter.flush()
    batches = [json.loads(x) for x in t.spool.read_text().splitlines()]
    return [s for b in batches for s in b["spans"]
            if s["traceID"] == trace_id]


def test_profiled_query_exports_one_trace_across_nodes(trios):
    """tests/test_accounting.py:438 on a port coordinator, and the same
    span tree shape as the JAX coordinator's."""
    shapes = {}
    for kinds in ("ppp", "jjj"):
        t = trios[kinds]
        out = _post(t.uris[0], "/index/d/query?profile=true",
                    "Count(Intersect(Row(f=1), Row(f=2)))",
                    {"X-API-Key": "tracer"})
        trace_id = out["profile"]["traceId"]
        assert any(r.get("profile")
                   for r in out["profile"]["remoteProfiles"])
        spans = _exported(t, trace_id)
        by_id = {s["spanID"]: s for s in spans}
        # one pilosa.query root; the recording tracer's flat executor
        # spans of the same trace have no parent either
        roots = [s for s in spans if not s["references"]
                 and s["operationName"] == "pilosa.query"]
        assert len(roots) == 1 and _tags(roots[0])["node"] == "a"
        assert {s["operationName"] for s in spans if not s["references"]
                } <= {"pilosa.query", "executor.Count"}
        remote = [s for s in spans if s["operationName"] == "pilosa.query"
                  and _tags(s)["node"] != "a"]
        assert remote
        for r in remote:
            parent = by_id[r["references"][0]["spanID"]]
            assert parent["operationName"] == f"fanout.{_tags(r)['node']}"
        shapes[kinds] = sorted(
            (s["operationName"], _tags(s).get("node"))
            for s in spans if s["operationName"] == "pilosa.query"
            or s["operationName"].startswith("fanout."))
        # a remote sub-request exports nothing of its own
        assert t.nodes[1].trace_exporter is None
    assert shapes["ppp"] == shapes["jjj"]


def test_jax_generated_config_starts_a_port_node_with_export(tmp_path):
    from pilosa_tpu.cli.config import Config as JConfig
    from pilosa_tpu_torch.cli.config import load_config
    from pilosa_tpu_torch.cli.main import server_kwargs

    text = JConfig().to_toml()
    spool = tmp_path / "spool.jsonl"
    text = re.sub(r'(?m)^trace-export = .*$', 'trace-export = "file"', text)
    text = re.sub(r'(?m)^trace-export-path = .*$',
                  f'trace-export-path = "{spool}"', text)
    text = re.sub(r'(?m)^trace-export-format = .*$',
                  'trace-export-format = "otlp"', text)
    text = re.sub(r'(?m)^platform = .*$', 'platform = "cpu"', text)
    text = re.sub(r'(?m)^bind = .*$', 'bind = "127.0.0.1:0"', text)
    path = tmp_path / "gen.toml"
    path.write_text(text)
    cfg = load_config(str(path), environ={})
    kw = server_kwargs(cfg)
    assert (kw["trace_export"], kw["trace_export_format"]) == ("file", "otlp")
    srv = Server(str(tmp_path / "data"), **kw).open()
    try:
        _post(srv.uri, "/index/i", {})
        _post(srv.uri, "/index/i/field/f", {})
        _post(srv.uri, "/index/i/query", "Set(7, f=1)")
        out = _post(srv.uri, "/index/i/query?profile=true",
                    "Count(Row(f=1))")
        assert out["results"] == [1]
    finally:
        srv.close()  # flushes the spool
    batches = [json.loads(x) for x in spool.read_text().splitlines()]
    spans = [s for b in batches
             for s in b["resourceSpans"][0]["scopeSpans"][0]["spans"]]
    trace = out["profile"]["traceId"].rjust(32, "0")
    assert any(s["traceId"] == trace and s["name"] == "pilosa.query"
               for s in spans)


# -- the advise subcommand and the dashboard ------------------------------------


def test_advise_prints_what_the_jax_command_prints(trios, monkeypatch):
    uri = _reader(trios["ppp"])
    raw = _req(uri, "/debug/heat?advice=true&top=0")[2]
    assert json.loads(raw)["advice"]["hbmPinSet"]

    def urlopen(url, timeout=None):
        assert url == uri + "/debug/heat?advice=true&top=0"
        return io.BytesIO(raw)

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    for extra in ([], ["--json"]):
        outs = []
        for main in (tcli.main, jcli.main):
            buf = io.StringIO()
            with redirect_stdout(buf):
                rc = main(["advise", "--host", uri, *extra])
            outs.append((rc, buf.getvalue()))
        assert outs[0] == outs[1] and outs[0][0] == 0
    # a node that tracks nothing: exit 1 from both
    raw = json.dumps({"enabled": False, "trackedFragments": 0}).encode()
    for main in (tcli.main, jcli.main):
        with redirect_stdout(io.StringIO()):
            assert main(["advise", "--host", uri]) == 1


def test_advise_subcommand_against_a_live_node(trios):
    t = trios["ppp"]
    cli = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "advise", "--host",
         t.uris[0]], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert cli.returncode == 0, cli.stderr[-2000:]
    assert cli.stdout.startswith("placement advice (dry run")
    assert "HBM pin set (" in cli.stdout


# tests/test_telemetry.py:324
_EXTERNAL_REF = re.compile(
    r"https?://|href\s*=|src\s*=|url\s*\(|@import|<link|<iframe|"
    r"integrity=|crossorigin", re.IGNORECASE)


def test_dashboard_is_self_contained_and_its_routes_answer(trios):
    t = trios["ppp"]
    st, ctype, body = _req(t.uris[0], "/debug/dashboard")
    html = body.decode()
    assert st == 200 and ctype.startswith("text/html")
    assert not _EXTERNAL_REF.findall(html)
    paths = re.findall(r'fetch\("([^"]+)"', html)
    assert len(paths) == 5
    for p in paths:
        st, ctype, _b = _req(t.uris[0], p + ("0" if p.endswith("=") else ""))
        assert st == 200 and ctype.startswith("application/json"), p
