"""The event journal on running servers: the port's against the JAX
package's, and mixed clusters of both.

A port server and a JAX server answer the same requests with the same
/debug/events feeds, X-Pilosa-HLC headers, events blocks and
pilosa_events_total rows. A port and a JAX three-node cluster run the
same script (a QoS tenant throttled into a storm, a drain, writes
acknowledged with hints, a return over a quarantined fragment, a node
that dies and is probed down, a join) and record the same events, type
by type and node by node. A mixed cluster of port and JAX nodes, their
walls hours apart, gives one HLC-sorted /cluster/events from either
side, a 404 peer reported as legacy, and gossip carries the clock both
ways. A rolling restart of port nodes under ±2 h of skew reads as one
timeline with no inversion. [cluster] profile and render_timeline match
the JAX package's.
"""

import collections
import json
import os
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from chip_smoke import _free_ports
from pilosa_tpu.cli.main import render_timeline as jax_render
from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu.utils import events as jev
from pilosa_tpu_torch.cli import main as cli_main
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.utils import events as pev

SW = 1 << 20
IDS = ("a", "b", "c", "d")
SKEWS_MS = {0: -7_200_000, 1: 0, 2: +7_200_000}
# no periodic work: probes, passes and samples are driven by the test
QUIET = dict(membership_interval=0.0, telemetry_interval=0.0,
             anti_entropy_interval=0.0, events_spool=1 << 20)


def _req(uri: str, method: str, path: str, body: bytes = b"",
         headers: dict | None = None) -> tuple:
    req = urllib.request.Request(uri + path, data=body or None,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _json(uri: str, method: str, path: str, body=b"", headers=None):
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
    elif isinstance(body, str):
        body = body.encode()
    st, h, out = _req(uri, method, path, body, headers)
    return st, h, (json.loads(out) if out else {})


def _wait(cond, timeout: float = 30.0, what: str = "") -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.05)


def _skew(srv, offset_ms: int) -> None:
    srv.clock._wall_ms = lambda: int(time.time() * 1000) + offset_ms


def _open(kind: str, d: str, **kw):
    if kind == "p":
        return Server(d, device="cpu", **kw).open()
    return JaxServer(d, **kw).open()


def _strip(e: dict) -> dict:
    """An event without what differs between two runs."""
    return {k: v for k, v in e.items()
            if k not in ("hlc", "ts", "uri", "node", "trace")}


# -- one node ----------------------------------------------------------------


def _single_node_surfaces(kind: str, tmp: Path) -> dict:
    srv = _open(kind, str(tmp / kind), port=0, node_id="a", **QUIET)
    try:
        u = srv.uri
        out = {}
        st, h, doc = _json(u, "GET", "/debug/events")
        out["first"] = (st, [_strip(e) for e in doc["events"]],
                        doc["enabled"], doc["node"])
        assert pev.decode_hlc(h.get("X-Pilosa-HLC")) is not None
        # a caller hours ahead: the node's next stamp passes it
        ahead = int(time.time() * 1000) + 7_200_000
        st, h, _ = _req(u, "GET", "/status",
                        headers={"X-Pilosa-HLC": f"{ahead}.5"})
        stamp = pev.decode_hlc(h.get("X-Pilosa-HLC"))
        out["ahead"] = stamp > (ahead, 5)
        assert _json(u, "POST", "/index/i", {})[0] == 200
        assert _json(u, "POST", "/index/i/field/f", {})[0] == 200
        assert _json(u, "POST", "/index/i/query", "Set(3, f=1)")[0] == 200
        srv.logger.warnf("disk %s is slow", "sda")
        srv.logger.errorf("x")
        st, _h, doc2 = _json(u, "GET", f"/debug/events?since={doc['seq']}")
        out["since"] = (st, [_strip(e) for e in doc2["events"]])
        for q in ("severity=bogus", "type=not.registered", "since=x",
                  "limit=2&type=log.warn", "severity=log", "bad=1"):
            st, _h, d = _json(u, "GET", f"/debug/events?{q}")
            out[q] = (st, d.get("error") or [_strip(e)
                                             for e in d["events"]])
        st, _h, dv = _json(u, "GET", "/debug/vars")
        ev = dict(dv["events"])
        assert ev.pop("spoolPath").endswith("events.spool.jsonl")
        # the spool's bytes vary with the port's and the times' digits
        assert ev.pop("spoolBytes") > 0
        out["vars"] = ev
        st, _h, text = _req(u, "GET", "/metrics")
        out["metrics"] = sorted(line for line in text.decode().splitlines()
                                if "pilosa_events" in line
                                and "spoolBytes" not in line)
        return out
    finally:
        srv.close()


def test_single_node_surfaces_match_jax(tmp_path):
    got = _single_node_surfaces("p", tmp_path)
    want = _single_node_surfaces("j", tmp_path)
    assert got == want
    assert got["ahead"] and got["first"][1] == [{"type": "node.start",
                                                 "cluster": False,
                                                 "seq": 1}]
    assert 'pilosa_events_total{type="log.warn"} 1' in got["metrics"]
    assert 'pilosa_events_total{type="qos.quota_debt"} 0' in got["metrics"]


# -- the same script on a port and a JAX cluster ------------------------------


class Trio:
    """Nodes a, b, c (and d, a joiner) of one kind on fixed ports."""

    def __init__(self, tmp: Path, kinds: str, skews: dict | None = None,
                 **extra):
        self.tmp, self.kinds, self.extra = tmp, kinds, extra
        # whether a joiner's open() waits, after its knock, until the
        # coordinator's resize has sent it a fragment
        self.hold_join = False
        self.skews = skews or {}
        self.ports = _free_ports(4)
        self.uris = [f"http://127.0.0.1:{p}" for p in self.ports]
        self.nodes = [None] * 4
        for i in range(3):
            self.open(i)
        for n in self.nodes[:3]:
            n.refresh_membership()
        _wait(lambda: all(len(n.cluster.nodes) == 3 for n in self.nodes[:3]),
              what="membership")

    def open(self, i: int, join: bool = False):
        kw = dict(port=self.ports[i], node_id=IDS[i], replica_n=2,
                  cluster_hosts=self.uris[:3], join=join, **QUIET,
                  **self.extra)
        d = str(self.tmp / f"n{i}")
        os.makedirs(d, exist_ok=True)
        cls = Server if self.kinds[i] == "p" else JaxServer
        srv = cls(d, **kw, **({"device": "cpu"} if self.kinds[i] == "p"
                              else {}))
        if i in self.skews:
            _skew(srv, self.skews[i])
        if join:
            _watch_join(srv, self.hold_join)
        self.nodes[i] = srv.open()
        return self.nodes[i]

    def owners(self, shard: int) -> set:
        return {n.id for n in self.nodes[0].cluster.shard_nodes("d", shard)}

    def close(self) -> None:
        for n in self.nodes:
            if n is not None and not n.closed:
                n.close()


def _watch_join(srv, hold: bool) -> None:
    """Record, on a joiner, the (index, shard) pairs it holds when its
    open() reaches the read fence (`fenced_at_arm`; the port's joiner
    arms none and records None). With `hold`, open() waits after the
    knock until the resize has sent it a fragment: the JAX package's
    joiner knocks at server.py:586 and arms the fence at :648, and a
    resize that lands in between is fenced (ROADMAP, JAX fault 14)."""
    srv.fenced_at_arm = None
    knock = srv.request_join

    def request_join():
        knock()
        if hold:
            _wait(lambda: any(True for _ in srv.holder.walk_fragments()),
                  what="a fragment from the resize")

    srv.request_join = request_join
    if isinstance(srv, JaxServer):
        arm = srv._arm_read_fence

        def arm_read_fence():
            srv.fenced_at_arm = sorted(
                {(i, s) for i, _f, _v, s, _fr in srv.holder.walk_fragments()})
            arm()

        srv._arm_read_fence = arm_read_fence


def _join_race(n, counts: dict) -> bool:
    """Whether the JAX joiner `n` armed its fence over fragments the
    resize had already sent it: its data directory started empty, so
    every pair it held at the fence came by the resize, and its journal's
    one fence.armed fenced exactly those."""
    armed = [e for e in n.events.events(0) if e["type"] == "fence.armed"]
    return (bool(n.fenced_at_arm) and counts.get("fence.armed") == 1
            and len(armed) == 1
            and armed[0]["shards"] == len(n.fenced_at_arm))


def _load(t: Trio) -> None:
    u = t.uris[0]
    assert _json(u, "POST", "/index/d", {})[0] == 200
    assert _json(u, "POST", "/index/d/field/f", {})[0] == 200
    cols = [s * SW + 7 * k for s in range(4) for k in range(5)]
    st, _h, out = _json(u, "POST", "/index/d/field/f/import",
                        {"rowIDs": [1] * len(cols), "columnIDs": cols})
    assert st == 200, out
    _wait(lambda: all(
        _json(x, "POST", "/index/d/query", "Count(Row(f=1))")[2]
        == {"results": [len(cols)]} for x in t.uris[:3]), what="loaded")


def _fenced(n) -> int:
    return n.executor.fence_snapshot()["fencedShards"]


def _healed(t: Trio, i: int) -> bool:
    return (_fenced(t.nodes[i]) == 0
            and all(n.hints.snapshot()["pendingBytes"] == 0
                    for j, n in enumerate(t.nodes[:3]) if j != i))


def _script(t: Trio) -> None:
    """QoS storm and debt, drain, hinted writes, a return over a
    quarantined fragment, a death probed down and a return, a join."""
    a, b, c = t.uris[:3]
    _load(t)
    for _ in range(25):
        st, _h, _ = _json(a, "POST", "/index/d/query", "Count(Row(f=1))",
                          {"X-API-Key": "b"})
        assert st == 429
    # the drain of c, then its process goes
    assert _json(c, "POST", "/cluster/drain", {})[0] == 200
    _wait(lambda: t.nodes[2].drained, what="drained")
    _wait(lambda: all(n.cluster.is_draining("c") for n in t.nodes[:2]),
          what="peers route around c")
    t.nodes[2].close()
    shared = [s for s in range(4) if "c" in t.owners(s)]
    for k, s in enumerate(shared):
        assert _json(t.uris[k % 2], "POST", "/index/d/query",
                     f"Set({s * SW + 100 + k}, f=1)")[0] == 200
    # a damaged fragment file, then the return
    path = os.path.join(str(t.tmp / "n2"), "d", "f", "views", "standard",
                        "fragments", str(shared[0]))
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) // 2)
    t.open(2)
    _wait(lambda: _healed(t, 2), what="c healed")
    # b dies; a and c probe it down, then it returns
    t.nodes[1].close()
    for n in (t.nodes[0], t.nodes[2]):
        for _ in range(n.liveness_threshold):
            n._probe_peers()
    assert all(n.cluster.is_down("b") for n in (t.nodes[0], t.nodes[2]))
    t.open(1)
    _wait(lambda: _healed(t, 1), what="b healed")
    # d joins through the seeds
    t.open(3, join=True)
    _wait(lambda: all(len(n.cluster.nodes) == 4
                      and n.cluster.state == "NORMAL" for n in t.nodes),
          what="d joined")


def _counts(t: Trio) -> dict:
    out = {}
    for n in t.nodes:
        out[n.node_id] = dict(collections.Counter(
            e["type"] for e in n.events.events(0)))
    return out


def test_event_counts_match_a_jax_cluster(tmp_path):
    qos = dict(qos_mode="enforce",
               qos_principals={"key:b": {"queries-per-s": 0.1}})
    counts, race = {}, False
    for kind in ("j", "p"):
        t = Trio(tmp_path / kind, kind * 4, **qos)
        try:
            _script(t)
            counts[kind] = _counts(t)
            if kind == "j":
                race = _join_race(t.nodes[3], counts["j"]["d"])
        finally:
            t.close()
    if race:
        # the JAX joiner fenced what the resize had sent it (JAX fault
        # 14): its one fence.armed is the race, every other count equal
        del counts["j"]["d"]["fence.armed"]
    assert counts["p"] == counts["j"]
    a, b, c, d = (counts["p"][i] for i in IDS)
    assert "fence.armed" not in d  # the port's joiner never fences
    assert a["qos.quota_debt"] == 1 and a["qos.shed_storm.start"] == 1
    assert c["drain.start"] == c["drain.complete"] == 1
    assert c["snapshot.quarantined"] == 1
    assert c["fence.armed"] == b["fence.armed"] == 1  # fragments to fence
    assert a["peer.down"] == c["peer.down"] == 1
    assert a["hint.replay"] + b["hint.replay"] >= 1
    assert a["resize.start"] == a["resize.complete"] == 1
    assert b["topology.change"] == c["topology.change"] == \
        d["topology.change"] == 1 and d["node.start"] == 1


@pytest.mark.parametrize("kind", ["j", "p"])
def test_joiner_fence_race_is_the_reference_s(tmp_path, kind):
    """The joiner's open() held after its knock until the resize has sent
    it a fragment: the JAX joiner then fences that fragment and records
    fence.armed; the port's records none and answers reads through
    itself at once."""
    t = Trio(tmp_path, kind * 4)
    try:
        _load(t)
        t.hold_join = True
        d = t.open(3, join=True)
        _wait(lambda: all(len(n.cluster.nodes) == 4
                          and n.cluster.state == "NORMAL" for n in t.nodes),
              what="d joined")
        armed = [e for e in d.events.events(0) if e["type"] == "fence.armed"]
        if kind == "j":
            assert d.fenced_at_arm and len(armed) == 1
            assert armed[0]["shards"] == len(d.fenced_at_arm)
            assert _join_race(d, {"fence.armed": 1})
        else:
            assert armed == [] and d.fenced_at_arm is None
            assert _fenced(d) == 0
            for u in t.uris:
                assert _json(u, "POST", "/index/d/query",
                             "Count(Row(f=1))")[2] == {"results": [20]}
    finally:
        t.close()


# -- mixed clusters -------------------------------------------------------------


def _timeline_ok(doc: dict, ids: set) -> list:
    assert {n["id"]: n["status"] for n in doc["nodes"]} == \
        dict.fromkeys(ids, "ok")
    evs = doc["events"]
    assert [pev.hlc_sort_key(e) for e in evs] == \
        sorted(pev.hlc_sort_key(e) for e in evs)
    assert {e["node"] for e in evs} == ids
    return evs


def test_mixed_cluster_merges_from_either_side(tmp_path):
    t = Trio(tmp_path, "pjpp", skews={1: 7_200_000})  # the JAX node +2 h
    try:
        _load(t)
        docs = [_json(u, "GET", "/cluster/events")[2] for u in t.uris[:3]]
        for doc in docs:
            _timeline_ok(doc, {"a", "b", "c"})
        # JAX to port over HTTP: only b's stamps are 2 h ahead
        wall = int(time.time() * 1000)
        for i in (0, 2):
            assert t.nodes[i].clock.peek()[0] >= wall + 7_000_000
        # port to JAX: c now leans 4 h ahead, and one RPC of c's lifts b
        _skew(t.nodes[2], 14_400_000)
        t.nodes[2].client.status(t.uris[1])
        assert t.nodes[1].clock.peek()[0] >= wall + 14_000_000

        def legacy(params, query, body):
            return 404, "application/json", b'{"error": "not found"}'

        t.nodes[2].handler.get_debug_events = legacy
        for u in t.uris[:2]:
            doc = _json(u, "GET", "/cluster/events")[2]
            assert {n["id"]: n["status"] for n in doc["nodes"]} == {
                "a": "ok", "b": "ok", "c": "legacy"}
            assert {e["node"] for e in doc["events"]} == {"a", "b"}
        assert "legacy peer(s)" in cli_main.render_timeline(doc)
    finally:
        t.close()


@pytest.mark.parametrize("first", ["port", "jax"])
def test_gossip_carries_the_clock_both_ways(first):
    from pilosa_tpu.parallel import gossip as jg
    from pilosa_tpu.utils.aesgcm import derive_key as jkey
    from pilosa_tpu_torch.parallel import gossip as pg
    from pilosa_tpu_torch.utils.aesgcm import derive_key as pkey

    mods = [(pg, pkey, pev), (jg, jkey, jev)]
    if first == "jax":
        mods.reverse()
    ports = _free_ports(2)
    nodes = []
    try:
        for i, (g, key, ev) in enumerate(mods):
            node = g.Gossip(f"g{i}", bind_host="127.0.0.1",
                            bind_port=ports[i],
                            config=g.GossipConfig(period=0.05,
                                                  probe_timeout=0.2),
                            secret_key=key("s3cret"))
            node.clock = ev.HybridLogicalClock(
                wall_ms=lambda i=i: int(time.time() * 1000)
                + (7_200_000 if i else 0))
            nodes.append(node)
        for i, node in enumerate(nodes):
            node.open(seeds=[("127.0.0.1", ports[1 - i])])
        _wait(lambda: all(len(n.members()) == 2 for n in nodes),
              what="gossip members")
        # the first node's wall is 2 h behind; the datagrams, sealed,
        # carried the second's stamps into its clock, and back
        _wait(lambda: nodes[0].clock.peek()[0]
              >= int(time.time() * 1000) + 7_000_000, what="merged")
        assert nodes[0].crypto_drops == nodes[1].crypto_drops == 0
    finally:
        for node in nodes:
            node.close()


# -- a rolling restart under skew -------------------------------------------------


def test_rolling_restart_reads_as_one_causal_timeline(tmp_path):
    """drain -> routing around -> hint appends -> return (fence armed,
    rejoin) -> hint replays -> fence lifts, in causal order on one merged
    timeline although the walls are ±2 h apart."""
    t = Trio(tmp_path, "ppp", skews=SKEWS_MS)
    try:
        _load(t)
        assert _json(t.uris[2], "POST", "/cluster/drain", {})[0] == 200
        _wait(lambda: t.nodes[2].drained, what="drained")
        _wait(lambda: all(n.cluster.is_draining("c") for n in t.nodes[:2]),
              what="peers route around c")
        t.nodes[2].close()
        shared = [s for s in range(4) if "c" in t.owners(s)]
        for k in range(9):
            s = shared[k % len(shared)]
            assert _json(t.uris[k % 2], "POST", "/index/d/query",
                         f"Set({s * SW + 900 + k}, f=9)")[0] == 200
        t.open(2)
        _wait(lambda: _healed(t, 2), what="c healed")
        doc = _json(t.uris[0], "GET", "/cluster/events")[2]
        merged = _timeline_ok(doc, {"a", "b", "c"})
        for nid in ("a", "b", "c"):
            own = [e["seq"] for e in merged if e["node"] == nid]
            assert own == sorted(own)

        def first(etype, **match):
            return next(i for i, e in enumerate(merged)
                        if e["type"] == etype
                        and all(e.get(k) == v for k, v in match.items()))

        i_drain = first("drain.start", node="c")
        i_draining = first("peer.draining", peer="c")
        i_append = first("hint.append", target="c")
        i_complete = first("drain.complete", node="c")
        i_fence = first("fence.armed", node="c")
        i_rejoined = first("peer.rejoined", peer="c")
        i_replay = first("hint.replay", target="c")
        assert i_drain < i_draining < i_append < i_fence
        assert i_drain < i_complete < i_fence < i_rejoined < i_replay
        lifts = [(i, e) for i, e in enumerate(merged)
                 if e["type"] == "fence.lifted"]
        assert lifts and all(i > i_fence for i, _ in lifts)
        replays = [i for i, e in enumerate(merged)
                   if e["type"] == "hint.replay" and e["target"] == "c"]
        waited = [i for i, e in lifts if e.get("awaitedHints")]
        assert all(i > max(replays) for i in waited)
        text = cli_main.render_timeline(doc)
        assert text == jax_render(doc)
        assert "3 node(s)" in text and "hint.replay" in text
    finally:
        t.close()


def test_node_stop_is_the_last_spooled_event(tmp_path):
    """A scrub pass in flight when the node closes stops there and records
    nothing after node.stop: the spool a restarted node reloads ends with
    its stop."""
    srv = _open("p", str(tmp_path / "n"), **QUIET)
    in_pass = threading.Event()

    def slow_sync():
        in_pass.set()
        _wait(lambda: srv.closed, what="close() while the pass runs")
        return 0

    srv.sync_holder = slow_sync
    th = threading.Thread(target=srv.scrub_pass)
    th.start()
    assert in_pass.wait(30)
    srv.close()
    th.join(30)
    with open(tmp_path / "n" / "events.spool.jsonl", encoding="utf-8") as f:
        types = [json.loads(line)["type"] for line in f]
    assert types[-1] == "node.stop" and "scrub.pass" not in types
    assert srv.scrub_pass() == 0  # a closed node starts no pass


# -- [cluster] profile and the timeline's text --------------------------------------


@pytest.mark.parametrize("mode", ["off", "auto", "on"])
def test_profile_mode_matches_jax(tmp_path, monkeypatch, mode):
    seen = []
    for kind in ("p", "j"):
        srv = _open(kind, str(tmp_path / kind), port=0, profile_mode=mode,
                    **QUIET)
        try:
            u = srv.uri
            _json(u, "POST", "/index/i", {})
            _json(u, "POST", "/index/i/field/f", {})
            st, _h, out = _json(u, "POST", "/index/i/query?profile=true",
                                "Count(Row(f=1))")
            seen.append((st, "profile" in out,
                         srv.api._should_profile(False),
                         srv.api._should_profile(True)))
        finally:
            srv.close()
    monkeypatch.setenv("PILOSA_TPU_PROFILE", "0")
    for kind in ("p", "j"):
        srv = _open(kind, str(tmp_path / f"k{kind}"), port=0,
                    profile_mode=mode, **QUIET)
        try:
            seen.append(srv.api._should_profile(True))
        finally:
            srv.close()
    assert seen[0] == seen[1] and seen[2] is seen[3] is False
    assert seen[0][1] is (mode != "off")


class _Sink:
    def __init__(self):
        self.lines = []

    def write(self, s):
        self.lines.append(s)

    def flush(self):
        pass


def test_slow_query_line_matches_jax(tmp_path):
    lines = []
    for kind in ("p", "j"):
        srv = _open(kind, str(tmp_path / kind), port=0, long_query_time=1e-9,
                    **QUIET)
        try:
            srv.logger.out = sink = _Sink()
            _json(srv.uri, "POST", "/index/i", {})
            _json(srv.uri, "POST", "/index/i/field/f", {})
            pql = "Count(Row(f=1))" + " " * 300
            assert _json(srv.uri, "POST", "/index/i/query", pql)[0] == 200
            line = next(x for x in sink.lines if "SLOW QUERY" in x)
            entry = srv.api.query_history.snapshot()[0]
            lines.append((line.split("s SLOW QUERY ")[1].rsplit(
                " trace=", 1)[0], entry["traceId"] in line))
        finally:
            srv.close()
    assert lines[0] == lines[1]
    assert lines[0][0] == "i " + ("Count(Row(f=1))" + " " * 300)[:253] \
        + "..." and lines[0][1]


def test_render_timeline_matches_jax(tmp_path, capsys):
    doc = {"nodes": [{"id": "node-aaaaaaaaaa", "status": "ok"},
                     {"id": "b", "status": "legacy"},
                     {"id": "c", "status": "down"}],
           "events": [
               {"hlc": [1_700_000_000_000, 0], "type": "drain.start",
                "node": "node-aaaaaaaaaa", "seq": 1, "timeoutSeconds": 3},
               {"hlc": [1_700_000_000_000, 2], "type": "health.transition",
                "node": "c", "seq": 9, "fromScore": "green",
                "toScore": "red", "reasons": ["slo count-latency", "x"]},
               {"hlc": None, "type": "peer.down", "node": "c", "seq": 10,
                "peer": "b", "detector": "probe"},
               {"hlc": [10 ** 20, 1], "type": "node.stop", "node": "c",
                "seq": 11}]}
    for kw in ({}, {"node": "c"}, {"etype": "drain.start"}):
        assert cli_main.render_timeline(doc, **kw) == jax_render(doc, **kw)
    srv = Server(str(tmp_path / "p"), port=0, device="cpu",
                 **QUIET).open()
    try:
        assert cli_main.main(["timeline", "--host", srv.uri]) == 0
        text = capsys.readouterr().out
        assert text.startswith("cluster timeline: 1 event(s) across 1 "
                               "node(s)")
        assert cli_main.main(["timeline", "--host", srv.uri, "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["events"][0][
            "type"] == "node.start"
    finally:
        srv.close()
