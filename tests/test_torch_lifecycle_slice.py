"""Membership changes of the port's cluster, against the JAX package's.

In process on the CPU, ids "a" < "b" < "c" < "d" < "e" < "f" (so "a"
coordinates), replicas 2, probing every 0.15 s:

- the cluster-state gates: of a three-node cluster two nodes close and
  are marked down, so the survivor is STARTING; a Count and a Set through
  it get the JAX node's status and body, byte for byte (before this
  slice the port answered them);
- membership changes, in a JAX cluster (the reference), a port cluster
  and two mixed ones (a port coordinator with a JAX joiner, a JAX
  coordinator with port joiners): "d" joins (--join) and its shards move
  to it, the old owners drop theirs; "e" joins and, while its job runs
  (its copy held), "f" knocks and is queued, a read meanwhile gets the
  RESIZING 503, and "f" joins after "e"'s job; "c" is removed through
  "b" (forwarded to the coordinator); "f" is removed and rejoins on its
  data dir. After each step the reads through every member are the same
  JSON as the JAX cluster's, every fragment a node holds is of a shard it
  owns, and each node's .topology lists the members;
- remove-node without a surviving replica is refused with the JAX text;
  set-coordinator and resize/abort;
- this node's drain: a new external query gets the JAX node's 503,
  headers and body; the drain waits for an in-flight query, snapshots
  the fragments with WAL ops, and the peers route around the node;
- a `--join` CLI node, and a SIGTERM that drains it and exits 0.
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from urllib.parse import urlparse

import pytest

from chip_smoke import _free_ports
from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu_torch.server import Server
from tests.test_torch_heal_slice import READS, _load, _wait

ROOT = Path(__file__).resolve().parents[1]
SW = 1 << 20
LIVENESS = dict(membership_interval=0.15, liveness_threshold=2,
                probe_timeout=0.5)


def _raw(uri: str, method: str, path: str, body: bytes = b"",
         headers=None) -> tuple:
    """(status, headers, body bytes)."""
    u = urlparse(uri)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _json(uri: str, method: str, path: str, body=b"") -> tuple:
    if not isinstance(body, bytes):
        body = json.dumps(body).encode()
    st, _, raw = _raw(uri, method, path, body)
    return st, json.loads(raw or b"null")


class Nodes:
    """Nodes by id on fixed ports; kinds[id] is 'p' (port) or 'j' (JAX).
    The first three form the static cluster; the others join."""

    IDS = "abcdef"

    def __init__(self, tmp: Path, kinds: str, replicas: int = 2):
        self.tmp = tmp
        self.kinds = dict(zip(self.IDS, kinds))
        self.replicas = replicas
        self.ports = dict(zip(self.IDS, _free_ports(len(kinds))))
        self.uris = {i: f"http://127.0.0.1:{p}" for i, p in
                     self.ports.items()}
        self.seeds = [self.uris[i] for i in "abc"]
        self.srv: dict = {}

    def make(self, i: str, join: bool = False):
        d = str(self.tmp / i)
        os.makedirs(d, exist_ok=True)
        kw = dict(port=self.ports[i], node_id=i, replica_n=self.replicas,
                  cluster_hosts=self.seeds, join=join, **LIVENESS)
        if self.kinds[i] == "p":
            return Server(d, device="cpu", **kw)
        return JaxServer(d, **kw)

    def open(self, i: str, join: bool = False):
        self.srv[i] = self.make(i, join).open()
        return self.srv[i]

    def live(self) -> list:
        return [s for s in self.srv.values() if not s.closed]

    def members(self, ids: str) -> None:
        """Wait until every node of ids is NORMAL with exactly ids."""
        want = set(ids)
        _wait(lambda: all({n.id for n in self.srv[i].cluster.nodes} == want
                          and self.srv[i].cluster.state == "NORMAL"
                          for i in ids), 120, f"members {ids}")

    def close(self) -> None:
        for s in self.srv.values():
            if not s.closed:
                s.close()


def _answers(nodes: Nodes, ids: str) -> dict:
    return {i: [_json(nodes.uris[i], "POST", "/index/d/query", q.encode())
                for q in READS] for i in ids}


def _check_placement(nodes: Nodes, ids: str, topology: bool = True) -> int:
    """Every fragment is of a shard its node owns, every owner of a shard
    of f holds its fragment, and each port node's .topology lists ids.
    -> fragments held."""
    held = 0
    ref = nodes.srv[ids[0]].cluster
    for i in ids:
        s = nodes.srv[i]
        have = set()
        for iname, fname, _v, shard, _frag in s.holder.walk_fragments():
            assert s.cluster.owns_shard(i, iname, shard), (i, fname, shard)
            if fname == "f":
                have.add(shard)
            held += 1
        owned = {sh for sh in range(8)
                 if ref.owns_shard(i, "d", sh)}
        assert have == owned, (i, sorted(have), sorted(owned))
        if topology and nodes.kinds[i] == "p":
            with open(os.path.join(nodes.tmp, i, ".topology")) as f:
                assert sorted(json.load(f)["nodeIDs"]) == sorted(ids)
    return held


def _held_copy(srv):
    """Hold srv's copies until the returned event is set."""
    release = threading.Event()
    real = srv.follow_resize_instruction

    def held(msg):
        release.wait(120)
        real(msg)

    srv.follow_resize_instruction = held
    return release


def _scenario(tmp: Path, kinds: str) -> list:
    nodes = Nodes(tmp, kinds)
    out = []
    try:
        for i in "abc":
            nodes.open(i)
        nodes.members("abc")
        _load(nodes.uris["a"])
        before = _answers(nodes, "abc")
        out.append(before["a"])
        # "d" joins: its shards move to it, the old owners drop theirs
        held_before = _check_placement(nodes, "abc", topology=False)
        nodes.open("d", join=True)
        nodes.members("abcd")
        got = _answers(nodes, "abcd")
        assert all(v == before["a"] for v in got.values()), got
        assert _check_placement(nodes, "abcd") == held_before
        out.append(got)
        # "e" joins with its copy held; "f" knocks meanwhile and waits
        e = nodes.make("e", join=True)
        release = _held_copy(e)
        nodes.srv["e"] = e.open()
        _wait(lambda: nodes.srv["a"].cluster.state == "RESIZING", 60,
              "RESIZING")
        out.append(_json(nodes.uris["b"], "POST", "/index/d/query",
                         b"Count(Row(f=0))"))
        nodes.open("f", join=True)
        # ("e" knocks again each tick while it waits: queued too)
        _wait(lambda: "f" in {n.id for _, n in
                              nodes.srv["a"]._pending_resizes}, 60,
              "f queued")
        assert nodes.srv["f"].cluster.state == "STARTING"
        release.set()
        nodes.members("abcdef")
        got = _answers(nodes, "abcdef")
        assert all(v == before["a"] for v in got.values()), got
        _check_placement(nodes, "abcdef")
        out.append(got)
        # "c" removed through "b", which forwards it to the coordinator
        out.append(_json(nodes.uris["b"], "POST",
                         "/cluster/resize/remove-node", {"id": "c"}))
        nodes.members("abdef")
        _wait(lambda: len(nodes.srv["c"].cluster.nodes) == 1, 60,
              "c standalone")
        got = _answers(nodes, "abdef")
        assert all(v == before["a"] for v in got.values()), got
        _check_placement(nodes, "abdef")
        out.append(got)
        # "f" removed, then back on its data dir
        out.append(_json(nodes.uris["a"], "POST",
                         "/cluster/resize/remove-node", {"id": "f"}))
        nodes.members("abde")
        nodes.srv["f"].close()
        nodes.open("f", join=True)
        nodes.members("abdef")
        got = _answers(nodes, "abdef")
        assert all(v == before["a"] for v in got.values()), got
        _check_placement(nodes, "abdef")
        out.append(got)
        # set-coordinator, then an abort with no job
        out.append(_json(nodes.uris["d"], "POST",
                         "/cluster/resize/set-coordinator", {"id": "b"}))
        _wait(lambda: all(s.cluster.coordinator_id == "b"
                          for s in nodes.live() if s.node_id != "c"), 60,
              "coordinator b")
        out.append(_json(nodes.uris["a"], "POST", "/cluster/resize/abort"))
    finally:
        nodes.close()
    return out


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    return _scenario(tmp_path_factory.mktemp("jax"), "jjjjjj")


def test_state_gates_refuse_as_jax(tmp_path):
    """Two of three nodes down: the survivor is STARTING and refuses a
    Count and a Set with the JAX node's status and body."""
    got = {}
    for kind in ("j", "p"):
        nodes = Nodes(tmp_path / kind, kind * 3)
        try:
            for i in "abc":
                nodes.open(i)
            nodes.members("abc")
            _load(nodes.uris["a"])
            for i in "bc":
                nodes.srv[i].close()
            a = nodes.srv["a"]
            _wait(lambda: a.cluster.state == "STARTING", 60, "STARTING")
            got[kind] = [
                (st, raw) for st, _, raw in (
                    _raw(nodes.uris["a"], "POST", "/index/d/query", q)
                    for q in (b"Count(Row(f=0))", f"Set({3 * SW}, f=9)"
                              .encode()))]
        finally:
            nodes.close()
    assert got["p"] == got["j"]
    assert got["p"][0] == (503, b'{"error": "api method unavailable in '
                                b'cluster state STARTING"}')


@pytest.mark.parametrize("kinds", ["jjjjjj", "pppppp", "pjpjpp", "jppjpp"],
                         ids=["jax", "port", "port-coordinator",
                              "jax-coordinator"])
def test_membership_changes_as_jax(tmp_path, jax_reference, kinds):
    got = (jax_reference if kinds == "jjjjjj"
           else _scenario(tmp_path, kinds))
    assert got == jax_reference
    assert got[2] == (503, {"error": "api method unavailable in cluster "
                                     "state RESIZING"})
    assert got[-1] == (400, {"error": "no resize job currently running"})


@pytest.mark.parametrize("kind", ["j", "p"])
def test_remove_without_replicas_is_refused(tmp_path, kind):
    nodes = Nodes(tmp_path, kind * 3, replicas=1)
    try:
        for i in "ab":
            nodes.open(i)
        nodes.seeds = nodes.seeds[:2]
        nodes.members("ab")
        _load(nodes.uris["a"])
        st, body = _json(nodes.uris["a"], "POST",
                         "/cluster/resize/remove-node", {"id": "b"})
        assert (st, body) == (400, {"error": "not enough data to perform "
                                             "resize (replica factor may "
                                             "need to be increased)"})
        st, body = _json(nodes.uris["a"], "POST",
                         "/cluster/resize/remove-node", {"id": "zz"})
        assert (st, body) == (404, {"error": "node not found: zz"})
        assert nodes.srv["a"].cluster.state == "NORMAL"
    finally:
        nodes.close()


def test_drain_sheds_waits_and_snapshots(tmp_path):
    """A drained port node and a drained JAX node shed a new query alike;
    the port node's drain waits for its in-flight query, snapshots its
    WAL, and its peers route around it."""
    shed = {}
    for kind in ("j", "p"):
        nodes = Nodes(tmp_path / kind, kind * 3)
        try:
            for i in "abc":
                nodes.open(i)
            nodes.members("abc")
            _load(nodes.uris["a"])
            c = nodes.srv["c"]
            col = next(s for s in range(8)
                       if c.cluster.owns_shard("c", "d", s)) * SW + 77
            assert _json(nodes.uris["a"], "POST", "/index/d/query",
                         f"Set({col}, f=3)".encode())[0] == 200
            gate = threading.Event()
            if kind == "p":
                real = c.executor.execute

                def slow(*a, **k):
                    gate.wait(120)
                    return real(*a, **k)

                c.executor.execute = slow
                inflight = []
                t = threading.Thread(target=lambda: inflight.append(_json(
                    nodes.uris["c"], "POST", "/index/d/query",
                    b"Count(Row(f=3))")))
                t.start()
                _wait(lambda: c.handler.active_queries == 1, 60,
                      "in flight")
            st, status = _json(nodes.uris["c"], "POST", "/cluster/drain")
            assert st == 200 and status["draining"]
            _wait(lambda: c.handler.draining, 60, "shedding")
            shed[kind] = _raw(nodes.uris["c"], "POST", "/index/d/query",
                              b"Count(Row(f=0))")
            _wait(lambda: all(s.cluster.is_draining("c")
                              for s in (nodes.srv["a"], nodes.srv["b"])),
                  60, "peers route around c")
            if kind == "p":
                # the in-flight query holds the drain
                assert c.handler.active_queries == 1 and not c.drained
                c.executor.execute = real
                gate.set()
                t.join()
                _wait(lambda: c.drained, 60, "drained")
                assert inflight[0][0] == 200
                # a coordinator's fan-out entry is not shed
                assert nodes.srv["a"].client.query_proto(
                    nodes.uris["c"], "d", "Count(Row(f=0))",
                    shards=[0], remote=True) is not None
                info = c.drain_status()
                assert info["snapshotted"] >= 1 and info["inflightDrained"]
                assert all(fr.op_n == 0 for *_, fr in
                           c.holder.walk_fragments())
                assert _json(nodes.uris["c"], "GET", "/status")[1][
                    "nodeState"] == "DRAINING"
                _, dv = _json(nodes.uris["c"], "GET", "/debug/vars")
                assert dv["drain"]["drained"] and \
                    dv["drain"]["shedQueries"] == 1
                _, m = _raw(nodes.uris["c"], "GET", "/metrics")[1:]
            _wait(lambda: nodes.srv[nodes.IDS[0]].cluster.state
                  == "DEGRADED", 60, "DEGRADED")
            prof = _json(nodes.uris["a"], "POST",
                         "/index/d/query?profile=true",
                         b"Count(Row(f=0))")[1]["profile"]
            assert "c" not in {f["node"] for f in prof["fanout"]}
        finally:
            gate.set()
            nodes.close()
    (ps, ph, pb), (js, jh, jb) = shed["p"], shed["j"]
    assert (ps, pb) == (js, jb) == (503, (
        b'{"error": "node is draining (graceful restart): retry against '
        b'another replica", "code": "shed"}'))
    for h in ("Retry-After", "X-Pilosa-Shed-Reason"):
        assert ph[h] == jh[h]
    assert b'pilosa_drain{key="draining"} 1\n' in m
    assert b'pilosa_drain_total{key="shedQueries"} 1\n' in m


def test_cli_join_and_sigterm_drain(tmp_path):
    """Two in-process port nodes; a CLI node with --join becomes the third
    member; SIGTERM drains it and it exits 0."""
    ports = _free_ports(3)
    uris = [f"http://127.0.0.1:{p}" for p in ports]
    srvs = []
    proc = None
    try:
        for i, nid in enumerate("ab"):
            srvs.append(Server(str(tmp_path / nid), port=ports[i],
                               device="cpu", node_id=nid, replica_n=2,
                               cluster_hosts=uris[:2], **LIVENESS).open())
        _wait(lambda: all(len(s.cluster.nodes) == 2 for s in srvs), 60,
              "two members")
        _load(uris[0])
        before = [_json(uris[0], "POST", "/index/d/query", q.encode())
                  for q in READS]
        d = tmp_path / "c"
        d.mkdir()
        (d / ".id").write_text("c")
        cfg = tmp_path / "c.toml"
        hosts = ", ".join(f'"{u}"' for u in uris[:2])
        cfg.write_text(
            f'data-dir = "{d}"\nbind = "127.0.0.1:{ports[2]}"\n'
            "[cluster]\ndisabled = false\nreplicas = 2\n"
            f"hosts = [{hosts}]\nmembership-interval = 0.2\n"
            'drain-timeout = "5s"\n'
            '[mesh]\nplatform = "cpu"\n')
        log = (tmp_path / "c.log").open("wb")
        proc = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
             "--config", str(cfg), "--join"], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT)), stdout=log,
            stderr=subprocess.STDOUT)
        log.close()

        def joined() -> bool:
            assert proc.poll() is None, (tmp_path / "c.log").read_text()
            try:
                st = _json(uris[2], "GET", "/status")[1]
            except OSError:
                return False
            return st["state"] == "NORMAL" and len(st["nodes"]) == 3

        _wait(joined, 60, "the CLI node joined")
        assert [_json(uris[2], "POST", "/index/d/query", q.encode())
                for q in READS] == before
        assert any(fr for *_, fr in srvs[0].holder.walk_fragments())
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        took = time.monotonic() - t0
        text = (tmp_path / "c.log").read_text()
        assert "draining" in text and "drain: done" in text, text
        assert took < 30, took
        _wait(lambda: all(s.cluster.is_unavailable("c") for s in srvs),
              60, "peers route around the drained node")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
        for s in srvs:
            s.close()
