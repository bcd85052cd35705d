"""Liveness and healing of the port's cluster, against the JAX package's.

Three in-process clusters of three nodes on the CPU, ids "a", "b" and
"c", replicas 2, probing every 0.15 s with liveness_threshold 2: three
JAX nodes, three port nodes, and a mixed one of port nodes "a" and "c"
around the JAX node "b". The same seeded data goes in through node "a"
of each. Node "c" dies (its server closes): the live nodes mark it down;
Sets through "a" and "b" into shards "c" co-owns, a new shard included,
are acknowledged with hints, and so is a Clear through "a" of a loaded
bit of a shard of "b" and "c"; the answers through every live node are
the same JSON in every cluster. "c" reopens on its data dir, the hints of
the port node "a" a second late: the hints replay, its read fence lifts,
and every shard it owns reads the same on it alone (remote=true) as on
the other owner. In the port and mixed clusters the cleared bit stays
cleared on each owner alone, since the returning port node merges a
diverged shard only after every live peer's hints are in; the JAX
cluster is not held to it (its fence check merges at first sight, ROADMAP
Queue C 11). In the mixed cluster the
JAX node "b" then dies and returns, healed by the two port nodes. A
remote=true Set planted on one owner reaches the other through
anti-entropy, attribute writes planted on one node converge, a fragment
file truncated inside its snapshot is quarantined and rebuilt from its
replica (from the JAX node in the mixed cluster), and in a port cluster
of replicas 3 a bit cleared on two replicas stays cleared.

The port's periodic pass merges a block only when the pass before saw the
same divergence, so it is run twice where the JAX pass runs once.
"""

import os
import time
from pathlib import Path

import numpy as np
import pytest

from chip_smoke import _free_ports
from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu_torch.server import Server

from tests.test_torch_obs_slice import _post

SW = 1 << 20
N_SHARDS = 8
IDS = ("a", "b", "c")
READS = ["Count(Row(f=0))", "Count(Row(f=1))", "Count(Row(g=1))",
         "Row(f=2)", "Count(Union(Row(f=0), Row(g=1)))", "TopN(f, n=3)",
         "Count(Row(f=3))"]
LIVENESS = dict(membership_interval=0.15, liveness_threshold=2,
                probe_timeout=0.5)


def _wait(cond, timeout: float = 30.0, what: str = "") -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.05)


class Cluster:
    """Three nodes on fixed ports; kinds[i] 'p' (port) or 'j' (JAX)."""

    def __init__(self, tmp: Path, kinds: str, replicas: int = 2, **extra):
        self.tmp = tmp
        self.kinds = kinds
        self.replicas = replicas
        self.extra = extra
        self.ports = _free_ports(len(kinds))
        self.uris = [f"http://127.0.0.1:{p}" for p in self.ports]
        self.nodes = [self.open(i) for i in range(len(kinds))]

    def open(self, i: int):
        d = str(self.tmp / f"n{i}")
        os.makedirs(d, exist_ok=True)
        if self.kinds[i] == "p":
            return Server(d, port=self.ports[i], device="cpu",
                          node_id=IDS[i], replica_n=self.replicas,
                          cluster_hosts=self.uris, **LIVENESS,
                          **self.extra).open()
        return JaxServer(d, port=self.ports[i], node_id=IDS[i],
                         replica_n=self.replicas, cluster_hosts=self.uris,
                         **LIVENESS, **self.extra).open()

    def reopen(self, i: int):
        self.nodes[i] = self.open(i)
        return self.nodes[i]

    def owners(self, shard: int) -> set:
        return {n.id for n in self.nodes[0].cluster.shard_nodes("d", shard)}

    def close(self) -> None:
        for n in self.nodes:
            if n is not None and not n.closed:
                n.close()


def _load(uri: str) -> None:
    rng = np.random.default_rng(31)
    for path, body in [("/index/d", {"options": {"trackExistence": True}}),
                       ("/index/d/field/f", {"options": {
                           "cacheType": "ranked"}}),
                       ("/index/d/field/g", {})]:
        assert _post(uri, path, body)[0] == 200
    for field, rows in (("f", 4), ("g", 2)):
        for r in range(rows):
            cols = np.unique(rng.integers(0, N_SHARDS * SW, 700 // (r + 1)))
            st, out = _post(uri, f"/index/d/field/{field}/import",
                            {"rowIDs": [r] * cols.size,
                             "columnIDs": cols.tolist()})
            assert st == 200, out


def _answers(uri: str, reads=READS) -> list:
    return [_post(uri, "/index/d/query", q) for q in reads]


def _remote(uri: str, shards, pql: str):
    qs = ",".join(str(s) for s in shards)
    return _post(uri, f"/index/d/query?remote=true&shards={qs}", pql)


def _down_everywhere(cl: Cluster, dead: int) -> bool:
    return all(n.cluster.is_down(IDS[dead])
               for i, n in enumerate(cl.nodes) if i != dead)


def _healed(cl: Cluster, back: int) -> bool:
    node = cl.nodes[back]
    return (not node.executor.read_fence
            and all(n.hints.pending(IDS[back]) == 0
                    for i, n in enumerate(cl.nodes) if i != back)
            and not any(n.cluster.is_down(IDS[back])
                        for i, n in enumerate(cl.nodes) if i != back))


def _scrub(node, times: int) -> int:
    return sum(node.scrub_pass() for _ in range(times))


def _passes(node) -> int:
    """Scrub passes the port node needs (its two-pass settle rule)."""
    return 2 if isinstance(node, Server) else 1


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    made = {}
    try:
        for name, kinds in (("jax", "jjj"), ("port", "ppp"),
                            ("mixed", "pjp")):
            cl = Cluster(tmp_path_factory.mktemp(name), kinds)
            made[name] = cl
            _wait(lambda: all(len(n.cluster.nodes) == 3 for n in cl.nodes),
                  what="membership")
            _load(cl.uris[0])
        want = _answers(made["jax"].uris[0])
        for cl in made.values():
            for u in cl.uris:
                _wait(lambda: _answers(u) == want, what="shards announced")
        yield made
    finally:
        for cl in made.values():
            cl.close()


def _cleared_bit(cl: Cluster) -> tuple:
    """(shard, column): the first loaded bit of Row(g=0) in a shard of "b"
    and "c", which the outage Clears through "a": the hint for "c" is held
    by a node that does not own the shard."""
    cols = _post(cl.uris[0], "/index/d/query", "Row(g=0)")[1]["results"][0][
        "columns"]
    return next((c // SW, c) for c in cols
                if cl.owners(c // SW) == {"b", "c"})


def _outage_writes(cl: Cluster) -> list:
    """Sets through "a" and "b" into shards "c" co-owns: per bit, an
    envelope, and a shard nothing holds yet; and a Clear through "a" of a
    loaded bit there, kept in cl.cleared. -> the responses."""
    shared = [s for s in range(N_SHARDS) if "c" in cl.owners(s)]
    fresh = next(s for s in range(20, 60) if "c" in cl.owners(s))
    cl.cleared = _cleared_bit(cl)
    out = [_post(cl.uris[0], "/index/d/query",
                 f"Clear({cl.cleared[1]}, g=0)")]
    for k, s in enumerate(shared):
        out.append(_post(cl.uris[k % 2], "/index/d/query",
                         f"Set({s * SW + 1000 + k}, f=1)"))
    env = "\n".join(f"Set({s * SW + 2000 + k}, g=1)"
                    for k, s in enumerate(shared))
    out.append(_post(cl.uris[0], "/index/d/query", env))
    out.append(_post(cl.uris[1], "/index/d/query",
                     f"Set({fresh * SW + 5}, f=1) Set({fresh * SW + 6}, f=0)"))
    return out


def test_dead_node_is_marked_down(clusters):
    want = _answers(clusters["jax"].uris[0])
    for cl in clusters.values():
        cl.nodes[2].close()
        _wait(lambda: _down_everywhere(cl, 2), what="mark-down")
        for n in cl.nodes[:2]:
            assert n.cluster.state == "DEGRADED"
        for u in cl.uris[:2]:
            assert _answers(u) == want


def test_outage_writes_are_acknowledged_with_hints(clusters):
    acks = {name: _outage_writes(cl) for name, cl in clusters.items()}
    assert all(st == 200 for st, _ in acks["jax"]), acks["jax"]
    assert acks["port"] == acks["jax"] and acks["mixed"] == acks["jax"]
    want = _answers(clusters["jax"].uris[0])
    for name, cl in clusters.items():
        queued = sum(n.hints.snapshot()["queued"] for n in cl.nodes[:2])
        assert queued >= 3, (name, queued)
        for u in cl.uris[:2]:
            assert _answers(u) == want, name


def _owner_reads_agree(cl: Cluster, i: int) -> None:
    """Every shard node i owns reads the same on it alone as on the
    other owner."""
    pqls = ["Row(f=0)", "Row(f=1)", "Row(g=1)", "Count(Row(f=2))"]
    for s in range(60):
        owners = cl.owners(s)
        if IDS[i] not in owners:
            continue
        other = IDS.index(next(o for o in owners if o != IDS[i]))
        for pql in pqls:
            got = _remote(cl.uris[i], [s], pql)
            assert got[0] == 200 and got == _remote(cl.uris[other], [s], pql), \
                (cl.kinds, s, pql, got)


def _late(replay):
    """A hint replay that starts a second late, so that the returning
    node's fence check meets its diverged shards before the hinted Clear
    is in."""
    def late(node):
        time.sleep(1.0)
        return replay(node)
    return late


def test_return_replays_hints_and_lifts_the_fence(clusters):
    late = [clusters[name].nodes[0] for name in ("port", "mixed")]
    for a in late:
        a.replay_hints = _late(a.replay_hints)
    try:
        for cl in clusters.values():
            cl.reopen(2)
        for name, cl in clusters.items():
            _wait(lambda: _healed(cl, 2), what=f"{name} heal")
    finally:
        for a in late:
            del a.replay_hints
    for name, cl in clusters.items():
        for n in cl.nodes[:2]:
            assert n.hints.snapshot()["replayed"] >= 1
    want = _answers(clusters["jax"].uris[2])
    for name, cl in clusters.items():
        _owner_reads_agree(cl, 2)
        for u in cl.uris:
            assert _answers(u) == want, name
    for name in ("port", "mixed"):
        cl = clusters[name]
        s, col = cl.cleared
        for o in cl.owners(s):
            got = _remote(cl.uris[IDS.index(o)], [s], "Row(g=0)")
            assert got[0] == 200 and col not in got[1]["results"][0][
                "columns"], (name, o)


def test_mixed_jax_node_heals_from_port_nodes(clusters):
    cl = clusters["mixed"]
    cl.nodes[1].close()  # the JAX node
    _wait(lambda: _down_everywhere(cl, 1), what="JAX node down")
    shared = [s for s in range(N_SHARDS) if "b" in cl.owners(s)]
    for k, s in enumerate(shared):
        st, out = _post(cl.uris[2 * (k % 2)], "/index/d/query",
                        f"Set({s * SW + 3000 + k}, g=0)")
        assert st == 200, out
    assert sum(cl.nodes[i].hints.snapshot()["queued"] for i in (0, 2)) >= \
        len(shared)
    cl.reopen(1)
    _wait(lambda: _healed(cl, 1), what="JAX node heal")
    _owner_reads_agree(cl, 1)
    _owner_reads_agree(cl, 2)


def test_anti_entropy_carries_a_planted_bit(clusters):
    for name, cl in clusters.items():
        s = 5
        i, j = sorted(IDS.index(o) for o in cl.owners(s))
        col = s * SW + 4444
        assert _remote(cl.uris[i], [s], f"Set({col}, f=3)")[0] == 200
        assert col not in _remote(cl.uris[j], [s], "Row(f=3)")[1][
            "results"][0]["columns"]
        other = cl.nodes[j]
        assert _scrub(other, _passes(other)) >= 1
        assert col in _remote(cl.uris[j], [s], "Row(f=3)")[1][
            "results"][0]["columns"], name
        assert _scrub(other, 1) == 0  # converged


def test_attribute_diffs_converge(clusters):
    got = {}
    for name, cl in clusters.items():
        a = cl.uris[0]
        assert _post(a, "/index/d/query?remote=true",
                     'SetRowAttrs(f, 2, color="red", n=3)')[0] == 200
        assert _post(a, "/index/d/query?remote=true",
                     'SetColumnAttrs(77, tag="x")')[0] == 200
        c = cl.nodes[2]
        _scrub(c, _passes(c))
        idx = c.holder.index("d")
        got[name] = (idx.field("f").row_attrs.attrs(2),
                     idx.column_attrs.attrs(77))
    assert got["port"] == got["jax"] == got["mixed"] == (
        {"color": "red", "n": 3}, {"tag": "x"})


def _damage(node_dir: str, shard: int) -> str:
    path = os.path.join(node_dir, "d", "f", "views", "standard",
                        "fragments", str(shard))
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(size // 2)
    return path


@pytest.mark.parametrize("name,peer", [("port", "a"), ("mixed", "b")])
def test_quarantined_fragment_is_rebuilt_from_its_replica(clusters, name,
                                                          peer):
    cl = clusters[name]
    s = next(s for s in range(N_SHARDS) if cl.owners(s) == {peer, "c"})
    cl.nodes[2].close()
    _wait(lambda: _down_everywhere(cl, 2), what="mark-down")
    _damage(str(cl.tmp / "n2"), s)
    c = cl.reopen(2)
    frag = c.holder.index("d").field("f").view("standard").fragment(s)
    # quarantined at open (the fence check may already have merged the
    # replica's blocks in; the rebuild is still owed)
    assert frag.needs_rebuild and os.path.exists(frag.quarantine_path)
    _wait(lambda: _healed(cl, 2), what="heal")
    assert c.repair_quarantined() == 1 or frag.rebuilt_from == peer
    assert frag.rebuilt_from == peer and not frag.needs_rebuild
    damaged = c.holder.damaged_fragments()
    assert [d["shard"] for d in damaged] == [s]
    _owner_reads_agree(cl, 2)


def test_majority_clear_stays_cleared_with_three_replicas(tmp_path):
    cl = Cluster(tmp_path, "ppp", replicas=3)
    try:
        _wait(lambda: all(len(n.cluster.nodes) == 3 for n in cl.nodes),
              what="membership")
        for path in ("/index/d", "/index/d/field/f"):
            assert _post(cl.uris[0], path, {})[0] == 200
        cols = [s * SW + 10 + s for s in range(4)]
        assert _post(cl.uris[0], "/index/d/field/f/import",
                     {"rowIDs": [1] * 4, "columnIDs": cols})[0] == 200
        for u in cl.uris:
            _wait(lambda: _post(u, "/index/d/query", "Count(Row(f=1))")[1]
                  == {"results": [4]}, what="load")
        # a Clear two replicas took, and a stray bit on one replica
        for u in cl.uris[:2]:
            assert _remote(u, [1], f"Clear({cols[1]}, f=1)")[0] == 200
        assert _remote(cl.uris[2], [2], f"Set({2 * SW + 99}, f=1)")[0] == 200
        c = cl.nodes[2]
        assert _scrub(c, 2) >= 2
        want = sorted(set(cols) - {cols[1]})
        for u in cl.uris:
            assert _remote(u, [0, 1, 2, 3], "Row(f=1)")[1]["results"][0][
                "columns"] == want
    finally:
        cl.close()


def test_dropped_hint_still_reaches_the_returning_node(tmp_path):
    """A hint over the byte cap is dropped: the peer's heal is incomplete,
    so the returning node's fence merges the shard once every peer's
    hints-replayed is in, and the peer's sync follows once that fence
    has lifted."""
    cl = Cluster(tmp_path, "ppp", hint_max_bytes=1)
    try:
        _wait(lambda: all(len(n.cluster.nodes) == 3 for n in cl.nodes),
              what="membership")
        for path in ("/index/d", "/index/d/field/f"):
            assert _post(cl.uris[0], path, {})[0] == 200
        s = next(s for s in range(N_SHARDS) if cl.owners(s) == {"a", "c"})
        assert _post(cl.uris[0], "/index/d/field/f/import",
                     {"rowIDs": [1], "columnIDs": [s * SW + 1]})[0] == 200
        cl.nodes[2].close()
        _wait(lambda: _down_everywhere(cl, 2), what="mark-down")
        col = s * SW + 77
        assert _post(cl.uris[0], "/index/d/query",
                     f"Set({col}, f=1)")[1] == {"results": [True]}
        assert cl.nodes[0].hints.snapshot()["dropped"] >= 1
        cl.reopen(2)
        _wait(lambda: _healed(cl, 2), what="heal")
        for i in (0, 2):
            assert _remote(cl.uris[i], [s], "Row(f=1)")[1]["results"][0][
                "columns"] == [s * SW + 1, col]
    finally:
        cl.close()
