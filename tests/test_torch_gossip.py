"""SWIM gossip and its AES-GCM, the port's copies against the JAX package's.

pilosa_tpu_torch/utils/aesgcm.py and parallel/gossip.py are copies of the
JAX modules (the port imports nothing of the JAX package). Held here: the
cipher's known-answer vectors (FIPS-197, NIST SP 800-38D) on the
standard-library path and on the default one (the `cryptography`
package where it can be imported), equal bytes from both modules at a
fixed nonce and datagrams sealed by one opened by the other, the SWIM
override rules as one table run against both modules, seed parsing, a
port endpoint and a JAX endpoint that converge, suspect and mark a dead
member, a node with the wrong key that never joins, and two port Servers
that find each other by gossip alone (with a secret) and mark a closed
one down. Timings are shrunk as the JAX package's tests shrink them;
every wait polls with a deadline.
"""

import json
import socket
import time

import pytest

from pilosa_tpu.parallel import gossip as jax_gossip
from pilosa_tpu.utils import aesgcm as jax_aesgcm
from pilosa_tpu_torch.parallel import gossip as port_gossip
from pilosa_tpu_torch.utils import aesgcm as port_aesgcm

FAST = dict(period=0.05, probe_timeout=0.05, push_pull_interval=0.3,
            suspicion_mult=3.0)
MODULES = {"port": port_gossip, "jax": jax_gossip}


def wait_for(cond, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def alive_ids(g) -> set:
    return {m.id for m in g.members(state=port_gossip.ALIVE)}


def close_all(nodes) -> None:
    for g in nodes:
        try:
            g.close()
        except OSError:
            pass


@pytest.fixture(params=["stdlib", "default"])
def backend(request, monkeypatch):
    """stdlib: both modules' pure-Python cipher (the card's machine has no
    `cryptography`); default: whatever each module picks here."""
    if request.param == "stdlib":
        monkeypatch.setattr(port_aesgcm, "_LibAESGCM", None)
        monkeypatch.setattr(jax_aesgcm, "_LibAESGCM", None)
    return request.param


def test_aesgcm_known_answer_vectors(backend):
    a = port_aesgcm
    w, nr = a._expand_key(bytes.fromhex("000102030405060708090a0b0c0d0e0f"))
    assert a._encrypt_block(
        w, nr, bytes.fromhex("00112233445566778899aabbccddeeff")).hex() \
        == "69c4e0d86a7b0430d8cdb78070b4c55a"  # FIPS-197 C.1
    w, nr = a._expand_key(bytes(range(32)))
    assert a._encrypt_block(
        w, nr, bytes.fromhex("00112233445566778899aabbccddeeff")).hex() \
        == "8ea2b7ca516745bfeafc49904b496089"  # FIPS-197 C.3
    w, nr = a._expand_key(b"\x00" * 16)
    assert a._encrypt_block(w, nr, b"\x00" * 16).hex() \
        == "66e94bd4ef8a2c3b884cfa59ca342b2e"  # the GHASH key H
    g = a.AESGCM(b"\x00" * 16)  # GCM test case 2
    assert g.encrypt(b"\x00" * 12, b"\x00" * 16).hex() == (
        "0388dace60b6a392f328c2b971b2fe78"
        "ab6e47d42cec13bdf53a67b21257bddf")
    key = bytes.fromhex("feffe9928665731c6d6a8f9467308308")  # case 3
    iv = bytes.fromhex("cafebabefacedbaddecaf888")
    pt = bytes.fromhex(
        "d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
        "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b391aafd255")
    ct = a.AESGCM(key).encrypt(iv, pt)
    assert ct.hex() == (
        "42831ec2217774244b7221b784d0d49ce3aa212f2c02a4e035c17e2329aca12e"
        "21d514b25466931c7d8f6a5aac84aa051ba30b396a0aac973d58e091473f5985"
        "4d5c2af327cd64a62cf35abd2ba6fab4")
    assert a.AESGCM(key).decrypt(iv, ct) == pt
    with pytest.raises(ValueError):
        a.AESGCM(key).decrypt(iv, ct[:-1] + bytes([ct[-1] ^ 1]))


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 100, 1200])
def test_aesgcm_cross_sealed_at_a_fixed_nonce(backend, n):
    """Equal bytes from both modules, and each opens the other's
    datagrams; a wrong key or a cleartext datagram is refused by both."""
    data = bytes((i * 37 + 11) % 256 for i in range(n))
    assert port_aesgcm.derive_key("s3cret") == jax_aesgcm.derive_key("s3cret")
    key = port_aesgcm.derive_key("s3cret")
    p, j = port_aesgcm.AESGCM(key), jax_aesgcm.AESGCM(key)
    nonce = bytes(range(12))
    assert p.encrypt(nonce, data, b"aad") == j.encrypt(nonce, data, b"aad")
    assert jax_aesgcm.open_sealed(j, port_aesgcm.seal(p, data)) == data
    assert port_aesgcm.open_sealed(p, jax_aesgcm.seal(j, data)) == data
    wrong = port_aesgcm.AESGCM(port_aesgcm.derive_key("other"))
    for mod, k in ((port_aesgcm, wrong),
                   (jax_aesgcm, jax_aesgcm.AESGCM(
                       jax_aesgcm.derive_key("other")))):
        with pytest.raises(ValueError):
            mod.open_sealed(k, port_aesgcm.seal(p, data))
        with pytest.raises(ValueError):
            mod.open_sealed(k, b'{"t": "ping"}' + data)


# (state held, update's state, update's inc) -> state after; the member
# is held at incarnation 5
OVERRIDES = [
    ("alive", "alive", 4, "alive"), ("alive", "alive", 6, "alive"),
    ("alive", "suspect", 4, "alive"), ("alive", "suspect", 5, "suspect"),
    ("alive", "dead", 4, "alive"), ("alive", "dead", 5, "dead"),
    ("suspect", "alive", 5, "suspect"), ("suspect", "alive", 6, "alive"),
    ("suspect", "suspect", 5, "suspect"), ("suspect", "dead", 5, "dead"),
    ("dead", "suspect", 5, "dead"), ("dead", "alive", 5, "dead"),
    ("dead", "alive", 6, "alive"), ("dead", "dead", 9, "dead"),
]


@pytest.mark.parametrize("module", sorted(MODULES))
@pytest.mark.parametrize("held,state,inc,want", OVERRIDES)
def test_swim_override_rules(module, held, state, inc, want):
    mod = MODULES[module]
    g = mod.Gossip("me")
    try:
        g._members["x"] = mod.Member("x", "127.0.0.1", 1, held, 5)
        fired = []
        g.on_alive = g.on_suspect = g.on_dead = \
            lambda m: fired.append(m.state)
        g._apply_update({"id": "x", "host": "127.0.0.1", "port": 1,
                         "state": state, "inc": inc})
        m = g._members["x"]
        assert m.state == want
        assert fired == ([want] if want != held else [])
        # a rumor about this node itself is refuted with a higher
        # incarnation
        g._apply_update({"id": "me", "host": g.host, "port": g.port,
                         "state": "suspect", "inc": 7})
        assert g.incarnation == 8
    finally:
        g._sock.close()


@pytest.mark.parametrize("seed", ["10.0.0.5:7001", "10.0.0.5",
                                  "node-a.local", ":7001", "[::1]:7001",
                                  "[fe80::2]", "::1", "fe80::2",
                                  "host:notaport", "[::1"])
def test_parse_seed_as_jax(seed):
    def parse(mod):
        try:
            return mod.parse_seed(seed)
        except ValueError:
            return "ValueError"

    assert parse(port_gossip) == parse(jax_gossip)
    assert port_gossip.DEFAULT_PORT == jax_gossip.DEFAULT_PORT == 14000


@pytest.mark.parametrize("secret", ["", "cluster-secret"])
def test_port_and_jax_endpoints_converge_and_mark_dead(secret):
    """Port n0, JAX n1 and port n2 join through n0; all three see each
    other alive; n1 (JAX) and then n2 (port) close: the survivors mark
    each dead (suspicion, then expiry) and fire on_dead."""
    key = port_aesgcm.derive_key(secret) if secret else None
    mods = [port_gossip, jax_gossip, port_gossip]
    dead_seen: dict = {0: [], 2: []}
    nodes = [mod.Gossip(f"n{i}", config=mod.GossipConfig(**FAST),
                        secret_key=key) for i, mod in enumerate(mods)]
    for i in (0, 2):
        nodes[i].on_dead = lambda m, i=i: dead_seen[i].append(m.id)
    try:
        seed = (nodes[0].host, nodes[0].port)
        for i, g in enumerate(nodes):
            g.open(seeds=[seed] if i else [])
        want = {"n0", "n1", "n2"}
        wait_for(lambda: all(alive_ids(g) == want for g in nodes),
                 msg="port and JAX endpoints converge")
        nodes[1].close()
        wait_for(lambda: all("n1" in {m.id for m in g.members(state="dead")}
                             for g in (nodes[0], nodes[2])), timeout=20.0,
                 msg="the JAX endpoint marked dead by both port ones")
        assert "n1" in dead_seen[0] and "n1" in dead_seen[2]
        if secret:
            assert nodes[0].sealed > 0 and nodes[0].opened > 0
            assert nodes[0].seal_s > 0 and nodes[0].open_s > 0
    finally:
        close_all(nodes)


def test_wrong_key_node_never_joins():
    """A port node and a JAX node share a key; a port node with another
    key never joins either, and learns nothing; its datagrams are counted
    as crypto drops. A cleartext rumor is dropped too."""
    right = port_aesgcm.derive_key("right")
    a = port_gossip.Gossip("r0", config=port_gossip.GossipConfig(**FAST),
                           secret_key=right)
    b = jax_gossip.Gossip("r1", config=jax_gossip.GossipConfig(**FAST),
                          secret_key=right)
    w = port_gossip.Gossip("w0", config=port_gossip.GossipConfig(**FAST),
                           secret_key=port_aesgcm.derive_key("wrong"))
    try:
        a.open(seeds=[])
        b.open(seeds=[(a.host, a.port)])
        wait_for(lambda: alive_ids(a) == {"r0", "r1"} == alive_ids(b),
                 msg="the keyed pair converges")
        w.open(seeds=[(a.host, a.port)])
        # several protocol periods of the wrong key's datagrams dropped
        wait_for(lambda: a.crypto_drops >= 5, msg="the wrong key dropped")
        assert "w0" not in alive_ids(a) | alive_ids(b)
        assert alive_ids(w) == {"w0"}
        rumor = {"t": "ping", "seq": 1, "from": "liar", "updates": [
            {"id": "r1", "host": b.host, "port": b.port, "state": "dead",
             "inc": 99}]}
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(json.dumps(rumor).encode(), (a.host, a.port))
        s.close()
        drops = a.crypto_drops
        wait_for(lambda: a.crypto_drops > drops, msg="cleartext dropped")
        assert "r1" in alive_ids(a)
    finally:
        close_all([a, b, w])


def test_port_servers_find_each_other_by_gossip(tmp_path):
    """Two port Servers with no cluster hosts and a shared secret: gossip
    alone makes each a member of the other (the URI from the alive
    record), an index created on one reaches the other, and a closed one
    is marked down by suspicion; /debug/vars has the gossip block."""
    from pilosa_tpu_torch.server import Server
    from tests.test_torch_obs_slice import _call

    cfg = port_gossip.GossipConfig(**FAST)
    a = Server(str(tmp_path / "a"), port=0, device="cpu", node_id="a",
               replica_n=2, gossip_port=0, gossip_config=cfg,
               gossip_secret="hush").open()
    try:
        b = Server(str(tmp_path / "b"), port=0, device="cpu", node_id="b",
                   replica_n=2, gossip_port=0,
                   gossip_config=port_gossip.GossipConfig(**FAST),
                   gossip_seeds=[f"127.0.0.1:{a.gossip.port}"],
                   gossip_secret="hush").open()
        try:
            wait_for(lambda: {n.id for n in a.cluster.nodes}
                     == {"a", "b"} == {n.id for n in b.cluster.nodes},
                     msg="membership found by gossip")
            assert any(n.uri == b.uri for n in a.cluster.nodes)
            st, _ = _call(a.uri, "POST", "/index/d", b"{}")
            assert st == 200 and b.holder.index("d") is not None
            st, dv = _call(a.uri, "GET", "/debug/vars")
            g = dv["gossip"]
            assert g["encrypted"] and g["members"]["b"] == "alive"
            assert g["sealed"] > 0 and g["cryptoDrops"] == 0
        finally:
            b.close()
        wait_for(lambda: a.cluster.is_down("b"), timeout=30.0,
                 msg="the closed node marked down by suspicion")
        assert a.cluster.state == "DEGRADED"
    finally:
        a.close()
