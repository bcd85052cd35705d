"""SWIM gossip over UDP: membership and failure detection.

A copy of pilosa_tpu/parallel/gossip.py (the port imports nothing of the
JAX package), with the same datagrams, so port and JAX nodes gossip with
each other. Each protocol period a node probes one member (ping, ack),
falls back to indirect pings through other members (ping-req), moves a
member that does not answer through alive -> suspect -> dead, and
piggybacks node-state updates on every datagram, each sent about
retransmit_mult * log2(N + 2) times; every push_pull_interval it syncs
its whole member list with one peer (sync, sync-ack). A node that hears
itself suspected or dead bumps its incarnation and gossips alive
(refutation). The override rules: alive beats suspect or alive at a
lower incarnation; suspect beats alive at an equal or higher one and
suspect at a higher one; dead beats everything but dead at an equal or
higher one.

Wire format: one JSON object a datagram:
  ping      {t, seq, from}
  ack       {t, seq, from}
  ping-req  {t, seq, of, target: [host, port], from}
  sync      {t, states: [...]}
  sync-ack  {t, states: [...]}
each with "updates": [{id, host, port, state, inc, meta?}]. With a
secret_key every datagram is sealed with AES-GCM (utils/aesgcm.py); a
keyed node drops cleartext and anything that fails authentication,
counted in crypto_drops. Seeds are "host:port", a bare host
(DEFAULT_PORT 14000), ":port" or "[v6]:port" (parse_seed); a wildcard
bind advertises the host's outbound address.

With `clock` set (the server's HybridLogicalClock, utils/events.py)
every datagram sent carries a fresh stamp as "hlc": [ms, logical],
inside the AES-GCM seal like every other field, and every datagram
received merges its stamp (:185-190, :336-338, :377-378), so a gossip
hop orders the event journal as an RPC does. Added: the seconds spent
sealing and opening and the datagrams each covers (seal_s, sealed,
open_s, opened).
"""

from __future__ import annotations

import json
import math
import random
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from pilosa_tpu_torch.utils import threads


ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"

_MAX_DATAGRAM = 60_000
_MAX_PIGGYBACK = 8
# the reference's gossip port default (server/config.go:126 sets
# Config.Gossip.Port = "14000"); used for seeds given as bare hosts
DEFAULT_PORT = 14000


def parse_seed(s: str) -> tuple[str, int]:
    """'host:port', bare 'host' (gets DEFAULT_PORT), ':port' (localhost),
    or '[v6]:port' -> (host, port). Raises ValueError with the offending
    seed on garbage, so a config typo fails loudly at startup."""
    s = s.strip()
    if s.startswith("["):  # bracketed IPv6
        host, sep, rest = s[1:].partition("]")
        if not sep:
            raise ValueError(f"bad gossip seed {s!r}")
        rest = rest.lstrip(":")
        return host, int(rest) if rest else DEFAULT_PORT
    if s.count(":") >= 2:
        # unbracketed IPv6 literal: cannot carry a port ("fe80::2:14000"
        # would be ambiguous — bracket it to add one)
        return s, DEFAULT_PORT
    host, sep, port = s.rpartition(":")
    if not sep:
        return s, DEFAULT_PORT
    if not port.isdigit():
        raise ValueError(f"bad gossip seed {s!r}")
    return host or "127.0.0.1", int(port)


def _literal_family(host: str):
    """socket family of a literal IP, or None for hostnames."""
    for fam in (socket.AF_INET, socket.AF_INET6):
        try:
            socket.inet_pton(fam, host)
            return fam
        except OSError:
            pass
    return None


def _advertise_for(bound_host: str) -> str:
    """A peer-reachable address for a bound socket: the bind address when
    concrete, else (wildcard bind) the host's primary outbound interface
    (the UDP-connect trick — no packet is sent), else loopback."""
    if bound_host not in ("0.0.0.0", "::", ""):
        return bound_host
    probe = socket.socket(
        socket.AF_INET6 if bound_host == "::" else socket.AF_INET,
        socket.SOCK_DGRAM)
    try:
        probe.connect(("2001:db8::1", 9) if bound_host == "::"
                      else ("192.0.2.1", 9))
        return probe.getsockname()[0]
    except OSError:
        return "::1" if bound_host == "::" else "127.0.0.1"
    finally:
        probe.close()


@dataclass
class Member:
    """Last known state of one cluster member."""

    id: str
    host: str
    port: int
    state: str = ALIVE
    incarnation: int = 0
    meta: dict = field(default_factory=dict)
    # local bookkeeping, never gossiped
    suspect_since: float = 0.0

    @property
    def addr(self) -> tuple[str, int]:
        return (self.host, self.port)

    def to_update(self) -> dict:
        u = {"id": self.id, "host": self.host, "port": self.port,
             "state": self.state, "inc": self.incarnation}
        if self.state == ALIVE and self.meta:
            u["meta"] = self.meta
        return u


@dataclass
class GossipConfig:
    """Timings follow memberlist's LAN profile shape, scaled by `period`.

    Tests shrink `period` to tens of milliseconds; the suspicion window
    scales with it and with log(N) exactly as memberlist's
    SuspicionMult * ProbeInterval * log(N) does.
    """

    period: float = 1.0            # protocol period (ProbeInterval)
    probe_timeout: float = 0.5     # direct-ack wait (ProbeTimeout)
    indirect_probes: int = 3       # ping-req fan-out (IndirectChecks)
    suspicion_mult: float = 4.0    # suspect->dead window multiplier
    retransmit_mult: float = 3.0   # piggyback retransmissions multiplier
    push_pull_interval: float = 10.0  # full-state anti-entropy period


class Gossip:
    """One node's gossip endpoint: socket, prober, and member map."""

    def __init__(self, node_id: str, bind_host: str = "127.0.0.1",
                 bind_port: int = 0, *, advertise_host: str = "",
                 meta: Optional[dict] = None,
                 config: Optional[GossipConfig] = None,
                 on_alive: Optional[Callable[[Member], None]] = None,
                 on_suspect: Optional[Callable[[Member], None]] = None,
                 on_dead: Optional[Callable[[Member], None]] = None,
                 secret_key: Optional[bytes] = None,
                 logger=None) -> None:
        self.node_id = node_id
        self.config = config or GossipConfig()
        # shared-key transport encryption ([gossip] secret): every
        # datagram sealed with AES-GCM; unauthenticated traffic dropped
        self._cipher = None
        if secret_key:
            from pilosa_tpu_torch.utils.aesgcm import AESGCM
            self._cipher = AESGCM(secret_key)
        self.crypto_drops = 0  # cleartext/forged/undecryptable datagrams
        # the cipher's cost: seconds sealing and opening, datagrams each
        self.seal_s = self.open_s = 0.0
        self.sealed = self.opened = 0
        self._meta = dict(meta or {})
        self.on_alive = on_alive
        self.on_suspect = on_suspect
        self.on_dead = on_dead
        self.logger = logger
        self.clock = None  # a HybridLogicalClock, set by the server
        self._family = (socket.AF_INET6 if ":" in bind_host
                        else socket.AF_INET)
        self._sock = socket.socket(self._family, socket.SOCK_DGRAM)
        self._sock.bind((bind_host, bind_port))
        self._sock.settimeout(0.2)
        bound = self._sock.getsockname()
        self.port = bound[1]
        # the host gossiped to peers must be REACHABLE: a wildcard bind
        # ("0.0.0.0"/"::") gossiped verbatim would make every peer ping its
        # own loopback and declare this node dead (memberlist solves the
        # same problem with AdvertiseAddr)
        self.host = advertise_host or _advertise_for(bound[0])
        self._lock = threading.RLock()
        self.incarnation = 0
        self._members: dict[str, Member] = {}
        # piggyback queue: node id -> (update-json, transmissions left);
        # keying by id makes newer-update-replaces-older O(1)
        self._queue: dict[str, tuple[str, int]] = {}
        # seq -> Event set when the matching ack arrives
        self._acks: dict[int, threading.Event] = {}
        self._seq = 0
        self._probe_ring: list[str] = []  # shuffled round-robin of member ids
        self._seeds: list[tuple[str, int]] = []
        self._closed = threading.Event()
        self._threads: list[threading.Thread] = []

    # ------------------------------------------------------------- lifecycle

    def open(self, seeds: Optional[list[tuple[str, int]]] = None) -> None:
        """Start receiver + prober threads and push-pull join the seeds
        (joinWithRetry, gossip/gossip.go:112-119)."""
        for host, _ in seeds or []:
            # LITERAL-address family mismatch fails LOUDLY here: _send
            # swallows transient OSErrors, which would turn a v6 seed on a
            # v4 socket (or vice versa) into a node that silently never
            # joins. Hostnames are exempt — their family is only known at
            # resolution time.
            if _literal_family(host) not in (None, self._family):
                raise ValueError(
                    f"gossip seed {host!r} address family does not match "
                    f"the bind address family")
        self._seeds = [addr for addr in (seeds or [])
                       if addr != (self.host, self.port)]
        self._closed.clear()
        for target, name in ((self._recv_loop, "gossip-recv"),
                             (self._probe_loop, "gossip-probe")):
            self._threads.append(threads.spawn(
                target, name=f"{name}-{self.node_id}"))
        self._sync_seeds()

    def _sync_seeds(self) -> None:
        """Push-pull with every configured seed. Called at open AND
        retried from the protocol loop while the member map is empty: the
        join is one UDP datagram, so a single lost packet must not leave
        this node a permanent gossip island (the joinWithRetry analog,
        gossip/gossip.go:112-119)."""
        for addr in self._seeds:
            self._send(addr, {"t": "sync", "states": self._local_states()})

    def close(self) -> None:
        self._closed.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()
        self._sock.close()

    # ------------------------------------------------------------- inspection

    def members(self, state: Optional[str] = None) -> list[Member]:
        with self._lock:
            out = [Member(m.id, m.host, m.port, m.state, m.incarnation,
                          dict(m.meta)) for m in self._members.values()]
        me = Member(self.node_id, self.host, self.port, ALIVE,
                    self.incarnation, dict(self._meta))
        out.append(me)
        if state is not None:
            out = [m for m in out if m.state == state]
        return sorted(out, key=lambda m: m.id)

    # ------------------------------------------------------------- broadcast

    def broadcast_meta(self, meta: dict) -> None:
        """Gossip an application payload on this node's alive record (the
        NodeMeta/NotifyMsg channel the reference uses for node URIs,
        gossip/gossip.go:248-266)."""
        with self._lock:
            self._meta = meta
            # bump incarnation so the update outbids the alive record peers
            # already hold (alive at equal inc loses under SWIM precedence)
            self.incarnation += 1
            self._enqueue({"id": self.node_id, "host": self.host,
                           "port": self.port, "state": ALIVE,
                           "inc": self.incarnation, "meta": meta})

    # ------------------------------------------------------------- internals

    def _log(self, fmt: str, *args) -> None:
        if self.logger is not None:
            self.logger(f"gossip[{self.node_id}]: " + fmt % args)

    def _next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def _local_states(self) -> list[dict]:
        with self._lock:
            states = [m.to_update() for m in self._members.values()]
        states.append({"id": self.node_id, "host": self.host,
                       "port": self.port, "state": ALIVE,
                       "inc": self.incarnation, "meta": self._meta})
        return states

    def _n_transmissions(self) -> int:
        with self._lock:
            n = len(self._members) + 1
        return max(1, int(self.config.retransmit_mult * math.log2(n + 2)))

    def _enqueue(self, update: dict) -> None:
        """Queue an update for piggybacking; a newer update for the same
        node replaces the older one (TransmitLimitedQueue invalidation)."""
        with self._lock:
            self._queue[update["id"]] = (
                json.dumps(update, sort_keys=True), self._n_transmissions())

    def _take_piggyback(self) -> list[dict]:
        with self._lock:
            picked = sorted(self._queue.items(), key=lambda kv: -kv[1][1])
            picked = picked[:_MAX_PIGGYBACK]
            out = []
            for nid, (blob, remaining) in picked:
                out.append(json.loads(blob))
                if remaining <= 1:
                    del self._queue[nid]
                else:
                    self._queue[nid] = (blob, remaining - 1)
        return out

    def _send(self, addr: tuple[str, int], msg: dict) -> None:
        msg = dict(msg)
        # explicit updates (e.g. the tell-the-sender-it-is-suspected ack
        # path) ride in front of the piggyback queue
        msg["updates"] = msg.get("updates", []) + self._take_piggyback()
        if self.clock is not None:
            p, lc = self.clock.now()
            msg["hlc"] = [p, lc]
        data = json.dumps(msg).encode()
        if len(data) > _MAX_DATAGRAM:  # shed piggyback before giving up
            msg["updates"] = []
            data = json.dumps(msg).encode()
        if self._cipher is not None:
            from pilosa_tpu_torch.utils.aesgcm import seal
            t0 = time.perf_counter()
            data = seal(self._cipher, data)
            with self._lock:  # senders run on several threads
                self.seal_s += time.perf_counter() - t0
                self.sealed += 1
        try:
            self._sock.sendto(data, addr)
        except OSError:
            pass

    # ------------------------------------------------------------- receive

    def _recv_loop(self) -> None:
        while not self._closed.is_set():
            try:
                data, addr = self._sock.recvfrom(65535)
            except socket.timeout:
                continue
            except OSError:
                return
            if self._cipher is not None:
                # keyed transport: ONLY authentic ciphertext is admitted.
                # Cleartext (a mis-configured or pre-upgrade peer) and
                # forged/corrupt ciphertext drop silently — feeding
                # either into the membership state machine would let an
                # unkeyed sender inject suspicion/death rumors.
                from pilosa_tpu_torch.utils.aesgcm import open_sealed
                t0 = time.perf_counter()
                try:
                    data = open_sealed(self._cipher, data)
                except ValueError:
                    self.crypto_drops += 1
                    continue
                finally:
                    self.open_s += time.perf_counter() - t0
                    self.opened += 1
            try:
                msg = json.loads(data)
            except ValueError:
                continue
            if self.clock is not None and msg.get("hlc") is not None:
                self.clock.update(msg["hlc"])
            for u in msg.get("updates", []):
                self._apply_update(u)
            t = msg.get("t")
            if t == "ping":
                reply = {"t": "ack", "seq": msg["seq"],
                         "from": self.node_id}
                # a ping FROM a node we hold suspect/dead is the refutation
                # opportunity: hand the sender our rumor about it so it can
                # outbid it with an incarnation bump. Without this, a
                # falsely-dead node is never probed again (dead is out of
                # the ring) and may never hear the rumor it must refute.
                with self._lock:
                    m = self._members.get(msg.get("from"))
                    if m is not None and m.state != ALIVE:
                        reply["updates"] = [m.to_update()]
                self._send(addr, reply)
            elif t == "ack":
                with self._lock:
                    ev = self._acks.get(msg.get("seq"))
                if ev is not None:
                    ev.set()
                    # an ack MATCHING a pending probe is first-hand proof
                    # of life; an unmatched (stale/duplicated/forged) ack
                    # must NOT revive a dead member at its old incarnation
                    # — recovery from a false death goes through refutation
                    self._refresh_alive(msg.get("from"))
            elif t == "ping-req":
                self._relay_ping(addr, msg)
            elif t == "sync":
                for u in msg.get("states", []):
                    self._apply_update(u)
                self._send(addr, {"t": "sync-ack",
                                  "states": self._local_states()})
            elif t == "sync-ack":
                for u in msg.get("states", []):
                    self._apply_update(u)

    def _relay_ping(self, origin: tuple[str, int], msg: dict) -> None:
        """Probe `target` on behalf of `origin`; relay the ack back
        (memberlist indirect ping)."""

        def run() -> None:
            seq = self._next_seq()
            ev = threading.Event()
            with self._lock:
                self._acks[seq] = ev
            try:
                self._send(tuple(msg["target"]),
                           {"t": "ping", "seq": seq, "from": self.node_id})
                if ev.wait(self.config.probe_timeout):
                    self._send(origin, {"t": "ack", "seq": msg["seq"],
                                        "from": msg.get("of", "")})
            finally:
                with self._lock:
                    self._acks.pop(seq, None)

        threads.spawn(run, name="pilosa-torch-gossip")

    def _refresh_alive(self, node_id: Optional[str]) -> None:
        if not node_id:
            return
        changed = None
        with self._lock:
            m = self._members.get(node_id)
            if m is not None and m.state != ALIVE:
                m.state = ALIVE
                m.suspect_since = 0.0
                changed = m
                self._enqueue(m.to_update())
        if changed is not None and self.on_alive:
            self.on_alive(changed)

    # ------------------------------------------------------------- state rules

    def _apply_update(self, u: dict) -> None:
        """SWIM override rules; fires on_* callbacks on state transitions."""
        try:
            uid, state, inc = u["id"], u["state"], int(u["inc"])
        except (KeyError, TypeError, ValueError):
            return
        if uid == self.node_id:
            # refutation: someone thinks we are suspect/dead — outbid them
            if state in (SUSPECT, DEAD):
                with self._lock:
                    self.incarnation = max(self.incarnation, inc) + 1
                    self._enqueue({"id": self.node_id, "host": self.host,
                                   "port": self.port, "state": ALIVE,
                                   "inc": self.incarnation,
                                   "meta": self._meta})
                self._log("refuting %s at inc %d", state, inc)
            return
        fire = None
        with self._lock:
            m = self._members.get(uid)
            if m is None:
                # an unknown node's death IS news (a push-pull merge may be
                # the first we hear of it at all — the application layer can
                # know the node through other membership channels): track
                # the dead record and fire on_dead, same as memberlist's
                # merge path. Dead records are skipped by the probe ring.
                m = Member(uid, u.get("host", ""), int(u.get("port", 0)),
                           state, inc, u.get("meta") or {})
                if state == SUSPECT:
                    m.suspect_since = time.monotonic()
                self._members[uid] = m
                self._probe_ring = []  # re-deal the probe order
                self._enqueue(m.to_update())
                fire = (state, m)
            else:
                old = m.state
                wins = (
                    (state == ALIVE and inc > m.incarnation) or
                    (state == SUSPECT and
                     ((old == ALIVE and inc >= m.incarnation) or
                      (old == SUSPECT and inc > m.incarnation))) or
                    (state == DEAD and old != DEAD and inc >= m.incarnation)
                )
                if not wins:
                    return
                m.incarnation = inc
                m.state = state
                if u.get("host"):
                    m.host, m.port = u["host"], int(u.get("port", m.port))
                if state == ALIVE:
                    m.suspect_since = 0.0
                    if u.get("meta"):
                        m.meta = u["meta"]
                elif state == SUSPECT and old != SUSPECT:
                    m.suspect_since = time.monotonic()
                self._enqueue(m.to_update())
                if state != old:
                    fire = (state, m)
        if fire is not None:
            state, m = fire
            cb = {ALIVE: self.on_alive, SUSPECT: self.on_suspect,
                  DEAD: self.on_dead}[state]
            if cb:
                cb(m)

    # ------------------------------------------------------------- probing

    def _suspicion_window(self) -> float:
        with self._lock:
            n = len(self._members) + 1
        return (self.config.suspicion_mult * self.config.period *
                max(1.0, math.log10(max(n, 1)) + 1.0))

    def _next_probe_target(self) -> Optional[Member]:
        with self._lock:
            if not self._probe_ring:
                self._probe_ring = [m.id for m in self._members.values()
                                    if m.state != DEAD]
                random.shuffle(self._probe_ring)
            while self._probe_ring:
                mid = self._probe_ring.pop()
                m = self._members.get(mid)
                if m is not None and m.state != DEAD:
                    return m
        return None

    def _probe_loop(self) -> None:
        last_push_pull = time.monotonic()
        while not self._closed.wait(self.config.period):
            self._expire_suspects()
            target = self._next_probe_target()
            if target is None:
                # no live members at all: (re)join through the seeds — the
                # open()-time join datagram may have been lost
                self._sync_seeds()
                continue
            self._probe(target)
            now = time.monotonic()
            if now - last_push_pull >= self.config.push_pull_interval:
                last_push_pull = now
                peer = self._next_probe_target()
                if peer is not None:
                    self._send(peer.addr,
                               {"t": "sync", "states": self._local_states()})
                else:
                    self._sync_seeds()

    def _probe(self, target: Member) -> None:
        seq = self._next_seq()
        ev = threading.Event()
        with self._lock:
            self._acks[seq] = ev
        try:
            self._send(target.addr, {"t": "ping", "seq": seq,
                                     "from": self.node_id})
            if ev.wait(self.config.probe_timeout):
                self._refresh_alive(target.id)
                return
            # indirect: ask k other live members to probe on our behalf
            with self._lock:
                others = [m for m in self._members.values()
                          if m.state == ALIVE and m.id != target.id]
            for relay in random.sample(
                    others, min(self.config.indirect_probes, len(others))):
                self._send(relay.addr,
                           {"t": "ping-req", "seq": seq, "of": target.id,
                            "target": list(target.addr),
                            "from": self.node_id})
            if ev.wait(self.config.probe_timeout):
                self._refresh_alive(target.id)
                return
        finally:
            with self._lock:
                self._acks.pop(seq, None)
        self._suspect(target.id)

    def _suspect(self, node_id: str) -> None:
        fire = None
        with self._lock:
            m = self._members.get(node_id)
            if m is None or m.state != ALIVE:
                return
            m.state = SUSPECT
            m.suspect_since = time.monotonic()
            self._enqueue(m.to_update())
            fire = m
        self._log("suspect %s (no ack)", node_id)
        if self.on_suspect:
            self.on_suspect(fire)

    def _expire_suspects(self) -> None:
        window = self._suspicion_window()
        now = time.monotonic()
        expired = []
        with self._lock:
            for m in self._members.values():
                if m.state == SUSPECT and now - m.suspect_since >= window:
                    m.state = DEAD
                    self._enqueue(m.to_update())
                    expired.append(m)
        for m in expired:
            self._log("suspect %s expired -> dead", m.id)
            if self.on_dead:
                self.on_dead(m)
