"""The event journal: typed, HLC-stamped records of what happened.

Copy of pilosa_tpu/utils/events.py (the port imports nothing of the JAX
package), with the same registry, stamps, feeds and spool lines, so a
mixed cluster of port and JAX nodes merges into one timeline and either
package reloads the other's spool:

* `HybridLogicalClock`: a (physical ms, logical) hybrid logical clock.
  The physical half is the largest of the local wall and every stamp
  seen, the logical half breaks ties. Every internal RPC (the
  X-Pilosa-HLC header, both ways) and every gossip datagram (its `hlc`
  field) carries the sender's stamp and the receiver merges it, so an
  event a node records after hearing from a peer sorts after the peer's
  event that caused it, whatever the wall clocks say.
* `EVENT_TYPES` and `EventJournal`: the typed registry (an unregistered
  type raises) over one node's bounded ring with two lanes (a log.warn
  storm cannot evict the lifecycle events), `since()` cursors as
  /debug/timeseries has them, and an optional durable spool with one
  rotation, reloaded at boot.
* crash dumps: `register_crash_dump` and the SIGQUIT handler write every
  registered journal to `events.crash-<ts>.jsonl` in its data dir; the
  process goes on serving.

`PILOSA_TPU_EVENTS=0` turns recording off (read per emit), the JAX
package's switch.

`xla.recompile_storm` stays registered, so that a JAX peer's event
merges and a JAX spool reloads; the port never emits it, because it
compiles nothing per shape (utils/telemetry.py has no XLA counters).

One departure: `emit` takes the stamp, the seq and the spool write under
the journal's one lock, so one node's seq order is its HLC order and its
spool's line order, whatever the threads. The JAX journal stamps before
its lock and spools after it, so two threads can record a later stamp
under an earlier seq.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, Optional

# -- kill switch -------------------------------------------------------------


def enabled() -> bool:
    """PILOSA_TPU_EVENTS=0 stops all recording (read per emit)."""
    return os.environ.get("PILOSA_TPU_EVENTS", "1") != "0"


# -- hybrid logical clock ----------------------------------------------------

# the header that carries the sender's stamp on every internal RPC and
# its response; gossip datagrams carry it as an `hlc` field
HLC_HEADER = "X-Pilosa-HLC"


class HybridLogicalClock:
    """A (physical_ms, logical) hybrid logical clock (Kulkarni et al.):
    `now()` stamps a local event, `update(remote)` merges a received
    stamp. physical_ms never runs backwards (a stepped wall only stalls
    it, the logical half keeps the order), and a merge lifts it to the
    remote's, so a causally later event always carries a larger stamp."""

    def __init__(self, wall_ms: Optional[Callable[[], int]] = None):
        # injectable wall: the skew tests give each node a wrong one
        self._wall_ms = wall_ms or (lambda: int(time.time() * 1000))
        self._lock = threading.Lock()
        self._physical = 0
        self._logical = 0

    def now(self) -> tuple[int, int]:
        """Stamp one local event (a send or a record)."""
        wall = self._wall_ms()
        with self._lock:
            if wall > self._physical:
                self._physical = wall
                self._logical = 0
            else:
                self._logical += 1
            return self._physical, self._logical

    def update(self, remote) -> tuple[int, int]:
        """Merge a received stamp (a pair or a [ms, lc] list) and stamp
        the receive. Garbage merges as a plain local tick."""
        try:
            r_p, r_l = int(remote[0]), int(remote[1])
        except (TypeError, ValueError, IndexError):
            return self.now()
        wall = self._wall_ms()
        with self._lock:
            if wall > self._physical and wall > r_p:
                self._physical = wall
                self._logical = 0
            elif r_p > self._physical:
                self._physical = r_p
                self._logical = r_l + 1
            elif r_p == self._physical:
                self._logical = max(self._logical, r_l) + 1
            else:
                self._logical += 1
            return self._physical, self._logical

    def peek(self) -> tuple[int, int]:
        with self._lock:
            return self._physical, self._logical


def encode_hlc(stamp: tuple[int, int]) -> str:
    """The header's and gossip field's form: "<ms>.<logical>"."""
    return f"{stamp[0]}.{stamp[1]}"


def decode_hlc(value) -> Optional[tuple[int, int]]:
    """Inverse of encode_hlc; None for an absent or malformed value
    (never raises: a bad header must not break dispatch)."""
    if not value or not isinstance(value, str):
        return None
    head, _, tail = value.partition(".")
    try:
        return int(head), int(tail or 0)
    except ValueError:
        return None


# -- typed event registry ----------------------------------------------------

# each lane is a bounded ring of its own: a storm in one (log lines under
# an error loop) never evicts the other's lifecycle transitions
LANE_LIFECYCLE = "lifecycle"
LANE_LOG = "log"
LANES = (LANE_LIFECYCLE, LANE_LOG)

# type -> (lane, description): the JAX package's registry, key for key;
# it is the wire and the spool format of mixed clusters
EVENT_TYPES: dict[str, tuple[str, str]] = {
    # node lifecycle
    "node.start": (LANE_LIFECYCLE, "server process opened its holder and "
                                   "began serving"),
    "node.stop": (LANE_LIFECYCLE, "server close() began"),
    "drain.start": (LANE_LIFECYCLE, "graceful drain began: new external "
                                    "queries shed, DRAINING broadcast"),
    "drain.complete": (LANE_LIFECYCLE, "drain finished: in-flight work "
                                       "settled, final snapshots landed"),
    "drain.abort": (LANE_LIFECYCLE, "drain cancelled; READY re-announced"),
    # peer view transitions (this node's observation of a peer)
    "peer.draining": (LANE_LIFECYCLE, "peer announced DRAINING; routing "
                                      "around it"),
    "peer.down": (LANE_LIFECYCLE, "peer marked down (liveness/gossip)"),
    "peer.up": (LANE_LIFECYCLE, "peer marked back up"),
    "peer.rejoined": (LANE_LIFECYCLE, "peer announced READY after a "
                                      "drain/outage; return-heal started"),
    # rejoin read fence
    "fence.armed": (LANE_LIFECYCLE, "local shards read-fenced pending "
                                    "parity verification"),
    "fence.lifted": (LANE_LIFECYCLE, "a fenced shard verified parity (or "
                                     "healed) and lifted"),
    "fence.expired": (LANE_LIFECYCLE, "fence timed out unverified; "
                                      "availability won, scrubber heals"),
    # durable hinted handoff
    "hint.append": (LANE_LIFECYCLE, "replica write skipped (target "
                                    "down/draining) queued to its hint "
                                    "log"),
    "hint.replay": (LANE_LIFECYCLE, "queued hints streamed to a returned "
                                    "peer"),
    "hint.drop": (LANE_LIFECYCLE, "hint dropped (byte/age cap, damage); "
                                  "anti-entropy must finish the heal"),
    # storage integrity
    "wal.truncated": (LANE_LIFECYCLE, "torn WAL tail truncated at open"),
    "snapshot.quarantined": (LANE_LIFECYCLE, "fragment snapshot failed "
                                             "integrity; quarantined and "
                                             "reopened empty"),
    "scrub.pass": (LANE_LIFECYCLE, "anti-entropy scrub pass completed"),
    # QoS overload control
    "qos.shed_storm.start": (LANE_LIFECYCLE, "shed/throttle rate crossed "
                                             "the storm threshold"),
    "qos.shed_storm.end": (LANE_LIFECYCLE, "shed storm subsided"),
    "qos.quota_debt": (LANE_LIFECYCLE, "a principal's quota bucket went "
                                       "into deep debt (rate-limited per "
                                       "principal)"),
    # device / compile health
    "xla.recompile_storm": (LANE_LIFECYCLE, "one kernel family compiled a "
                                            "storm of new shapes"),
    "health.transition": (LANE_LIFECYCLE, "this node's health score "
                                          "changed (green/yellow/red)"),
    # cluster shape
    "topology.change": (LANE_LIFECYCLE, "cluster topology fingerprint "
                                        "changed (membership, liveness, "
                                        "drain set)"),
    "ici.route_flip": (LANE_LIFECYCLE, "a memoized slice-local routing "
                                       "decision flipped under a new "
                                       "topology"),
    "resize.start": (LANE_LIFECYCLE, "cluster resize job started"),
    "resize.complete": (LANE_LIFECYCLE, "cluster resize job completed"),
    "resize.abort": (LANE_LIFECYCLE, "cluster resize job aborted"),
    # logger bridge (utils/logger.py warnf/errorf)
    "log.warn": (LANE_LOG, "a WARN log line (logger bridge)"),
    "log.error": (LANE_LOG, "an ERROR log line (logger bridge)"),
}


def event_lane(etype: str) -> str:
    return EVENT_TYPES[etype][0]


def record(journal, etype: str, **fields) -> None:
    """`journal.emit(etype, **fields)` where there is a journal; never
    raises: recording must not break what it observes (an admission, an
    acknowledged write, a routing decision)."""
    if journal is None:
        return
    try:
        journal.emit(etype, **fields)
    except Exception:  # noqa: BLE001 — see above
        pass


# -- the journal -------------------------------------------------------------


class EventJournal:
    """One node's ring: a bounded deque per lane under one ascending seq,
    every event stamped by the node's clock. `since(cursor)` serves GET
    /debug/events; with a spool every event is also appended as a JSON
    line, so the events outlive the process."""

    def __init__(self, node_id: str = "", ring_size: int = 2048,
                 clock: Optional[HybridLogicalClock] = None,
                 spool_path: str = "", spool_max_bytes: int = 0,
                 stats=None):
        self.node_id = node_id
        self.ring_size = max(1, int(ring_size))
        self.clock = clock or HybridLogicalClock()
        # the log lane, the storm-prone one, gets a quarter of the budget
        self._lanes: dict[str, collections.deque] = {
            LANE_LIFECYCLE: collections.deque(maxlen=self.ring_size),
            LANE_LOG: collections.deque(
                maxlen=max(1, self.ring_size // 4)),
        }
        self._lock = threading.Lock()
        self._seq = 0
        self.stats = stats
        # the spool: append-only JSON lines under a byte cap, one rotation
        # (<path>.1), so it never takes more than twice the cap
        self.spool_path = spool_path
        self.spool_max_bytes = int(spool_max_bytes)
        self._spool_bytes = 0
        self.spool_errors = 0
        self.emitted = 0
        self.reloaded = 0
        self.dropped_disabled = 0
        self.evicted: dict[str, int] = dict.fromkeys(LANES, 0)
        self.by_type: dict[str, int] = {}
        if spool_path and self.spool_max_bytes > 0:
            # a restarted node's earlier events stay on the timeline
            self._reload_spool()

    def _reload_spool(self) -> None:
        """Refill the ring from the spool's tail (the earlier process's
        events with their stamps) and move the clock past the newest, so
        every new event sorts after them."""
        try:
            with open(self.spool_path, encoding="utf-8") as f:
                lines = f.readlines()
        except OSError:
            return
        last_hlc = None
        # the lanes bound what is kept; parsing more is wasted
        for line in lines[-(self.ring_size + self.ring_size // 4):]:
            try:
                e = json.loads(line)
            except ValueError:
                continue  # a line torn by a crash
            lane_desc = EVENT_TYPES.get(
                e.get("type")) if isinstance(e, dict) else None
            if lane_desc is None:
                continue
            with self._lock:
                self._seq += 1
                e = dict(e, seq=self._seq)
                self._lanes[lane_desc[0]].append(e)
                self.reloaded += 1
            if e.get("hlc"):
                last_hlc = e["hlc"]
        if last_hlc is not None:
            self.clock.update(last_hlc)

    # -- emit ---------------------------------------------------------------

    def emit(self, etype: str, **fields) -> Optional[dict]:
        """Record one event of a registered type (ValueError otherwise);
        the request's trace id and principal are attached when present.
        -> the event, or None when recording is off."""
        lane_desc = EVENT_TYPES.get(etype)
        if lane_desc is None:
            raise ValueError(
                f"unregistered event type {etype!r}: add it to "
                "pilosa_tpu_torch.utils.events.EVENT_TYPES (and the JAX "
                "package's registry)")
        if not enabled():
            self.dropped_disabled += 1
            return None
        lane = lane_desc[0]
        ev: dict = {
            "hlc": None,
            "ts": round(time.time(), 3),  # wall clock: for people only
            "type": etype,
            "node": self.node_id,
        }
        trace = _current_trace()
        if trace:
            ev["trace"] = trace
        principal = _current_principal()
        if principal and "principal" not in fields:
            ev["principal"] = principal
        for k, v in fields.items():
            if v is not None:
                ev[k] = v
        spool = self.spool_path and self.spool_max_bytes > 0
        with self._lock:
            stamp = self.clock.now()
            ev["hlc"] = [stamp[0], stamp[1]]
            self._seq += 1
            ev["seq"] = self._seq
            dq = self._lanes[lane]
            if len(dq) == dq.maxlen:
                self.evicted[lane] += 1
            dq.append(ev)
            self.emitted += 1
            self.by_type[etype] = self.by_type.get(etype, 0) + 1
            if spool:
                self._spool_locked(ev)
        if self.stats is not None:
            # the "events" family with a type label: pilosa_events_total
            self.stats.count(f"events,type:{etype}")
        return ev

    def _spool_locked(self, ev: dict) -> None:
        line = json.dumps(ev, separators=(",", ":")) + "\n"
        try:
            if self._spool_bytes == 0:
                try:
                    self._spool_bytes = os.path.getsize(self.spool_path)
                except OSError:
                    self._spool_bytes = 0
            if self._spool_bytes + len(line) > self.spool_max_bytes:
                # one rotation: the previous spool survives as .1
                os.replace(self.spool_path, self.spool_path + ".1")
                self._spool_bytes = 0
            with open(self.spool_path, "a", encoding="utf-8") as f:
                f.write(line)
            self._spool_bytes += len(line)
        except OSError:
            self.spool_errors += 1

    # -- read ---------------------------------------------------------------

    def events(self, cursor: int = 0) -> list[dict]:
        """Every retained event with seq > cursor, both lanes, in seq
        order (one node's seq order is its causal order)."""
        with self._lock:
            out = [e for dq in self._lanes.values() for e in dq
                   if e["seq"] > cursor]
        out.sort(key=lambda e: e["seq"])
        return out

    def since(self, cursor: int = 0, limit: int = 0,
              etype: Optional[str] = None,
              severity: Optional[str] = None) -> dict:
        """The /debug/events document: events newer than `cursor`, oldest
        first (the newest `limit` when set), of one type or lane when
        asked. `seq` is the next poll's cursor, also when nothing
        qualified."""
        out = self.events(cursor)
        if etype:
            out = [e for e in out if e["type"] == etype]
        if severity:
            out = [e for e in out
                   if event_lane(e["type"]) == severity]
        if limit > 0:
            out = out[-limit:]
        with self._lock:
            seq = self._seq
        return {"seq": seq, "events": out}

    def snapshot(self) -> dict:
        """The events block of /debug/vars."""
        with self._lock:
            return {
                "emitted": self.emitted,
                "reloaded": self.reloaded,
                "byType": dict(sorted(self.by_type.items())),
                "evicted": dict(self.evicted),
                "droppedDisabled": self.dropped_disabled,
                "ringSize": self.ring_size,
                "retained": {lane: len(dq)
                             for lane, dq in self._lanes.items()},
                "spoolPath": self.spool_path,
                "spoolBytes": self._spool_bytes,
                "spoolErrors": self.spool_errors,
            }

    def __len__(self) -> int:
        with self._lock:
            return sum(len(dq) for dq in self._lanes.values())

    # -- crash dumps --------------------------------------------------------

    def dump(self, path: str) -> int:
        """Write the whole ring to a JSON-lines file (SIGQUIT's dump) ->
        events written; never raises (a failing dump during a crash must
        not hide the crash)."""
        try:
            evs = self.events(0)
            with open(path, "w", encoding="utf-8") as f:
                for e in evs:
                    f.write(json.dumps(e, separators=(",", ":")) + "\n")
            return len(evs)
        except OSError:
            return 0


# -- cross-node order ---------------------------------------------------------


def hlc_sort_key(ev: dict):
    """The merged timeline's total order: the stamp first (the causal
    part), node id and seq as the tie-breaks of concurrent events."""
    hlc = ev.get("hlc") or [0, 0]
    try:
        p, l = int(hlc[0]), int(hlc[1])
    except (TypeError, ValueError, IndexError):
        p, l = 0, 0
    return (p, l, str(ev.get("node", "")), int(ev.get("seq", 0)))


def merge_events(docs: dict[str, list[dict]]) -> list[dict]:
    """Per-node event lists merged into one HLC-sorted timeline."""
    merged = [e for evs in docs.values() for e in evs]
    merged.sort(key=hlc_sort_key)
    return merged


# -- crash handler ------------------------------------------------------------

# every journal registered for the SIGQUIT dump (in-process clusters hold
# several; each dumps into its own data dir)
_CRASH_LOCK = threading.Lock()
_CRASH_JOURNALS: list[tuple[EventJournal, str]] = []
_CRASH_INSTALLED = False
# the SIGQUIT handler found at installation, called after the dump
_PREV_HANDLER = None


def register_crash_dump(journal: EventJournal, directory: str) -> None:
    """Register a journal for the dump and install the SIGQUIT handler
    (at the first call from the main thread: the signal module's rule).
    The handler writes `events.crash-<ts>.jsonl` into `directory` for
    every registered journal, then calls the Python handler it replaced,
    if there was one (the JAX package's, in a process that holds both);
    the process goes on running."""
    global _CRASH_INSTALLED, _PREV_HANDLER
    with _CRASH_LOCK:
        _CRASH_JOURNALS.append((journal, directory))
    if _CRASH_INSTALLED:
        return
    import signal
    if threading.current_thread() is not threading.main_thread():
        return  # a later registration from the main thread installs it
    try:
        prev = signal.signal(signal.SIGQUIT, _crash_signal_handler)
        _PREV_HANDLER = prev if callable(prev) else None
        _CRASH_INSTALLED = True
    except (ValueError, OSError, AttributeError):
        pass  # no SIGQUIT here


def unregister_crash_dump(journal: EventJournal) -> None:
    with _CRASH_LOCK:
        _CRASH_JOURNALS[:] = [(j, d) for j, d in _CRASH_JOURNALS
                              if j is not journal]


def spill_all_crash_dumps() -> list[str]:
    """Write every registered journal's ring into its data dir -> the
    files written."""
    out: list[str] = []
    ts = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    with _CRASH_LOCK:
        targets = list(_CRASH_JOURNALS)
    for journal, directory in targets:
        path = os.path.join(directory, f"events.crash-{ts}.jsonl")
        if journal.dump(path):
            out.append(path)
    return out


def _crash_signal_handler(signum, frame) -> None:
    spill_all_crash_dumps()
    if _PREV_HANDLER is not None:
        _PREV_HANDLER(signum, frame)


# -- the request's context ----------------------------------------------------


def _current_trace() -> Optional[str]:
    try:
        from pilosa_tpu_torch.utils import tracing
        return tracing.current_trace_id.get()
    except Exception:  # noqa: BLE001 — recording must never raise
        return None


def _current_principal() -> Optional[str]:
    try:
        from pilosa_tpu_torch.utils import accounting
        acct = accounting.current_account.get()
        return acct.principal if acct is not None else None
    except Exception:  # noqa: BLE001 — recording must never raise
        return None
