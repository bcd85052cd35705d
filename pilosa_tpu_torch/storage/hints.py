"""Durable hinted handoff: one write-hint log per target node.

Copy of pilosa_tpu/storage/hints.py. A write acknowledged while one of its
replicas is marked down is appended to that replica's log under
`<data dir>/.hints/<node id>.hints`; when the node returns, the logs are
replayed to it in order (Set, Clear, Store, ClearRow and the attribute
writes are idempotent, so a replayed prefix may be re-applied). The frames
and the directory are the JAX package's, so a log either package wrote
replays in the other:

    [magic 0xFB u8 | version u8 | ts f64 | len u32] [crc32 u32] [payload]

crc32 covers header and payload; the payload is UTF-8 JSON, either a
mutation {"index", "pql", "shards"?} or the drop marker {"dropped": n}.
A torn or corrupt tail stops the parse there (the records before it
replay); a log over max_bytes takes a drop marker instead of the write,
and hints older than max_age are dropped at replay. Any drop makes the
replay incomplete, and the caller falls back to anti-entropy.

An append reaches the kernel before it returns (fsync=True: the disk), as
the port's WAL appends do. With a journal (utils/events.py) an append
records hint.append, a drop marker or a failed append hint.drop (:212-229);
with a logger a failed append, a damaged log and a failed replay are
logged as the JAX store logs them. The failpoints storage.hints.append
(before the write; an injected fault counts as a dropped hint, :186) and
storage.hints.replay (before each record is applied; the log is kept for
the next return, :308) are the JAX package's.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Callable, Optional

from pilosa_tpu_torch.utils import events as _events
from pilosa_tpu_torch.utils import failpoints

HINT_MAGIC = 0xFB  # never the WAL's 0xFA, never a legacy op type (0/1)
HINT_VERSION = 1
_HEADER = struct.Struct("<BBdI")  # magic, version, ts, payload length
_CRC = struct.Struct("<I")
_FIXED = _HEADER.size + _CRC.size

# a hint record is one framed PQL write; a length near this is garbage
MAX_RECORD_BYTES = 1 << 20


def _frame(payload: bytes, ts: float) -> bytes:
    head = _HEADER.pack(HINT_MAGIC, HINT_VERSION, ts, len(payload))
    return head + _CRC.pack(zlib.crc32(head + payload)) + payload


def parse_hint_log(data: bytes) -> tuple[list[tuple[float, dict]], int, str]:
    """Framed records -> (records, valid_end, error). error is "" for a
    clean log; otherwise the parse stopped at valid_end with the reason,
    and the records before it are returned."""
    out: list[tuple[float, dict]] = []
    pos = 0
    n = len(data)
    while pos < n:
        if n - pos < _FIXED:
            return out, pos, "torn record header"
        magic, ver, ts, plen = _HEADER.unpack_from(data, pos)
        if magic != HINT_MAGIC:
            return out, pos, f"bad magic 0x{magic:02x}"
        if ver != HINT_VERSION:
            return out, pos, f"unknown hint record version {ver}"
        if plen > MAX_RECORD_BYTES:
            return out, pos, f"implausible record length {plen}"
        end = pos + _FIXED + plen
        if end > n:
            return out, pos, "torn record payload"
        (chk,) = _CRC.unpack_from(data, pos + _HEADER.size)
        payload = bytes(data[pos + _FIXED:end])
        if chk != zlib.crc32(bytes(data[pos:pos + _HEADER.size]) + payload):
            return out, pos, "checksum mismatch"
        try:
            doc = json.loads(payload)
        except ValueError:
            return out, pos, "undecodable payload"
        out.append((ts, doc))
        pos = end
    return out, pos, ""


def verify_hint_log(path: str) -> dict:
    """Counts of one log file and its damage, if any (a damaged tail is
    truncated at replay, so it is a warning, not a lost acknowledged
    write)."""
    with open(path, "rb") as f:
        data = f.read()
    records, valid_end, err = parse_hint_log(data)
    return {
        "records": len(records),
        "droppedMarkers": sum(1 for _, d in records if "dropped" in d),
        "bytes": len(data),
        "validBytes": valid_end,
        "error": err,
    }


class HintStore:
    """Every hint log of one node: append on the write path, replay when
    a target returns. One lock per target, so a replay to one returning
    node never blocks the hints of another."""

    def __init__(self, directory: str, max_bytes: int = 64 << 20,
                 max_age: float = 3600.0, fsync: bool = False, stats=None,
                 logger=None, journal=None):
        self.dir = directory
        self.logger = logger
        self.journal = journal
        self.max_bytes = int(max_bytes)
        self.max_age = float(max_age)
        self.fsync = fsync
        self.stats = stats
        self._locks: dict[str, threading.Lock] = {}
        self._meta_lock = threading.Lock()
        # cumulative counters (the writeHandoffs/* families)
        self.queued = 0
        self.replayed = 0
        self.dropped = 0
        self.replay_failures = 0

    def _lock_for(self, node_id: str) -> threading.Lock:
        with self._meta_lock:
            lk = self._locks.get(node_id)
            if lk is None:
                lk = self._locks[node_id] = threading.Lock()
            return lk

    def _path(self, node_id: str) -> str:
        # only file-name-safe characters: an id cannot leave the directory
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in node_id)
        return os.path.join(self.dir, f"{safe}.hints")

    def _count(self, name: str, n: int = 1) -> None:
        if self.stats is not None:
            self.stats.count(f"writeHandoffs/{name}", n)

    def append(self, node_id: str, index: str, pql: str,
               shards: Optional[list[int]] = None) -> bool:
        """Queue one write skipped on node_id. True when the hint was
        recorded; False when it was dropped: the log is over max_bytes (a
        drop marker is written instead, so a restart still knows) or the
        append failed. The write stays acknowledged by its live replicas
        either way, and the return-heal falls back to anti-entropy."""
        doc: dict = {"index": index, "pql": pql}
        if shards is not None:
            doc["shards"] = [int(s) for s in shards]
        payload = json.dumps(doc, separators=(",", ":")).encode()
        path = self._path(node_id)
        with self._lock_for(node_id):
            try:
                failpoints.hit("storage.hints.append")
                os.makedirs(self.dir, exist_ok=True)
                try:
                    size = os.path.getsize(path)
                except OSError:
                    size = 0
                now = time.time()  # wall clock: persisted in the frame
                if self.max_bytes > 0 and \
                        size + len(payload) + _FIXED > self.max_bytes:
                    # the marker may pass the cap: the broken promise must
                    # survive a restart
                    frame = _frame(json.dumps({"dropped": 1}).encode(), now)
                    dropped = True
                else:
                    frame = _frame(payload, now)
                    dropped = False
                with open(path, "ab") as f:
                    f.write(frame)
                    f.flush()
                    if self.fsync:
                        os.fsync(f.fileno())
            except OSError as e:
                with self._meta_lock:
                    self.dropped += 1
                self._count("dropped")
                _events.record(self.journal, "hint.drop", target=node_id,
                               index=index, reason="append-failed")
                if self.logger is not None:
                    self.logger.printf(
                        "hints: append for %s failed (%s) — write will "
                        "heal via anti-entropy", node_id, e)
                return False
        with self._meta_lock:
            if dropped:
                self.dropped += 1
            else:
                self.queued += 1
        self._count("dropped" if dropped else "queued")
        if dropped:
            _events.record(self.journal, "hint.drop", target=node_id,
                           index=index, reason="over-byte-cap")
        else:
            _events.record(self.journal, "hint.append", target=node_id,
                           index=index, bytes=len(payload))
        return not dropped

    def pending(self, node_id: str) -> int:
        """Bytes queued for one target (0: nothing to replay)."""
        try:
            return os.path.getsize(self._path(node_id))
        except OSError:
            return 0

    def pending_targets(self) -> dict[str, int]:
        """{file stem: bytes} of every non-empty log."""
        out: dict[str, int] = {}
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in names:
            if not name.endswith(".hints"):
                continue
            try:
                size = os.path.getsize(os.path.join(self.dir, name))
            except OSError:
                continue
            if size:
                out[name[:-len(".hints")]] = size
        return out

    def replay(self, node_id: str,
               apply_fn: Callable[[dict], None]) -> tuple[int, int, bool]:
        """node_id's hints in order through apply_fn (which raises on a
        failure) -> (replayed, dropped, complete). complete: every hint
        applied and none was ever dropped (marker, age, damage); only then
        may the caller skip anti-entropy. On a failure the log is kept
        whole for the next return-heal."""
        path = self._path(node_id)
        with self._lock_for(node_id):
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                return 0, 0, True  # no log: nothing was skipped
            if not data:
                return 0, 0, True
            records, valid_end, err = parse_hint_log(data)
        dropped = 1 if err else 0  # what followed the damage is unknown
        if err and self.logger is not None:
            self.logger.printf(
                "hints: log for %s damaged at byte %d (%s): replaying the "
                "valid prefix, anti-entropy will finish the heal", node_id,
                valid_end, err)
        now = time.time()  # against timestamps an earlier process wrote
        replayed = 0
        # applied outside the target's lock: each hint is an RPC, and
        # appends must not wait behind the whole replay; appends made
        # meanwhile land past the bytes read and are kept below
        try:
            for ts, doc in records:
                if "dropped" in doc:
                    dropped += int(doc.get("dropped") or 1)
                    continue
                if self.max_age > 0 and now - ts > self.max_age:
                    dropped += 1
                    continue
                failpoints.hit("storage.hints.replay")
                apply_fn(doc)
                replayed += 1
        except Exception as e:  # noqa: BLE001 — any failure keeps the log
            with self._meta_lock:
                self.replayed += replayed
                self.replay_failures += 1
            if replayed:
                self._count("replayed", replayed)
            if self.logger is not None:
                self.logger.printf(
                    "hints: replay to %s failed after %d records (%s: %s) "
                    "— will retry on its next return", node_id, replayed,
                    type(e).__name__, e)
            return replayed, 0, False
        # a full pass: retire exactly the bytes replayed
        with self._lock_for(node_id):
            try:
                with open(path, "rb") as f:
                    after = f.read()
                if len(after) <= len(data):
                    os.remove(path)
                else:
                    tmp = path + ".tmp"
                    with open(tmp, "wb") as f:
                        f.write(after[len(data):])
                    os.replace(tmp, path)
            except OSError:
                pass
        with self._meta_lock:
            self.replayed += replayed
            self.dropped += dropped
        if replayed:
            self._count("replayed", replayed)
        if dropped:
            self._count("dropped", dropped)
        return replayed, dropped, dropped == 0

    def drop_target(self, node_id: str) -> None:
        """A target that will never return: count its hints as dropped
        and delete its log."""
        path = self._path(node_id)
        with self._lock_for(node_id):
            try:
                with open(path, "rb") as f:
                    records, _, _ = parse_hint_log(f.read())
                os.remove(path)
            except OSError:
                return
        n = sum(1 for _, d in records if "dropped" not in d)
        if n:
            with self._meta_lock:
                self.dropped += n
            self._count("dropped", n)

    def snapshot(self) -> dict:
        pend = self.pending_targets()
        with self._meta_lock:
            return {
                "queued": self.queued,
                "replayed": self.replayed,
                "dropped": self.dropped,
                "replayFailures": self.replay_failures,
                "pendingBytes": sum(pend.values()),
                "pendingTargets": pend,
                "maxBytes": self.max_bytes,
                "maxAge": self.max_age,
            }
