"""Per-principal usage accounting and SLO burn rates.

Port of pilosa_tpu/utils/accounting.py (no JAX there; the port keeps its
own copy, as it does of every module it needs):

* ``Account`` on a contextvar (:58-79): the HTTP layer installs one per
  request, and every charge site (the batchers' leaders, the residency,
  the plan cache, the internal client, the coalescer) charges the
  request's principal through it. Pool submits run in copied contexts,
  so every thread serving the request sees the same account.
* ``principal_from_headers`` (:97-126): X-Pilosa-Principal (inherited by
  a fan-out RPC from its coordinator), then X-API-Key, then
  Authorization digested with blake2b (never stored raw), then the
  remote address.
* ``UsageLedger`` (:134-282): bounded per-principal aggregates with
  lowest-spender spill into ``~other`` (totals stay exact) and a
  since-cursor delta ring served at GET /debug/usage.
* ``classify_query``, ``Objective`` and ``SLOTracker`` (:288-430): [slo]
  objectives per query class in 15 s buckets, with the two-window
  (short, long) burn-rate math; an objective turns yellow or red only
  when both windows burn past the threshold.

The kill switch is PILOSA_TPU_TORCH_ACCOUNTING=0 (the JAX package's
PILOSA_TPU_ACCOUNTING=0), read per request where the account is
installed; every charge site is a no-op without an account.

The fleet's merged ledger is served by server.py (GET /cluster/usage)
and the dashboard's usage and SLO panels by net/dashboard.py.
"""

from __future__ import annotations

import collections
import contextvars
import hashlib
import os
import threading
import time
from typing import Optional

from pilosa_tpu_torch.utils.telemetry import Ring

PRINCIPAL_HEADER = "X-Pilosa-Principal"

# where the charges of principals beyond the ledger's bound go
SPILL = "~other"

# every per-principal aggregate; snapshot, totals and /metrics iterate it
FIELDS = ("deviceMs", "hbmBytes", "rpcBytes", "queueMs", "queries",
          "errors", "planCacheHits")


def enabled() -> bool:
    """PILOSA_TPU_TORCH_ACCOUNTING=0 installs no account (read per
    request)."""
    return os.environ.get("PILOSA_TPU_TORCH_ACCOUNTING", "1") != "0"


class Account:
    """(ledger, principal) of the request being served."""

    __slots__ = ("ledger", "principal")

    def __init__(self, ledger: "UsageLedger", principal: str):
        self.ledger = ledger
        self.principal = principal

    def charge(self, **fields) -> None:
        self.ledger.charge(self.principal, **fields)


# the account of the request being served, or None (accounting off)
current_account: contextvars.ContextVar[Optional[Account]] = \
    contextvars.ContextVar("pilosa_torch_account", default=None)


def _sanitize(raw: str, limit: int = 64) -> str:
    """A principal label with separators and control bytes replaced and
    its length capped: it rides stats tags and JSON."""
    out = "".join("_" if (c in ",\n\r\t\"\\" or ord(c) < 0x20) else c
                  for c in raw.strip())
    return out[:limit] if out else "anonymous"


def principal_from_headers(headers, client_addr: Optional[str] = None) -> str:
    """The caller's principal: X-Pilosa-Principal as it is, X-API-Key as
    `key:<key>`, Authorization as `auth:<16 hex of blake2b>`, else
    `addr:<remote address>`, else "anonymous"."""
    h = headers if headers is not None and hasattr(headers, "get") else {}
    inherited = h.get(PRINCIPAL_HEADER)
    if inherited:
        return _sanitize(inherited)
    key = h.get("X-API-Key")
    if key:
        return "key:" + _sanitize(key)
    auth = h.get("Authorization")
    if auth:
        return "auth:" + hashlib.blake2b(auth.encode(),
                                         digest_size=8).hexdigest()
    if client_addr:
        return "addr:" + _sanitize(str(client_addr))
    return "anonymous"


# ---------------------------------------------------------------------------
# Usage ledger
# ---------------------------------------------------------------------------


class UsageLedger:
    """At most `max_principals` tracked entries: a new principal at the
    bound merges the lowest-deviceMs entry into SPILL. sample_tick()
    (the telemetry sampler's) appends each principal's deltas since the
    last tick to a bounded ring, read with since(cursor)."""

    def __init__(self, max_principals: int = 256, ring_size: int = 360):
        self.enabled = True  # run-time toggle; the env switch is read
        # where the account is installed
        self.max_principals = max(2, int(max_principals))
        self._lock = threading.Lock()
        self._p: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self.spilled_principals = 0
        self.ring = Ring(ring_size)
        self._prev: dict[str, dict] = {}  # the last tick's totals

    def charge(self, principal: str, device_ms: float = 0.0,
               hbm_bytes: int = 0, rpc_bytes: int = 0,
               queue_ms: float = 0.0, queries: int = 0, errors: int = 0,
               plan_cache_hits: int = 0) -> None:
        with self._lock:
            e = self._p.get(principal)
            if e is None:
                if len(self._p) >= self.max_principals:
                    principal = self._spill_locked(principal)
                    e = self._p.get(principal)
                if e is None:
                    e = self._p[principal] = dict.fromkeys(FIELDS, 0.0)
            e["deviceMs"] += device_ms
            e["hbmBytes"] += hbm_bytes
            e["rpcBytes"] += rpc_bytes
            e["queueMs"] += queue_ms
            e["queries"] += queries
            e["errors"] += errors
            e["planCacheHits"] += plan_cache_hits
            e["lastChargeWall"] = time.time()

    def _spill_locked(self, newcomer: str) -> str:
        """Merge the lowest-deviceMs principals into SPILL until the
        newcomer fits; SPILL itself when it is all that is left."""
        spill = self._p.get(SPILL)
        if spill is None:
            spill = self._p[SPILL] = dict.fromkeys(FIELDS, 0.0)
        while len(self._p) >= self.max_principals:
            victim_key = None
            victim_ms = None
            for k, e in self._p.items():
                if k == SPILL:
                    continue
                if victim_ms is None or e["deviceMs"] < victim_ms:
                    victim_key, victim_ms = k, e["deviceMs"]
            if victim_key is None:
                return SPILL
            victim = self._p.pop(victim_key)
            for f in FIELDS:
                spill[f] += victim[f]
            self.spilled_principals += 1
        return newcomer

    def peek(self, principal: str) -> Optional[dict]:
        """A copy of one principal's aggregates, or None: the QoS plane's
        quota buckets withdraw their deltas."""
        with self._lock:
            e = self._p.get(principal)
            return {f: e[f] for f in FIELDS} if e is not None else None

    def totals(self) -> dict:
        """Exact sums over every principal, SPILL included."""
        with self._lock:
            out = dict.fromkeys(FIELDS, 0.0)
            for e in self._p.values():
                for f in FIELDS:
                    out[f] += e[f]
            return out

    def snapshot(self, top: int = 0) -> dict:
        """The principals by deviceMs, descending (`top` of them; 0: all),
        the exact totals and the bound's state."""
        with self._lock:
            items = sorted(self._p.items(),
                           key=lambda kv: (-kv[1]["deviceMs"],
                                           -kv[1]["queries"], kv[0]))
            totals = dict.fromkeys(FIELDS, 0.0)
            for _, e in items:
                for f in FIELDS:
                    totals[f] += e[f]
            if top and top > 0:
                items = items[:top]
            return {
                "principals": {k: dict(e) for k, e in items},
                "totals": totals,
                "trackedPrincipals": len(self._p),
                "spilledPrincipals": self.spilled_principals,
                "maxPrincipals": self.max_principals,
            }

    def sample_tick(self, ts: Optional[float] = None) -> Optional[int]:
        """One ring entry of {principal: {field: delta}} for the
        principals charged since the last tick (an empty one when none
        was, so the cursor still moves)."""
        with self._lock:
            cur = {k: {f: e[f] for f in FIELDS} for k, e in self._p.items()}
        deltas: dict[str, dict] = {}
        for p, e in cur.items():
            prev = self._prev.get(p, {})
            d = {f: round(e[f] - prev.get(f, 0.0), 3) for f in FIELDS
                 if e[f] - prev.get(f, 0.0) > 0}
            if d:
                deltas[p] = d
        self._prev = cur
        return self.ring.append(deltas, ts=ts)

    def since(self, cursor: int = 0, limit: int = 0) -> dict:
        return self.ring.since(cursor, limit)

    def clear(self) -> None:
        with self._lock:
            self._p.clear()
            self._prev = {}
            self.spilled_principals = 0


# ---------------------------------------------------------------------------
# SLO objectives and burn rates
# ---------------------------------------------------------------------------

# a query's class is its first call's (Options unwrapped)
_CLASS_BY_CALL = {
    "Row": "read", "Union": "read", "Intersect": "read",
    "Difference": "read", "Xor": "read", "Not": "read", "Range": "read",
    "Count": "count", "TopN": "topn", "GroupBy": "groupby",
}

QUERY_CLASSES = ("read", "count", "topn", "groupby")


def classify_query(query) -> str:
    """The SLO class of a parsed query: its first call decides."""
    calls = getattr(query, "calls", None)
    if not calls:
        return "other"
    call = calls[0]
    name = getattr(call, "name", "")
    if name == "Options" and getattr(call, "children", None):
        name = getattr(call.children[0], "name", "")
    return _CLASS_BY_CALL.get(name, "other")


class Objective:
    """One SLO: `qclass` None covers every query; `latency_ms` None is
    availability (bad = an error), else bad = an error or slower than
    latency_ms. `target` is the good fraction; the budget 1 - target."""

    __slots__ = ("name", "qclass", "latency_ms", "target")

    def __init__(self, name: str, qclass: Optional[str],
                 latency_ms: Optional[float], target: float):
        if not 0.0 < target < 1.0:
            raise ValueError(f"slo target must be in (0, 1), got {target}")
        self.name = name
        self.qclass = qclass
        self.latency_ms = latency_ms
        self.target = target


_STATUS_LEVEL = {"green": 0, "yellow": 1, "red": 2}


class SLOTracker:
    """Event counts in BUCKET_S buckets per objective (the long window's
    worth kept); burn over a window = (bad / total) / (1 - target)."""

    BUCKET_S = 15.0

    def __init__(self, objectives: list, short_window: float = 300.0,
                 long_window: float = 3600.0, burn_yellow: float = 6.0,
                 burn_red: float = 14.4):
        if short_window <= 0 or long_window < short_window:
            raise ValueError("slo windows must satisfy 0 < short <= long")
        self.objectives = list(objectives)
        self.short_window = short_window
        self.long_window = long_window
        self.burn_yellow = burn_yellow
        self.burn_red = burn_red
        self._lock = threading.Lock()
        # per objective: [bucket start (monotonic), total, bad]
        self._buckets: list[collections.deque] = [
            collections.deque() for _ in self.objectives]

    def observe(self, qclass: str, elapsed_s: float, ok: bool,
                now: Optional[float] = None) -> None:
        if not self.objectives:
            return
        if now is None:
            now = time.monotonic()
        with self._lock:
            for ob, dq in zip(self.objectives, self._buckets):
                if ob.qclass is not None and ob.qclass != qclass:
                    continue
                bad = (not ok) or (ob.latency_ms is not None
                                   and elapsed_s * 1e3 > ob.latency_ms)
                if dq and now - dq[-1][0] < self.BUCKET_S:
                    b = dq[-1]
                else:
                    dq.append([now, 0, 0])
                    b = dq[-1]
                    self._trim(dq, now)
                b[1] += 1
                if bad:
                    b[2] += 1

    def _trim(self, dq: collections.deque, now: float) -> None:
        horizon = now - self.long_window - self.BUCKET_S
        while dq and dq[0][0] < horizon:
            dq.popleft()

    def _window(self, dq, now: float, span: float) -> tuple[int, int]:
        total = bad = 0
        cutoff = now - span
        for ts, t, b in dq:
            if ts + self.BUCKET_S >= cutoff:
                total += t
                bad += b
        return total, bad

    def evaluate(self, now: Optional[float] = None) -> dict:
        """{objective: {class, latencyMs, target, burnShort, burnLong,
        status, window totals}}; an objective with no traffic is green."""
        if now is None:
            now = time.monotonic()
        out: dict[str, dict] = {}
        with self._lock:
            for ob, dq in zip(self.objectives, self._buckets):
                budget = 1.0 - ob.target
                ts, bs = self._window(dq, now, self.short_window)
                tl, bl = self._window(dq, now, self.long_window)
                burn_s = (bs / ts / budget) if ts else 0.0
                burn_l = (bl / tl / budget) if tl else 0.0
                if burn_s >= self.burn_red and burn_l >= self.burn_red:
                    status = "red"
                elif burn_s >= self.burn_yellow \
                        and burn_l >= self.burn_yellow:
                    status = "yellow"
                else:
                    status = "green"
                out[ob.name] = {
                    "class": ob.qclass or "all",
                    "latencyMs": ob.latency_ms,
                    "target": ob.target,
                    "burnShort": round(burn_s, 3),
                    "burnLong": round(burn_l, 3),
                    "status": status,
                    "windowShortTotal": ts, "windowShortBad": bs,
                    "windowLongTotal": tl, "windowLongBad": bl,
                }
        return out

    def worst(self, now: Optional[float] = None) -> tuple[str, str]:
        """(status, reason) of the worst objective: the health score's SLO
        input."""
        worst_status, reason = "green", ""
        for name, ob in self.evaluate(now).items():
            if _STATUS_LEVEL[ob["status"]] > _STATUS_LEVEL[worst_status]:
                worst_status = ob["status"]
                reason = (f"SLO {name} burning error budget at "
                          f"{ob['burnShort']:g}x (5m) / "
                          f"{ob['burnLong']:g}x (1h)")
        return worst_status, reason
