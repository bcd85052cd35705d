"""Multi-tenant QoS: quotas, priority classes, deadline and load shedding.

Port of pilosa_tpu/qos.py (no JAX there; the port keeps its own copy,
with the same headers, envelope fields, status codes, bodies, counters
and [qos] keys, so port, JAX and mixed clusters enforce one policy):

* Per-principal quotas (:119-156, :263-282): token buckets of queries/s,
  device-ms/s and bytes/s; the device and byte buckets withdraw the
  principal's measured spend from the UsageLedger since its last request,
  so a bucket can go into debt, and a principal in debt gets 429 with
  Retry-After until it is paid back.
* Priority classes (:65-111): interactive > batch > internal, carried on
  the X-Pilosa-Priority header and the coalesced envelope's per-entry
  `priority`, installed on a contextvar. The batchers' cut
  (parallel/batcher.py) and the fan-out and inbound envelope pools
  (PriorityPool, :165-241) order by it, FIFO inside a class.
* Admission (QosPlane.admit, :633-717): a red node health sheds
  (healthRed), an expired deadline sheds (deadline), an estimated wait
  past the remaining deadline sheds (estimatedWait), all with 503 and
  Retry-After; then the quotas throttle with 429. The API sheds a query
  whose class's observed cost exceeds its remaining deadline
  (estimatedCost) and counts expired entries at the execution boundary
  (deadline, or deadlineRemote for a coordinator's entry), before any
  launch.
* Modes (:74): off (the default: nothing changes), observe (every
  verdict counted as would-shed or would-throttle, nothing refused),
  enforce.

PILOSA_TPU_TORCH_QOS=0 (the JAX package's PILOSA_TPU_QOS=0) turns the
whole plane off, the priority plumbing and pools included; read per call.

Shed storms and quota debt go into the event journal (`journal`, the
server's utils/events.py EventJournal; :542-547, :612-630, :716):
qos.shed_storm.start when STORM_N rejections fall within STORM_WINDOW_S,
qos.shed_storm.end at the first admission a window after the last one,
and qos.quota_debt for a 429 whose Retry-After reaches QUOTA_DEBT_S, at
most once a principal every DEBT_EMIT_INTERVAL_S. The dashboard's QoS
panel waits with the dashboard (ROADMAP Queue A 7f).
"""

from __future__ import annotations

import collections
import contextvars
import itertools
import math
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

from pilosa_tpu_torch.utils import events as _events
from pilosa_tpu_torch.utils import threads

PRIORITY_HEADER = "X-Pilosa-Priority"

# name -> level; the lower level is the more urgent (sort order).
# `internal` is background work
PRIORITIES = {"interactive": 0, "batch": 1, "internal": 2}
# untagged work sorts as internal: never ahead of tagged user traffic
DEFAULT_LEVEL = PRIORITIES["internal"]

MODES = ("off", "observe", "enforce")

# every rejection counts under exactly one reason; /metrics emits them all
SHED_REASONS = ("deadline", "estimatedWait", "estimatedCost", "healthRed",
                "deadlineRemote", "draining")
THROTTLE_REASONS = ("queriesPerS", "deviceMsPerS", "bytesPerS")

# the longest Retry-After given: a throttled principal probes again
# within it, whatever its debt
RETRY_AFTER_MAX_S = 30.0


def enabled() -> bool:
    """PILOSA_TPU_TORCH_QOS=0 turns the plane off (read per call)."""
    return os.environ.get("PILOSA_TPU_TORCH_QOS", "1") != "0"


# the priority class of the request being served, or None (untagged)
current_priority: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("pilosa_torch_qos_priority", default=None)


def priority_level(name: Optional[str]) -> int:
    """The level of a priority name; unknown or None -> internal."""
    return PRIORITIES.get(name, DEFAULT_LEVEL) if name else DEFAULT_LEVEL


def current_level() -> int:
    """The current request's level: the batchers' and pools' sort key."""
    if not enabled():
        return DEFAULT_LEVEL
    return priority_level(current_priority.get())


# ---------------------------------------------------------------------------
# Token bucket
# ---------------------------------------------------------------------------


class TokenBucket:
    """A bucket that refills at `rate`/s up to `burst` and may go into
    debt: take() withdraws unconditionally, wait_for(n) is the seconds
    until `n` tokens are there again."""

    __slots__ = ("rate", "burst", "tokens", "_t")

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = max(float(burst), self.rate)
        self.tokens = self.burst
        self._t = time.monotonic()

    def _refill(self, now: float) -> None:
        dt = now - self._t
        if dt > 0:
            self.tokens = min(self.burst, self.tokens + dt * self.rate)
            self._t = now

    def take(self, n: float, now: Optional[float] = None) -> None:
        self._refill(time.monotonic() if now is None else now)
        self.tokens -= n

    def wait_for(self, n: float = 0.0,
                 now: Optional[float] = None) -> float:
        self._refill(time.monotonic() if now is None else now)
        deficit = n - self.tokens
        if deficit <= 0:
            return 0.0
        return deficit / self.rate if self.rate > 0 else RETRY_AFTER_MAX_S


# ---------------------------------------------------------------------------
# Priority-ordered thread pool
# ---------------------------------------------------------------------------

_SHUTDOWN_LEVEL = 1 << 30


class PriorityPool:
    """A ThreadPoolExecutor whose queue is ordered by the submitter's
    priority level (read at submit), FIFO inside a level: with one class
    it is the executor it replaces. It keeps `_max_workers`, `_threads`
    and `_work_queue`, which Executor.fanout_pool_stats reads."""

    def __init__(self, max_workers: int, thread_name_prefix: str = "qos"):
        self._max_workers = max(1, int(max_workers))
        self._prefix = thread_name_prefix
        self._work_queue: queue.PriorityQueue = queue.PriorityQueue()
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._shutdown = False

    def submit(self, fn, /, *args, **kwargs) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._shutdown:
                raise RuntimeError("cannot schedule new futures after "
                                   "shutdown")
            self._work_queue.put((current_level(), next(self._seq),
                                  fut, fn, args, kwargs))
            # one worker a submit up to the cap, as ThreadPoolExecutor;
            # a task's context rides its submit, not the worker
            if len(self._threads) < self._max_workers:
                self._threads.append(threads.spawn(
                    self._worker,
                    name=f"{self._prefix}_{len(self._threads)}"))
        return fut

    def _worker(self) -> None:
        while True:
            level, _seq, fut, fn, args, kwargs = self._work_queue.get()
            if level >= _SHUTDOWN_LEVEL:
                # re-posted so every sibling sees it
                self._work_queue.put((level, _seq, None, None, (), {}))
                return
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001 — to the waiter
                fut.set_exception(e)

    def shutdown(self, wait: bool = True,
                 cancel_futures: bool = False) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            if cancel_futures:
                while True:
                    try:
                        item = self._work_queue.get_nowait()
                    except queue.Empty:
                        break
                    if item[0] < _SHUTDOWN_LEVEL and item[2] is not None:
                        item[2].cancel()
            self._work_queue.put((_SHUTDOWN_LEVEL, next(self._seq),
                                  None, None, (), {}))
            workers = list(self._threads)
        if wait:
            for t in workers:
                t.join(timeout=5.0)


# ---------------------------------------------------------------------------
# Admission
# ---------------------------------------------------------------------------


class Rejection:
    """A refusal: 429 (a quota) or 503 (a shed), with Retry-After."""

    __slots__ = ("status", "retry_after", "reason", "message")

    def __init__(self, status: int, retry_after: float, reason: str,
                 message: str):
        self.status = status
        self.retry_after = max(0.0, min(retry_after, RETRY_AFTER_MAX_S))
        self.reason = reason
        self.message = message


class _PrincipalState:
    __slots__ = ("qps", "device", "bytes", "prev_device_ms", "prev_bytes",
                 "last_seen")

    def __init__(self, limits: dict, burst_s: float):
        self.qps = (TokenBucket(limits["queries_per_s"],
                                limits["queries_per_s"] * burst_s)
                    if limits["queries_per_s"] > 0 else None)
        self.device = (TokenBucket(limits["device_ms_per_s"],
                                   limits["device_ms_per_s"] * burst_s)
                       if limits["device_ms_per_s"] > 0 else None)
        self.bytes = (TokenBucket(limits["bytes_per_s"],
                                  limits["bytes_per_s"] * burst_s)
                      if limits["bytes_per_s"] > 0 else None)
        self.prev_device_ms = 0.0
        self.prev_bytes = 0.0
        self.last_seen = time.monotonic()


_LIMIT_KEYS = ("queries_per_s", "device_ms_per_s", "bytes_per_s")


class QosPlane:
    """A node's admission verdicts and counters, wired to the executor
    (load signals), the UsageLedger (quota feedback) and the node's
    health function. admit() runs on the HTTP dispatch path before the
    body is parsed. `logger` is a callable given one line, or None."""

    # load signals are read at most this often
    SIGNAL_REFRESH_S = 0.25
    # a health verdict is cached this long
    HEALTH_TTL_S = 1.0
    # EWMA smoothing of the queue wait and the per-class cost
    EWMA_ALPHA = 0.3
    # STORM_N rejections within STORM_WINDOW_S start a shed storm; a
    # window without one ends it
    STORM_WINDOW_S = 5.0
    STORM_N = 20
    # a 429 whose Retry-After reaches QUOTA_DEBT_S is deep quota debt
    # (noted at most once a principal every DEBT_EMIT_INTERVAL_S)
    QUOTA_DEBT_S = 5.0
    DEBT_EMIT_INTERVAL_S = 60.0

    def __init__(self, mode: str = "off",
                 default_priority: str = "interactive",
                 default_deadline: float = 0.0,
                 queries_per_s: float = 0.0,
                 device_ms_per_s: float = 0.0,
                 bytes_per_s: float = 0.0,
                 burst_s: float = 2.0,
                 max_principals: int = 256,
                 principals: Optional[dict] = None,
                 executor=None, ledger=None, health_fn=None, logger=None):
        if mode not in MODES:
            raise ValueError(
                f"invalid [qos] mode {mode!r} (expected off | observe | "
                "enforce)")
        if default_priority not in PRIORITIES:
            raise ValueError(
                f"invalid [qos] default-priority {default_priority!r} "
                f"(expected one of {', '.join(PRIORITIES)})")
        if burst_s <= 0:
            raise ValueError("[qos] burst must be > 0 (seconds of rate)")
        self.mode = mode
        self.default_priority = default_priority
        self.default_deadline = max(0.0, float(default_deadline))
        self.burst_s = float(burst_s)
        self.max_principals = max(2, int(max_principals))
        self.defaults = {"queries_per_s": float(queries_per_s),
                         "device_ms_per_s": float(device_ms_per_s),
                         "bytes_per_s": float(bytes_per_s)}
        # [qos.principals."<p>"] overrides; TOML keys come hyphenated
        self.overrides: dict[str, dict] = {}
        for pname, over in (principals or {}).items():
            norm = {str(k).replace("-", "_"): v
                    for k, v in dict(over).items()}
            bad = set(norm) - set(_LIMIT_KEYS) - {"priority"}
            if bad:
                raise ValueError(
                    f"invalid [qos.principals.{pname!r}] key(s): "
                    f"{', '.join(sorted(bad))}")
            pr = norm.get("priority")
            if pr is not None and pr not in PRIORITIES:
                raise ValueError(
                    f"invalid [qos.principals.{pname!r}] priority {pr!r}")
            self.overrides[str(pname)] = norm
        self.executor = executor
        self.ledger = ledger
        self.health_fn = health_fn
        self.logger = logger
        self.journal = None  # an EventJournal, set by the server
        self._storm_times: collections.deque = collections.deque()
        self.storm_active = False
        self._storm_started = 0.0
        self._storm_total = 0
        self.storms = 0
        self._debt_last_emit: dict[str, float] = {}
        self._lock = threading.Lock()
        self._principals: dict[str, _PrincipalState] = {}
        # the counters; /metrics emits every reason and priority
        self.admitted = dict.fromkeys(PRIORITIES, 0)
        self.shed = dict.fromkeys(SHED_REASONS, 0)
        self.throttled = dict.fromkeys(THROTTLE_REASONS, 0)
        self.would_shed = dict.fromkeys(SHED_REASONS, 0)
        self.would_throttled = dict.fromkeys(THROTTLE_REASONS, 0)
        self._per_principal: dict[str, dict] = {}  # bounded: see _pp
        self._sig_t = 0.0
        self._sig_prev: tuple = (0.0, 0)  # cumulative (wait ms, waited)
        self.wait_ewma_ms = 0.0
        self.queue_pressure = 0.0  # (batcher depth + fan-out queued)/slots
        self._class_cost_ms: dict[str, float] = {}
        self._health: tuple[float, str] = (0.0, "green")

    # -- priority -----------------------------------------------------------

    def priority_for(self, header_value: Optional[str],
                     principal: Optional[str]) -> str:
        """A valid header wins, then the principal's override, then the
        default class; an unknown header value falls through."""
        if header_value:
            hv = header_value.strip().lower()
            if hv in PRIORITIES:
                return hv
        if principal:
            over = self.overrides.get(principal)
            if over and over.get("priority"):
                return over["priority"]
        return self.default_priority

    # -- quota state --------------------------------------------------------

    def _limits_for(self, principal: str) -> dict:
        over = self.overrides.get(principal)
        if not over:
            return self.defaults
        return {k: float(over.get(k, self.defaults[k]))
                for k in _LIMIT_KEYS}

    def _state_locked(self, principal: str) -> _PrincipalState:
        st = self._principals.get(principal)
        if st is None:
            if len(self._principals) >= self.max_principals:
                # the longest idle goes; it restarts at full burst
                victim = min(self._principals,
                             key=lambda k: self._principals[k].last_seen)
                del self._principals[victim]
            st = self._principals[principal] = _PrincipalState(
                self._limits_for(principal), self.burst_s)
            if self.ledger is not None:
                cur = self.ledger.peek(principal)
                if cur is not None:
                    # no charge for what was spent before the state
                    st.prev_device_ms = cur["deviceMs"]
                    st.prev_bytes = cur["rpcBytes"] + cur["hbmBytes"]
        st.last_seen = time.monotonic()
        return st

    # -- load signals -------------------------------------------------------

    def _refresh_signals(self, now: float) -> None:
        """The queue-wait EWMA and the queue pressure from the executor's
        batchers (their cumulative waits and queue depth) and its fan-out
        pool (fanout_pool_stats), at most every SIGNAL_REFRESH_S."""
        if now - self._sig_t < self.SIGNAL_REFRESH_S:
            return
        self._sig_t = now
        ex = self.executor
        if ex is None:
            return
        wait_total, waited, depth = 0.0, 0, 0
        for attr in ("batcher", "sum_batcher", "minmax_batcher"):
            b = getattr(ex, attr, None)
            if b is None:
                continue
            wait_total += b.wait_ms_total
            waited += b.waited
            depth += b.queue_depth()
        pw, pn = self._sig_prev
        dn = waited - pn
        if dn > 0:
            avg = max(0.0, wait_total - pw) / dn
            self.wait_ewma_ms += self.EWMA_ALPHA * (avg - self.wait_ewma_ms)
        self._sig_prev = (wait_total, waited)
        try:
            ps = ex.fanout_pool_stats()
            queued = ps["queued"]
            slots = max(1, ps["size"])
        except Exception:  # noqa: BLE001 — a signal never fails admission
            queued, slots = 0, 1
        self.queue_pressure = (depth + queued) / slots

    def observe_service(self, qclass: str, elapsed_ms: float) -> None:
        """A completed query's ms into its class's cost EWMA."""
        cur = self._class_cost_ms.get(qclass)
        self._class_cost_ms[qclass] = (
            elapsed_ms if cur is None
            else cur + self.EWMA_ALPHA * (elapsed_ms - cur))

    def class_cost_ms(self, qclass: str) -> float:
        return self._class_cost_ms.get(qclass, 0.0)

    def estimated_wait_ms(self) -> float:
        """The queue-wait EWMA scaled by the queue pressure, plus the
        worst class cost for each pool's worth of backlog past one."""
        base = self.wait_ewma_ms * (1.0 + self.queue_pressure)
        if self.queue_pressure > 1.0 and self._class_cost_ms:
            base += (self.queue_pressure - 1.0) * max(
                self._class_cost_ms.values())
        return base

    def _health_score(self, now: float) -> str:
        t, score = self._health
        if now - t > self.HEALTH_TTL_S and self.health_fn is not None:
            try:
                score = self.health_fn()["score"]
            except Exception:  # noqa: BLE001 — a failed input sheds nothing
                score = "green"
            self._health = (now, score)
        return score

    # -- bookkeeping --------------------------------------------------------

    def _pp(self, principal: str) -> dict:
        e = self._per_principal.get(principal)
        if e is None:
            # at most max_principals entries, the spill bucket included
            if len(self._per_principal) >= self.max_principals - 1 \
                    and "~other" != principal:
                principal = "~other"
                e = self._per_principal.get(principal)
            if e is None:
                e = self._per_principal[principal] = {
                    "admitted": 0, "shed": 0, "throttled": 0}
        return e

    def record_expired(self, remote: bool) -> None:
        """A query found its deadline expired before any launch; a
        coordinator's entry (remote) counts as deadlineRemote."""
        with self._lock:
            self.shed["deadlineRemote" if remote else "deadline"] += 1

    def record_cost_shed(self) -> None:
        with self._lock:
            self.shed["estimatedCost"] += 1

    def record_drain_shed(self) -> None:
        """A new external query shed by this node's drain: counted in any
        mode (a lifecycle decision, not an overload policy)."""
        now = time.monotonic()
        with self._lock:
            self.shed["draining"] += 1
            storm_started = self._note_rejection(now, "draining")
        self._storm_debt_events(storm_started, False, "", "draining", 0.0)

    def _note_rejection(self, now: float, reason: str) -> bool:
        """One rejection toward a storm (under _lock); True when it
        started one."""
        dq = self._storm_times
        dq.append(now)
        while dq and now - dq[0] > self.STORM_WINDOW_S:
            dq.popleft()
        if self.storm_active:
            self._storm_total += 1
            return False
        if len(dq) >= self.STORM_N:
            self.storm_active = True
            self.storms += 1
            self._storm_started = now
            self._storm_total = len(dq)
            return True
        return False

    def _note_calm(self, now: float) -> Optional[dict]:
        """The storm's end (under _lock), once."""
        if self.storm_active and (
                not self._storm_times
                or now - self._storm_times[-1] > self.STORM_WINDOW_S):
            self.storm_active = False
            return {"rejections": self._storm_total,
                    "durationSeconds": round(
                        now - self._storm_started, 3)}
        return None

    def _reject(self, principal: str, priority: str, status: int,
                retry_after: float, reason: str,
                message: str) -> Optional[Rejection]:
        """Count one refusal; in observe mode count it as would-be and
        refuse nothing."""
        kind = "throttled" if status == 429 else "shed"
        now = time.monotonic()
        debt = False
        observed = False
        with self._lock:
            storm_started = self._note_rejection(now, reason)
            if status == 429 and retry_after >= self.QUOTA_DEBT_S:
                last = self._debt_last_emit.get(principal, 0.0)
                if now - last >= self.DEBT_EMIT_INTERVAL_S:
                    self._debt_last_emit[principal] = now
                    debt = True
            if self.mode == "observe":
                (self.would_throttled if status == 429
                 else self.would_shed)[reason] += 1
                observed = True
            else:
                (self.throttled if status == 429
                 else self.shed)[reason] += 1
                self._pp(principal)[kind] += 1
        self._storm_debt_events(storm_started, debt, principal, reason,
                                retry_after)
        if observed:
            if self.logger is not None:
                self.logger(
                    f"qos: observe: would "
                    f"{'throttle' if status == 429 else 'shed'} "
                    f"{principal} (priority={priority}): {message}")
            return None
        return Rejection(status, retry_after, reason, message)

    def _storm_debt_events(self, storm_started: bool, debt: bool,
                           principal: str, reason: str,
                           retry_after: float) -> None:
        if storm_started:
            _events.record(self.journal, "qos.shed_storm.start",
                           reason=reason, mode=self.mode,
                           windowSeconds=self.STORM_WINDOW_S,
                           threshold=self.STORM_N)
        if debt:
            _events.record(self.journal, "qos.quota_debt",
                           principal=principal, reason=reason,
                           retryAfterSeconds=round(retry_after, 3))

    # -- admission ----------------------------------------------------------

    def admit(self, principal: str, priority: str,
              remaining: Optional[float]) -> Optional[Rejection]:
        """None admits; else the Rejection the HTTP layer answers with.
        `remaining` is the deadline budget in seconds (None: no
        deadline, no wait-based shed)."""
        if self.mode == "off":
            return None
        now = time.monotonic()

        # 1. a red node sheds early
        if self._health_score(now) == "red":
            rej = self._reject(
                principal, priority, 503, self.HEALTH_TTL_S, "healthRed",
                "node health is red; shedding load")
            if rej is not None:
                return rej

        # 2. the deadline
        if remaining is not None:
            if remaining <= 0:
                rej = self._reject(principal, priority, 503, 0.0,
                                   "deadline", "deadline already expired")
                if rej is not None:
                    return rej
            else:
                self._refresh_signals(now)
                est = self.estimated_wait_ms()
                if est > remaining * 1e3:
                    rej = self._reject(
                        principal, priority, 503, est / 1e3,
                        "estimatedWait",
                        f"estimated queue wait {est:.0f} ms exceeds "
                        f"remaining deadline {remaining * 1e3:.0f} ms")
                    if rej is not None:
                        return rej

        # 3. the quotas; device and byte buckets pay the ledger's spend
        limits = self._limits_for(principal)
        if any(limits[k] > 0 for k in _LIMIT_KEYS):
            with self._lock:
                st = self._state_locked(principal)
                if self.ledger is not None and (st.device is not None
                                                or st.bytes is not None):
                    cur = self.ledger.peek(principal)
                    if cur is not None:
                        dms = cur["deviceMs"]
                        dby = cur["rpcBytes"] + cur["hbmBytes"]
                        if st.device is not None:
                            st.device.take(
                                max(0.0, dms - st.prev_device_ms), now)
                        if st.bytes is not None:
                            st.bytes.take(
                                max(0.0, dby - st.prev_bytes), now)
                        st.prev_device_ms = dms
                        st.prev_bytes = dby
                verdict = None
                for bucket, need, reason, what in (
                        (st.qps, 1.0, "queriesPerS", "query rate"),
                        (st.device, 0.0, "deviceMsPerS", "device-ms"),
                        (st.bytes, 0.0, "bytesPerS", "byte")):
                    if bucket is None:
                        continue
                    wait = bucket.wait_for(need, now)
                    if wait > 0:
                        verdict = (reason, wait, what)
                        break
                if verdict is None and st.qps is not None:
                    st.qps.take(1.0, now)
            if verdict is not None:
                reason, wait, what = verdict
                rej = self._reject(
                    principal, priority, 429, wait, reason,
                    f"{what} quota exhausted for {principal}")
                if rej is not None:
                    return rej

        with self._lock:
            self.admitted[priority] = self.admitted.get(priority, 0) + 1
            self._pp(principal)["admitted"] += 1
            calm = self._note_calm(now)
        if calm is not None:
            _events.record(self.journal, "qos.shed_storm.end", **calm)
        return None

    # -- surfaces -----------------------------------------------------------

    def snapshot(self) -> dict:
        """The /debug/vars `qos` block."""
        with self._lock:
            return {
                "mode": self.mode,
                "admitted": dict(self.admitted),
                "shed": dict(self.shed),
                "throttled": dict(self.throttled),
                "wouldShed": dict(self.would_shed),
                "wouldThrottled": dict(self.would_throttled),
                "perPrincipal": {k: dict(v) for k, v in
                                 sorted(self._per_principal.items(),
                                        key=lambda kv:
                                        -sum(kv[1].values()))[:20]},
                "estimatedWaitMs": round(self.estimated_wait_ms(), 3),
                "queuePressure": round(self.queue_pressure, 3),
                "trackedPrincipals": len(self._principals),
                "defaultPriority": self.default_priority,
                "defaultDeadline": self.default_deadline,
                "shedStormActive": self.storm_active,
                "shedStorms": self.storms,
            }

    def totals(self) -> dict:
        """Flat totals, for the telemetry sampler's rates."""
        with self._lock:
            return {
                "admitted": sum(self.admitted.values()),
                "shed": sum(self.shed.values()),
                "throttled": sum(self.throttled.values()),
                "wouldShed": (sum(self.would_shed.values())
                              + sum(self.would_throttled.values())),
            }

    def metrics_series(self) -> tuple[dict, dict]:
        """(counts, gauges) for /metrics: every priority and reason,
        zeros included."""
        with self._lock:
            counts = {}
            for p in PRIORITIES:
                counts[f"qos/admitted,priority:{p}"] = self.admitted.get(
                    p, 0)
            for r in SHED_REASONS:
                counts[f"qos/shed,reason:{r}"] = self.shed[r]
                counts[f"qos/wouldShed,reason:{r}"] = self.would_shed[r]
            for r in THROTTLE_REASONS:
                counts[f"qos/throttled,reason:{r}"] = self.throttled[r]
                counts[f"qos/wouldThrottled,reason:{r}"] = \
                    self.would_throttled[r]
            for i, (p, e) in enumerate(
                    sorted(self._per_principal.items(),
                           key=lambda kv: -sum(kv[1].values()))):
                if i >= 20:
                    break
                for k, v in e.items():
                    counts[f"qosPrincipal/{k},principal:{p}"] = v
            gauges = {
                "qos/estimatedWaitMs": round(self.estimated_wait_ms(), 3),
                "qos/queuePressure": round(self.queue_pressure, 3),
                "qos/mode": float(MODES.index(self.mode)),
            }
        return counts, gauges


def retry_after_header(seconds: float) -> str:
    """Retry-After in whole seconds, at least 1."""
    return str(max(1, int(math.ceil(seconds))))
