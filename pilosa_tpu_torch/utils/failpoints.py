"""Deterministic fault injection: named failpoints at I/O and RPC choke
points.

Copy of pilosa_tpu/utils/failpoints.py, with the same eleven points, the
same allowed kinds per point and the same seeded chaos draws: a draw
derives from zlib.crc32(f"{seed}:{name}:{idx}"), so a seed printed by a
failing test replays the same per-point schedule in either package. A
failpoint is a named hook at a choke point (the WAL append, the snapshot
write, the RPC body read, ...). Inactive, a hook costs one module-global
read. Active, it performs one of:

  raise           raise an injected error (``FailpointError``, an OSError
                  subclass, so the site's I/O error handling takes over;
                  RPC sites pass their own exception type)
  delay           sleep for ``arg`` seconds (timeout and hedge paths)
  truncate-write  write only a prefix of the buffer, then raise: a torn
                  write, as from a crash mid-append (write sites only)
  partial-read    return only a prefix of the bytes read: a mangled
                  response body (read sites only)
  exit            ``os._exit(17)``: a hard crash with no cleanup (never
                  drawn by chaos mode unless explicitly allowed)

Two ways to arm: per test (``with failpoint("storage.wal.append",
"truncate-write", arg=0.5): ...``, or ``configure`` / ``deactivate``), or a
seeded chaos schedule (``arm_chaos(seed, rate)``), also armed from the
environment: ``PILOSA_TPU_CHAOS_SEED=<int>`` with optional
``PILOSA_TPU_CHAOS_RATE``, ``PILOSA_TPU_CHAOS_POINTS=a,b,...`` and
``PILOSA_TPU_CHAOS_EXIT=1``, so subprocess nodes join the schedule. Every
fired action goes to a bounded in-order log (``schedule_log()``), and the
counters per point (evaluations, fired) are served on ``/debug/vars``
under ``failpoints`` and as ``failpoints/<name>`` counters on
``/metrics``. ``hit()`` on an unregistered name raises, so a misspelt
site fails loudly.
"""

from __future__ import annotations

import os
import random
import threading
import time
import zlib
from collections import deque
from contextlib import contextmanager
from typing import Optional


class FailpointError(OSError):
    """An injected fault. Subclasses OSError so storage/transport error
    handling treats it exactly like a real I/O failure."""


RAISE = "raise"
DELAY = "delay"
TRUNCATE_WRITE = "truncate-write"
PARTIAL_READ = "partial-read"
EXIT = "exit"

# name -> (allowed kinds, site) — the failpoint registry
POINTS: dict[str, tuple[tuple[str, ...], str]] = {
    "storage.wal.append": (
        (RAISE, TRUNCATE_WRITE, DELAY, EXIT),
        "storage/roaring.py Bitmap._write_op / append_ops"),
    "storage.snapshot.write": (
        (RAISE, TRUNCATE_WRITE, DELAY, EXIT),
        "storage/fragment.py Fragment.snapshot (tmp-file write)"),
    "storage.snapshot.replace": (
        (RAISE, EXIT),
        "storage/fragment.py Fragment.snapshot (pre-rename)"),
    "storage.fragment.open": (
        (RAISE, DELAY),
        "storage/fragment.py Fragment.open (post-mmap parse)"),
    "net.client.send": (
        (RAISE, DELAY),
        "net/client.py InternalClient._request (pre-send)"),
    "net.client.read": (
        (RAISE, PARTIAL_READ, DELAY),
        "net/client.py InternalClient._request (response body)"),
    "http.server.dispatch": (
        (RAISE, DELAY),
        "net/http_server.py Handler.dispatch (pre-handler)"),
    "executor.fanout": (
        (RAISE, DELAY),
        "executor.py Executor._timed_node_query (pre-RPC)"),
    "server.scrub.fragment": (
        (RAISE, DELAY),
        "server.py Server._sync_fragment (per-fragment scrub)"),
    "storage.hints.append": (
        (RAISE, DELAY),
        "storage/hints.py HintStore.append (pre-write)"),
    "storage.hints.replay": (
        (RAISE, DELAY),
        "storage/hints.py HintStore.replay (per-record apply)"),
}

_mu = threading.RLock()
_armed = False  # hot-path gate: True iff any explicit action or chaos mode
_active: dict[str, "_Action"] = {}
_counters: dict[str, list] = {}  # name -> [evaluations, fired]
_chaos: Optional["_Chaos"] = None
# fired-action log, bounded so an env-armed soak run can't leak memory —
# `firedTotal` in snapshot() reveals when the head has been dropped
_LOG_MAX = 10000
_log: deque = deque(maxlen=_LOG_MAX)
_seq = 0


class _Action:
    __slots__ = ("kind", "arg", "times", "prob", "rng")

    def __init__(self, kind: str, arg: float = 0.5,
                 times: Optional[int] = None, prob: float = 1.0,
                 seed: int = 0):
        self.kind = kind
        self.arg = arg
        self.times = times
        self.prob = prob
        # deterministic per-action randomness for prob < 1 draws
        self.rng = random.Random(seed) if prob < 1.0 else None

    def cut(self, n: int) -> int:
        """Prefix length for truncate-write / partial-read over n bytes:
        arg is a fraction in [0, 1); always strictly shorter than n."""
        if n <= 0:
            return 0
        return min(int(n * self.arg), n - 1)


class _Chaos:
    """Seeded randomized schedule over the registry. Each evaluation's
    draw derives from (seed, point name, that point's evaluation index) —
    NOT from one shared RNG stream — so a point's firing sequence is
    deterministic in its own evaluation order even when many threads
    interleave evaluations of different points (the 3-node storm). Thread
    scheduling still decides which operation is a point's Nth evaluation;
    the fired log pins that residual down for replay."""

    def __init__(self, seed: int, rate: float, points=None,
                 allow_exit: bool = False):
        self.seed = seed
        self.rate = rate
        self.points = frozenset(points) if points else None
        self.allow_exit = allow_exit

    def draw(self, name: str, eval_idx: int) -> Optional[_Action]:
        if self.points is not None and name not in self.points:
            return None
        # crc32, not hash(): str hashing is salted per process, and the
        # whole point is cross-process (subprocess nodes) reproducibility
        rng = random.Random(
            zlib.crc32(f"{self.seed}:{name}:{eval_idx}".encode()))
        if rng.random() >= self.rate:
            return None
        kinds = [k for k in POINTS[name][0]
                 if k != EXIT or self.allow_exit]
        kind = kinds[rng.randrange(len(kinds))]
        arg = (rng.uniform(0.005, 0.05) if kind == DELAY
               else rng.random())
        return _Action(kind, arg=arg)


def _rearm_locked() -> None:
    global _armed
    _armed = bool(_active) or _chaos is not None


def configure(name: str, kind: str, arg: float = 0.5,
              times: Optional[int] = None, prob: float = 1.0,
              seed: int = 0) -> None:
    """Activate one failpoint. `times` bounds total firings (then it
    deactivates itself); `prob` fires probabilistically (seeded)."""
    kinds, _site = POINTS[name]  # KeyError on typo'd names, by design
    if kind not in kinds:
        raise ValueError(
            f"failpoint {name} does not support {kind!r} (allowed: {kinds})")
    with _mu:
        _active[name] = _Action(kind, arg=arg, times=times, prob=prob,
                                seed=seed)
        _rearm_locked()


def deactivate(name: str) -> None:
    with _mu:
        _active.pop(name, None)
        _rearm_locked()


@contextmanager
def failpoint(name: str, kind: str, **kw):
    configure(name, kind, **kw)
    try:
        yield
    finally:
        deactivate(name)


def arm_chaos(seed: int, rate: float = 0.02, points=None,
              allow_exit: bool = False) -> None:
    global _chaos
    with _mu:
        _chaos = _Chaos(seed, rate, points=points, allow_exit=allow_exit)
        _rearm_locked()


def disarm_chaos() -> None:
    global _chaos
    with _mu:
        _chaos = None
        _rearm_locked()


def reset() -> None:
    """Deactivate everything and clear counters + the fired-action log
    (test isolation; the autouse fixture in tests/conftest.py calls it)."""
    global _chaos, _seq
    with _mu:
        _active.clear()
        _chaos = None
        _counters.clear()
        _log.clear()
        _seq = 0
        _rearm_locked()


def _maybe_arm_from_env() -> None:
    """Join a chaos schedule announced via the environment — how
    subprocess nodes (cli/main.py server processes) inherit the seed."""
    seed = os.environ.get("PILOSA_TPU_CHAOS_SEED", "")
    if not seed:
        return
    pts = [p for p in
           os.environ.get("PILOSA_TPU_CHAOS_POINTS", "").split(",") if p]
    arm_chaos(int(seed),
              rate=float(os.environ.get("PILOSA_TPU_CHAOS_RATE", "0.02")),
              points=pts or None,
              allow_exit=os.environ.get("PILOSA_TPU_CHAOS_EXIT", "") == "1")


_maybe_arm_from_env()


# -- evaluation (the choke-point API) ---------------------------------------


def hit(name: str, exc=FailpointError) -> Optional[_Action]:
    """Evaluate a failpoint. No-op (one global read) when nothing is armed.
    May raise `exc`, sleep, or `os._exit`; returns the action for the
    data-modulating kinds (truncate-write / partial-read) so write/read
    sites can apply them, None otherwise."""
    if not _armed:
        return None
    return _hit_slow(name, exc)


def _hit_slow(name: str, exc) -> Optional[_Action]:
    global _seq
    with _mu:
        if name not in POINTS:
            # a typo'd site must fail loudly whenever ANYTHING is armed —
            # not only under chaos — or the fault path it was meant to
            # exercise is silently never tested
            raise KeyError(f"unregistered failpoint: {name}")
        c = _counters.setdefault(name, [0, 0])
        c[0] += 1
        act = _active.get(name)
        if act is not None:
            if act.times is not None and act.times <= 0:
                act = None
            elif act.rng is not None and act.rng.random() >= act.prob:
                act = None
        if act is None and _chaos is not None:
            act = _chaos.draw(name, c[0])
        elif act is not None and act.times is not None:
            act.times -= 1
        if act is None:
            return None
        c[1] += 1
        _seq += 1
        _log.append({"seq": _seq, "point": name, "kind": act.kind,
                     "arg": round(act.arg, 6)})
    # act outside the lock: sleeping/raising under it would serialize
    # every other failpoint evaluation behind an injected delay
    if act.kind == DELAY:
        time.sleep(act.arg)
        return None
    if act.kind == RAISE:
        raise exc(f"failpoint {name}: injected fault")
    if act.kind == EXIT:
        os._exit(17)
    return act  # truncate-write / partial-read: caller applies


def corrupt_write(name: str, data: bytes):
    """Write-site helper: returns (data to write, exception to raise AFTER
    writing or None). A truncate-write action tears the buffer — the site
    writes the prefix (the bytes that 'made it to disk') and then raises,
    modelling a crash mid-write."""
    act = hit(name)
    if act is None or act.kind != TRUNCATE_WRITE:
        return data, None
    k = act.cut(len(data))
    return data[:k], FailpointError(
        f"failpoint {name}: torn write ({k}/{len(data)} bytes)")


def corrupt_read(name: str, data: bytes) -> bytes:
    """Read-site helper: a partial-read action returns only a prefix of
    the bytes (a mangled/truncated response body)."""
    act = hit(name)
    if act is None or act.kind != PARTIAL_READ:
        return data
    return data[: act.cut(len(data))]


class FailpointWriter:
    """File-object wrapper for streamed write sites (the snapshot path
    writes in chunks): applies `corrupt_write` to every chunk. Transparent
    when the point is inactive."""

    def __init__(self, name: str, w):
        self._name = name
        self._w = w

    def write(self, data) -> int:
        data, exc = corrupt_write(self._name, data)
        n = self._w.write(data)
        if exc is not None:
            raise exc
        return n if n is not None else len(data)

    def __getattr__(self, attr):
        return getattr(self._w, attr)


def wrap_writer(name: str, w):
    """FailpointWriter when anything is armed, the bare writer otherwise —
    keeps the streamed write path allocation-free in production."""
    return FailpointWriter(name, w) if _armed else w


# -- observability ----------------------------------------------------------


def counters() -> dict[str, dict]:
    with _mu:
        return {name: {"evaluations": c[0], "fired": c[1]}
                for name, c in _counters.items()}


def schedule_log() -> list[dict]:
    with _mu:
        return list(_log)


def snapshot() -> dict:
    """JSON-able state for /debug/vars."""
    with _mu:
        out: dict = {
            "armed": _armed,
            "active": {n: {"kind": a.kind, "arg": a.arg, "times": a.times,
                           "prob": a.prob}
                       for n, a in _active.items()},
            "points": {name: {"evaluations": c[0], "fired": c[1]}
                       for name, c in _counters.items()},
            "firedTotal": _seq,
        }
        if _chaos is not None:
            out["chaos"] = {"seed": _chaos.seed, "rate": _chaos.rate,
                            "points": (sorted(_chaos.points)
                                       if _chaos.points else "all"),
                            "allowExit": _chaos.allow_exit}
        out["logTail"] = list(_log)[-50:]
        return out


def describe() -> str:
    """Human-readable replay header for chaos-test failure output."""
    with _mu:
        lines = []
        if _chaos is not None:
            lines.append(f"chaos seed={_chaos.seed} rate={_chaos.rate} "
                         f"points={sorted(_chaos.points) if _chaos.points else 'all'} "
                         f"allow_exit={_chaos.allow_exit}")
        if _seq > len(_log):
            lines.append(f"({_seq - len(_log)} earliest fired actions "
                         f"dropped; log is bounded at {_LOG_MAX})")
        for e in _log:
            lines.append(f"  #{e['seq']:04d} {e['point']} "
                         f"{e['kind']}(arg={e['arg']})")
        return "\n".join(lines) or "(no failpoints fired)"
