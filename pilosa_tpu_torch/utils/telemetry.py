"""Telemetry: time-series rings, kernel statistics timed by CUDA events,
device memory, and on-demand device-profile capture.

Trimmed port of pilosa_tpu/utils/telemetry.py:

* ``Ring`` (:52) and ``TelemetrySampler`` (:96): a background sampler
  snapshots the server's gauges into a bounded ring, served at
  GET /debug/timeseries with a `since` cursor.
* ``KernelStats`` (:377): per-(family, rep, arity) dispatch counts and
  host-latency histograms, queue wait per family, host-to-device bytes;
  the port adds each launch's STREAM interval, the device time between
  a pooled pair of ``torch.cuda.Event`` recorded on the stream the launch
  used, around it: an upper bound of the kernel's device time. A pair is
  resolved with ``Event.query()`` (never a synchronize) in the sampler
  tick and when a snapshot is taken; pairs not yet finished count as
  `pending`, launches that found the pool dry as `untimed`, and pairs
  that another launch began or ended inside as `overlapped` (not timed:
  the stream is shared). What a kernel itself takes as served comes from a
  device-profile capture.
* ``device_memory_stats`` (:648) from torch.cuda's allocator.
* ``DeviceProfiler`` (:699): POST /debug/device-profile wraps a sleep of
  the requested seconds in ``torch.profiler`` (CUDA activity on a card)
  into a byte-capped spool directory, and reports the device's busy time,
  its idle share and the port's kernels the trace names. One capture at a
  time, and none while another torch.profiler session runs: both answer
  "busy".

* ``health_score`` (:802-856): the node's green/yellow/red verdict from
  its health inputs, which GET /status reports and the QoS plane's
  healthRed shed reads.

XLACounters has no counterpart: the port compiles nothing per shape (its
one nvcc build is logged by ops/_build.py).

Kill switches, read per call: PILOSA_TPU_TORCH_TELEMETRY=0 (sampler and
kernel statistics), PILOSA_TPU_TORCH_KERNEL_STATS=0 (kernel statistics
alone), PILOSA_TPU_TORCH_DEVICE_PROFILE=0 (captures).
"""

from __future__ import annotations

import collections
import os
import shutil
import tempfile
import threading
import time
from typing import Callable, Optional

import torch

from pilosa_tpu_torch.constants import KERNEL_FAMILY_REPS
from pilosa_tpu_torch.utils.stats import _pow2_bucket


def enabled() -> bool:
    """PILOSA_TPU_TORCH_TELEMETRY=0 stops sampling and kernel statistics."""
    return os.environ.get("PILOSA_TPU_TORCH_TELEMETRY", "1") != "0"


def kernel_stats_enabled() -> bool:
    """PILOSA_TPU_TORCH_KERNEL_STATS=0 stops kernel statistics (host and
    event timing); implied off with telemetry off."""
    return (enabled()
            and os.environ.get("PILOSA_TPU_TORCH_KERNEL_STATS", "1") != "0")


def device_profile_enabled() -> bool:
    """PILOSA_TPU_TORCH_DEVICE_PROFILE=0 refuses device-profile captures."""
    return os.environ.get("PILOSA_TPU_TORCH_DEVICE_PROFILE", "1") != "0"


# ---------------------------------------------------------------------------
# Time-series ring
# ---------------------------------------------------------------------------


class Ring:
    """Bounded time series of (seq, ts, {gauge: value}) samples; seq
    ascends forever, so `since(cursor)` hands each sample out once."""

    def __init__(self, size: int = 720):
        self.size = max(1, int(size))
        self._buf: collections.deque = collections.deque(maxlen=self.size)
        self._seq = 0
        self._lock = threading.Lock()

    def append(self, gauges: dict, ts: Optional[float] = None) -> int:
        if ts is None:
            ts = time.time()
        with self._lock:
            self._seq += 1
            self._buf.append((self._seq, ts, dict(gauges)))
            return self._seq

    def since(self, cursor: int = 0, limit: int = 0) -> dict:
        """Samples with seq > cursor (oldest first), the newest `limit`
        when set; `seq` is the next cursor."""
        with self._lock:
            out = [s for s in self._buf if s[0] > cursor]
            seq = self._seq
        if limit > 0:
            out = out[-limit:]
        return {"seq": seq, "samples": [
            {"seq": s, "ts": round(ts, 3), "gauges": g}
            for s, ts, g in out]}

    def latest(self) -> dict:
        with self._lock:
            return dict(self._buf[-1][2]) if self._buf else {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


class TelemetrySampler:
    """Background gauge sampler -> Ring. `source()` returns one flat
    {gauge: float} dict per tick. An interval <= 0 or the kill switch
    keeps the thread off; sample_once() still works."""

    def __init__(self, interval: float = 5.0, ring_size: int = 720,
                 source: Optional[Callable[[], dict]] = None):
        self.interval = interval
        self.ring = Ring(ring_size)
        self.source = source
        self._timer: Optional[threading.Timer] = None
        self._lock = threading.Lock()
        # stop()/start() bump the generation: a tick of an older chain
        # neither samples nor reschedules
        self._gen = 0
        self.closed = False
        self.running = False
        self.sample_errors = 0
        self.last_error = ""

    def sample_once(self) -> Optional[int]:
        if self.source is None:
            return None
        try:
            gauges = self.source()
        except Exception as e:  # noqa: BLE001 — a failing gauge must not
            # end the sampler; the error is counted and kept
            self.sample_errors += 1
            self.last_error = repr(e)
            return None
        return self.ring.append(gauges)

    def start(self) -> None:
        if self.interval <= 0 or not enabled() or self.source is None:
            return
        with self._lock:
            if self.running or self.closed:
                return
            self.running = True
            self._gen += 1
            gen = self._gen
        self._schedule(gen)

    def stop(self) -> None:
        with self._lock:
            self.running = False
            self._gen += 1
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None

    def close(self) -> None:
        self.closed = True
        self.stop()

    def _schedule(self, gen: int) -> None:
        with self._lock:
            if not self.running or self.closed or gen != self._gen:
                return
            self._timer = threading.Timer(self.interval, self._tick,
                                          args=(gen,))
            self._timer.daemon = True
            self._timer.start()

    def _tick(self, gen: int) -> None:
        with self._lock:
            if not self.running or self.closed or gen != self._gen:
                return
        try:
            self.sample_once()
        finally:
            self._schedule(gen)


# ---------------------------------------------------------------------------
# Kernel statistics
# ---------------------------------------------------------------------------


def kernel_rep(family: str) -> str:
    """Device representation of a kernel family (KERNEL_FAMILY_REPS)."""
    return KERNEL_FAMILY_REPS.get(family, "dense")


# recent stream intervals kept per kernel name for its p50/p99
RECENT_TIMES = 2048
# event pairs in the pool: launches past this many unresolved ones are
# counted `untimed`
EVENT_PAIRS = 4096

_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream",
                      lambda index: None)

_HOST = object()  # a step on the CPU: host time only


def _make_event():
    """A timing event, created now (torch creates it at its first record)
    so that its handle exists."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


_CUDART = None


def _cudart():
    """The CUDA runtime torch loaded, called through ctypes.PyDLL: the
    record does not release the GIL. Releasing it on a serving thread
    hands the GIL to one of the other request threads, and the batch
    leader then waits for it back; under 32 clients that wait, twice per
    launch, cost the Count path more than the records themselves."""
    global _CUDART
    if _CUDART is None:
        import ctypes

        major = torch.version.cuda.split(".")[0]
        lib = ctypes.PyDLL(f"libcudart.so.{major}")  # torch's, by soname
        lib.cudaEventRecord.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.cudaEventRecord.restype = ctypes.c_int
        _CUDART = lib
    return _CUDART


def _record(event, device) -> None:
    """Record `event` on the device's current stream, the one the
    wrappers launch on (ops/kernels.py _stream)."""
    rc = _cudart().cudaEventRecord(event.cuda_event,
                                   _raw_stream(device.index))
    if rc:
        raise RuntimeError(f"cudaEventRecord failed ({rc})")


class _Launch:
    """One launch's token: its event pair (None: the pool was dry), the
    launch sequence number at its begin, and whether no other launch was
    open then."""

    __slots__ = ("pair", "seq", "alone")

    def __init__(self, pair, seq: int, alone: bool):
        self.pair, self.seq, self.alone = pair, seq, alone


class _StreamTimes:
    """Stream intervals per (family, name) from pooled CUDA event pairs.

    The launches share one stream, so a pair times whatever was queued
    between its two records. Every begin and end takes the next number of
    one launch sequence, under the lock that records the events: a pair
    is kept only when no other launch was open at its begin and none
    began or ended before its end. The others count as `overlapped`.
    Plain-torch work that no launch brackets can still fall inside a
    kept pair, so its time is an upper bound of the launch's."""

    def __init__(self, cap_pairs: int = EVENT_PAIRS):
        self.cap = cap_pairs
        self.make_event = _make_event
        self.record = _record
        self._lock = threading.Lock()
        self._free: list = []
        self._pending: collections.deque = collections.deque()
        self._made = 0
        self._seq = 0   # begins and ends so far
        self._open = 0  # launches begun and not ended
        self.untimed = 0
        self.overlapped = 0
        self._by: dict = {}
        self._seen: dict = {}  # (family, name) -> [launches, host ms]

    def begin(self, device) -> _Launch:
        with self._lock:
            pair = self._free.pop() if self._free else None
            if pair is None:
                if self._made < self.cap:
                    self._made += 1
                    pair = (self.make_event(), self.make_event())
                else:
                    self._resolve_locked()
                    pair = self._free.pop() if self._free else None
            if pair is not None:
                self.record(pair[0], device)
            tok = _Launch(pair, self._seq, self._open == 0)
            self._seq += 1
            self._open += 1
            return tok

    def discard(self, tok: _Launch) -> None:
        """Close a begun launch unrecorded (its step raised)."""
        with self._lock:
            self._seq += 1
            self._open -= 1
            if tok.pair is not None:
                self._free.append(tok.pair)

    def end(self, tok: _Launch, family: str, name: str, device,
            host_ms: float) -> None:
        """The launch is queued: its end event on the stream, and its
        count and host time under (family, name)."""
        with self._lock:
            pair = tok.pair
            if pair is not None:
                self.record(pair[1], device)
            alone = tok.alone and self._seq == tok.seq + 1
            self._seq += 1
            self._open -= 1
            seen = self._seen.get((family, name))
            if seen is None:
                seen = self._seen[(family, name)] = [0, 0.0, 0]
            seen[0] += 1
            seen[1] += host_ms
            if pair is None:
                self.untimed += 1
            elif alone:
                self._pending.append((pair, family, name))
            else:
                self.overlapped += 1
                seen[2] += 1
                self._free.append(pair)

    def _resolve_locked(self) -> None:
        """Record every finished pair, oldest first, stopping at the first
        unfinished one (later ones on the stream are not done either)."""
        pend = self._pending
        while pend and pend[0][0][1].query():
            pair, family, name = pend.popleft()
            ms = pair[0].elapsed_time(pair[1])
            s = self._by.get((family, name))
            if s is None:
                s = self._by[(family, name)] = {
                    "timed": 0, "ms": 0.0, "min": None, "max": None,
                    "recent": collections.deque(maxlen=RECENT_TIMES)}
            s["timed"] += 1
            s["ms"] += ms
            s["min"] = ms if s["min"] is None else min(s["min"], ms)
            s["max"] = ms if s["max"] is None else max(s["max"], ms)
            s["recent"].append(ms)
            self._free.append(pair)

    def resolve(self) -> None:
        with self._lock:
            self._resolve_locked()

    def snapshot(self) -> dict:
        """Per kernel name: launches and mean host ms of the wrapper, and
        the stream ms of its resolved pairs (p50/p99 over the last
        RECENT_TIMES); per family the totals."""
        with self._lock:
            self._resolve_locked()
            by_kernel = {}
            by_family: dict = {}
            for (fam, name), (n, host, over) in sorted(self._seen.items()):
                s = self._by.get((fam, name))
                rec = {"family": fam, "launches": n,
                       "hostAvgMs": round(host / n, 4), "timed": 0,
                       "overlapped": over}
                if s is not None:
                    recent = sorted(s["recent"])
                    rec.update({
                        "timed": s["timed"], "msTotal": round(s["ms"], 4),
                        "avgMs": round(s["ms"] / s["timed"], 4),
                        "p50Ms": round(_quantile(recent, 0.5), 4),
                        "p99Ms": round(_quantile(recent, 0.99), 4),
                        "minMs": round(s["min"], 4),
                        "maxMs": round(s["max"], 4)})
                by_kernel[name] = rec
                f = by_family.setdefault(fam, {"launches": 0, "timed": 0,
                                               "msTotal": 0.0})
                f["launches"] += n
                f["timed"] += rec["timed"]
                f["msTotal"] = round(f["msTotal"] + rec.get("msTotal", 0.0),
                                     4)
            return {"pending": len(self._pending), "untimed": self.untimed,
                    "overlapped": self.overlapped, "poolPairs": self._made, "byKernel": by_kernel,
                    "byFamily": by_family}

    def metrics_timings(self) -> dict:
        """kernelStreamMs/<name>,family:<family> histograms (StatsClient
        timing form) over the recent stream intervals of each kernel."""
        out = {}
        with self._lock:
            self._resolve_locked()
            for (fam, name), s in self._by.items():
                buckets: dict = {}
                for ms in s["recent"]:
                    b = _pow2_bucket(ms)
                    buckets[b] = buckets.get(b, 0) + 1
                out[f"kernelStreamMs/{name},family:{fam}"] = {
                    "count": len(s["recent"]), "sum": sum(s["recent"]),
                    "min": s["min"], "max": s["max"], "buckets": buckets}
        return out

    def reset(self) -> None:
        with self._lock:
            self._resolve_locked()
            self._by.clear()
            self._seen.clear()
            self.untimed = 0
            self.overlapped = 0


def _quantile(sorted_vals: list, q: float) -> float:
    """Nearest-rank quantile of an ascending list (0.0 when empty)."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals) + 0.5) - 1))
    return sorted_vals[i]


class KernelStats:
    """Per-(family, rep, arity) dispatch counts and host-latency log2
    histograms, per-family queue wait and h2d/d2h bytes (the JAX :377
    surface), plus each kernel's stream interval by CUDA events."""

    def __init__(self):
        self._lock = threading.Lock()
        self._calls: dict[tuple, dict] = {}
        self._wait: dict[str, dict] = {}
        self._bytes: dict[str, dict] = {}
        self.dispatches = 0
        self.dispatch_ms_total = 0.0
        self.stream = _StreamTimes()

    def record_call(self, family: str, rep: str, arity: int,
                    ms: Optional[float] = None,
                    h2d_bytes: int = 0) -> None:
        """One dispatch under (family, rep, arity); `ms` is its host wall
        time (None: counted without a latency sample)."""
        key = (family, rep, int(arity))
        with self._lock:
            c = self._calls.get(key)
            if c is None:
                c = self._calls[key] = {
                    "dispatches": 0, "timed": 0, "ms": 0.0,
                    "min": None, "max": None, "buckets": {}}
            c["dispatches"] += 1
            self.dispatches += 1
            if ms is not None:
                c["timed"] += 1
                c["ms"] += ms
                c["min"] = ms if c["min"] is None else min(c["min"], ms)
                c["max"] = ms if c["max"] is None else max(c["max"], ms)
                b = _pow2_bucket(ms)
                c["buckets"][b] = c["buckets"].get(b, 0) + 1
                self.dispatch_ms_total += ms
            if h2d_bytes:
                by = self._bytes.setdefault(family, {"h2d": 0, "d2h": 0})
                by["h2d"] += int(h2d_bytes)

    def record_wait(self, family: str, ms: float, n: int = 1) -> None:
        """Queue wait (submit -> delivery) of `n` requests of a batch."""
        with self._lock:
            w = self._wait.setdefault(family, {"ms": 0.0, "n": 0})
            w["ms"] += float(ms)
            w["n"] += int(n)

    def record_bytes(self, family: str, h2d: int = 0, d2h: int = 0) -> None:
        with self._lock:
            by = self._bytes.setdefault(family, {"h2d": 0, "d2h": 0})
            by["h2d"] += int(h2d)
            by["d2h"] += int(d2h)

    def totals(self) -> dict:
        """Flat cumulative totals for the sampler's rates."""
        with self._lock:
            return {
                "dispatches": self.dispatches,
                "dispatch_ms_total": self.dispatch_ms_total,
                "wait_ms_total": sum(w["ms"] for w in self._wait.values()),
                "waited": sum(w["n"] for w in self._wait.values()),
                "h2d_bytes": sum(b["h2d"] for b in self._bytes.values()),
                "d2h_bytes": sum(b["d2h"] for b in self._bytes.values()),
            }

    def snapshot(self) -> dict:
        """The /debug/vars `kernels` block."""
        with self._lock:
            calls = [
                {"family": fam, "rep": rep, "arity": ar,
                 "dispatches": c["dispatches"], "timed": c["timed"],
                 "msTotal": round(c["ms"], 3),
                 "avgMs": round(c["ms"] / c["timed"], 4) if c["timed"]
                 else 0.0,
                 "minMs": c["min"], "maxMs": c["max"],
                 "buckets": dict(c["buckets"])}
                for (fam, rep, ar), c in sorted(self._calls.items())]
            wait = {fam: {"msTotal": round(w["ms"], 3), "waited": w["n"],
                          "avgMs": round(w["ms"] / w["n"], 3) if w["n"]
                          else 0.0}
                    for fam, w in sorted(self._wait.items())}
            byts = {fam: dict(b) for fam, b in sorted(self._bytes.items())}
            out = {"enabled": kernel_stats_enabled(),
                   "dispatches": self.dispatches,
                   "dispatchMsTotal": round(self.dispatch_ms_total, 3),
                   "calls": calls, "wait": wait, "bytes": byts}
        out["streamTimes"] = self.stream.snapshot()
        return out

    def metrics_view(self) -> tuple[dict, dict]:
        """(counts, timings) in StatsClient key form for /metrics:
        pilosa_kernels*_total counters, the pilosa_kernelDispatchMs host
        histograms and the port's pilosa_kernelStreamMs event histograms."""
        counts: dict = {}
        timings: dict = {}
        with self._lock:
            for (fam, rep, ar), c in self._calls.items():
                k = f"kernelsDispatches/{fam},rep:{rep}"
                counts[k] = counts.get(k, 0) + c["dispatches"]
                if c["timed"]:
                    tk = f"kernelDispatchMs/{fam},rep:{rep}"
                    t = timings.setdefault(tk, {
                        "count": 0, "sum": 0.0, "min": None, "max": None,
                        "buckets": {}})
                    t["count"] += c["timed"]
                    t["sum"] += c["ms"]
                    t["min"] = c["min"] if t["min"] is None \
                        else min(t["min"], c["min"])
                    t["max"] = c["max"] if t["max"] is None \
                        else max(t["max"], c["max"])
                    for b, n in c["buckets"].items():
                        t["buckets"][b] = t["buckets"].get(b, 0) + n
            for fam, w in self._wait.items():
                counts[f"kernelsWaitMs/{fam},rep:{kernel_rep(fam)}"] = \
                    w["ms"]
                counts[f"kernelsWaited/{fam},rep:{kernel_rep(fam)}"] = \
                    w["n"]
            for fam, b in self._bytes.items():
                rep = kernel_rep(fam)
                counts[f"kernelsH2dBytes/{fam},rep:{rep}"] = b["h2d"]
                counts[f"kernelsD2hBytes/{fam},rep:{rep}"] = b["d2h"]
        timings.update(self.stream.metrics_timings())
        return counts, timings

    def reset(self) -> None:
        with self._lock:
            self._calls.clear()
            self._wait.clear()
            self._bytes.clear()
            self.dispatches = 0
            self.dispatch_ms_total = 0.0
        self.stream.reset()


# process-global, like the launch counts of ops/kernels.py: every launch
# site records here; /debug/vars, /metrics and the sampler read it
kernels = KernelStats()


def launch_begin(device):
    """Right before a launch on `device`: a started event pair (recorded
    on the device's current stream, the one the launch uses), or None
    when kernel statistics are off."""
    if not kernel_stats_enabled():
        return None
    if device.type != "cuda":
        return _HOST
    return kernels.stream.begin(device)


def launch_end(token, family: str, name: str, arity: int, t0: float,
               device, h2d_bytes: int = 0) -> None:
    """Right after the launch: its host wall time since t0 and its h2d
    bytes into KernelStats, and the event pair's end on the stream."""
    if token is None:
        return
    ms = (time.perf_counter() - t0) * 1e3
    kernels.record_call(family, kernel_rep(family), arity, ms=ms,
                        h2d_bytes=h2d_bytes)
    if token is not _HOST:
        kernels.stream.end(token, family, name, device, ms)


def launch_abort(token) -> None:
    """A launch begun by launch_begin that did not happen (it raised)."""
    if token is not None and token is not _HOST:
        kernels.stream.discard(token)


class timed:
    """Context manager timing a plain-torch step as one dispatch of
    `family` (host wall time and, on a card, its stream interval under
    `name`)."""

    __slots__ = ("family", "name", "device", "arity", "t0", "token")

    def __init__(self, family: str, name: str, device, arity: int = 1):
        self.family, self.name, self.device = family, name, device
        self.arity = arity

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.token = launch_begin(self.device)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            launch_end(self.token, self.family, self.name, self.arity,
                       self.t0, self.device)
        else:
            launch_abort(self.token)


# ---------------------------------------------------------------------------
# Device memory
# ---------------------------------------------------------------------------


def device_memory_stats() -> list[dict]:
    """The CUDA caching allocator's view of each initialised card: live
    (allocated) and reserved bytes, the card's memory and the peak. Empty
    on a machine without CUDA or before the first CUDA allocation."""
    out: list[dict] = []
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return out
    for i in range(torch.cuda.device_count()):
        out.append({
            "device": f"cuda:{i}", "platform": "gpu",
            "memoryStats": {
                "bytes_in_use": int(torch.cuda.memory_allocated(i)),
                "bytes_reserved": int(torch.cuda.memory_reserved(i)),
                "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
                "bytes_limit": int(
                    torch.cuda.get_device_properties(i).total_memory)}})
    return out


# ---------------------------------------------------------------------------
# On-demand device profile capture
# ---------------------------------------------------------------------------

# captures beyond this total size evict oldest first
PROFILE_SPOOL_CAP_BYTES = 256 << 20
MAX_PROFILE_SECONDS = 60.0


def _dir_bytes(path: str) -> int:
    total = 0
    for dirpath, _, names in os.walk(path):
        for n in names:
            try:
                total += os.path.getsize(os.path.join(dirpath, n))
            except OSError:
                pass
    return total


def busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    spans = sorted(intervals)
    if not spans:
        return 0.0
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return busy + hi - lo


class DeviceProfiler:
    """POST /debug/device-profile: `seconds` of live traffic under
    torch.profiler, the chrome trace spooled into a byte-capped
    directory. On a card the capture traces CUDA activity and reports the
    device's busy ms (union of its kernel spans), the idle share over the
    capture, and the launches it saw of each kernel named in
    `kernel_names` with their device ms (the kernel alone, as served); on
    the CPU it traces CPU activity and reports no device numbers."""

    def __init__(self, device, kernel_names=(),
                 spool_dir: Optional[str] = None,
                 cap_bytes: int = PROFILE_SPOOL_CAP_BYTES):
        self.device = torch.device(device)
        self.kernel_names = tuple(kernel_names)
        self.spool_dir = spool_dir or os.path.join(
            tempfile.gettempdir(), "pilosa-tpu-torch-device-profiles")
        self.cap_bytes = int(cap_bytes)
        self._busy = threading.Lock()
        self.captures = 0
        self.errors = 0
        self.last: Optional[dict] = None
        if self.device.type == "cuda" and device_profile_enabled():
            # kineto initialises its client at the first capture, and only
            # on the thread that imported torch: a first capture on an HTTP
            # worker traces no device activity. One empty capture here, on
            # the thread that opens the server, does it.
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]):
                pass

    def capture(self, seconds: float) -> dict:
        if not device_profile_enabled():
            return {"status": "disabled",
                    "error": "device profile capture disabled "
                             "(PILOSA_TPU_TORCH_DEVICE_PROFILE=0)"}
        try:
            seconds = max(0.05, min(float(seconds), MAX_PROFILE_SECONDS))
        except (TypeError, ValueError):
            return {"status": "error", "error": "invalid seconds"}
        if not self._busy.acquire(blocking=False):
            return {"status": "busy",
                    "error": "a device profile capture is already running"}
        try:
            if torch.autograd._profiler_enabled():
                return {"status": "busy",
                        "error": "another torch.profiler session is "
                                 "running in this process"}
            doc = self._capture_locked(seconds)
        except Exception as e:  # noqa: BLE001 — reported, and counted
            self.errors += 1
            doc = {"status": "error", "error": repr(e)}
        finally:
            self._busy.release()
        self.last = doc
        return doc

    def _capture_locked(self, seconds: float) -> dict:
        from torch.profiler import ProfilerActivity, profile

        on_card = self.device.type == "cuda"
        stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        out_dir = os.path.join(self.spool_dir,
                               f"capture-{stamp}-{self.captures}")
        os.makedirs(out_dir, exist_ok=True)
        acts = [ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            time.sleep(seconds)
            if on_card:
                torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        trace = os.path.join(out_dir, "trace.json")
        prof.export_chrome_trace(trace)
        self.captures += 1
        doc = {"status": "ok", "dir": out_dir, "trace": trace,
               "spoolDir": self.spool_dir, "seconds": round(elapsed, 3),
               "activity": "cuda" if on_card else "cpu",
               "bytes": _dir_bytes(out_dir), "captures": self.captures,
               "deviceBusyMs": None, "idleShare": None, "kernels": {},
               "kernelMs": {}}
        if on_card:
            spans, seen = [], collections.defaultdict(list)
            for e in prof.events():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                span = (e.time_range.start, e.time_range.end)
                spans.append(span)
                for n in self.kernel_names:
                    if n in e.name:
                        seen[n].append((span[1] - span[0]) / 1e3)
            busy = busy_ms(spans) / 1e3
            doc["deviceBusyMs"] = round(busy, 4)
            doc["idleShare"] = round(1.0 - busy / (elapsed * 1e3), 6)
            doc["kernels"] = {n: len(ms) for n, ms in sorted(seen.items())}
            doc["kernelMs"] = {n: {"p50Ms": round(_quantile(sorted(ms), 0.5),
                                                  4),
                                   "p99Ms": round(_quantile(sorted(ms), 0.99),
                                                  4)}
                               for n, ms in sorted(seen.items())}
        self._enforce_cap()
        return doc

    def _enforce_cap(self) -> None:
        """Evict the oldest captures until the spool fits the cap (the
        newest always stays)."""
        try:
            subdirs = [os.path.join(self.spool_dir, n)
                       for n in os.listdir(self.spool_dir)
                       if n.startswith("capture-")]
        except OSError:
            return
        subdirs = [d for d in subdirs if os.path.isdir(d)]
        subdirs.sort(key=os.path.getmtime)
        sizes = {d: _dir_bytes(d) for d in subdirs}
        total = sum(sizes.values())
        while total > self.cap_bytes and len(subdirs) > 1:
            victim = subdirs.pop(0)
            total -= sizes[victim]
            shutil.rmtree(victim, ignore_errors=True)

    def snapshot(self) -> dict:
        return {"enabled": device_profile_enabled(),
                "spoolDir": self.spool_dir,
                "capBytes": self.cap_bytes,
                "spoolBytes": _dir_bytes(self.spool_dir)
                if os.path.isdir(self.spool_dir) else 0,
                "captures": self.captures, "errors": self.errors,
                "busy": self._busy.locked(), "last": self.last}


# ---------------------------------------------------------------------------
# Node health score
# ---------------------------------------------------------------------------

# 5xx responses a second over the sampler's window
ERROR_RATE_YELLOW = 0.1
ERROR_RATE_RED = 2.0
# fan-out work queued past the pool, as a multiple of its size
QUEUE_SATURATION_YELLOW = 2.0

_SEVERITY = {"green": 0, "yellow": 1, "red": 2}


def health_score(inputs: dict) -> dict:
    """{"score": green | yellow | red, "reasons": [...]} of a node's
    health inputs (:802-856), the one definition /status and the QoS
    plane's healthRed shed read. Inputs, absent meaning healthy:
    walPoisoned, needsRebuild, damagedFragments, errorRate (5xx/s),
    queueSaturation (queued / pool size), draining (yellow, never red),
    fencedShards, and sloStatus/sloReason (SLOTracker.worst()). The JAX
    input recompileStormActive has no counterpart: the port compiles
    nothing per shape."""
    score = "green"
    reasons: list[str] = []

    def worsen(level: str, why: str) -> None:
        nonlocal score
        if _SEVERITY[level] > _SEVERITY[score]:
            score = level
        reasons.append(why)

    if inputs.get("walPoisoned"):
        worsen("red", "WAL poisoned: writes refused until snapshot")
    n = int(inputs.get("needsRebuild") or 0)
    if n:
        worsen("yellow", f"{n} quarantined fragment(s) awaiting replica "
                         "rebuild")
    d = int(inputs.get("damagedFragments") or 0)
    if d and not n:
        worsen("yellow", f"{d} fragment(s) recovered from damage "
                         "(quarantine/torn WAL)")
    err = float(inputs.get("errorRate") or 0.0)
    if err >= ERROR_RATE_RED:
        worsen("red", f"HTTP 5xx rate {err:.2f}/s")
    elif err >= ERROR_RATE_YELLOW:
        worsen("yellow", f"HTTP 5xx rate {err:.2f}/s")
    sat = float(inputs.get("queueSaturation") or 0.0)
    if sat >= QUEUE_SATURATION_YELLOW:
        worsen("yellow", f"fan-out queue saturated ({sat:.1f}x pool size)")
    if inputs.get("draining"):
        worsen("yellow", "node draining (graceful restart in progress)")
    fenced = int(inputs.get("fencedShards") or 0)
    if fenced:
        worsen("yellow", f"{fenced} shard(s) read-fenced pending rejoin "
                         "parity verification")
    slo_status = inputs.get("sloStatus")
    if slo_status in ("yellow", "red"):
        worsen(slo_status,
               inputs.get("sloReason") or "SLO burn-rate alert")
    return {"score": score, "reasons": reasons}
