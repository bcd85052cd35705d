"""System info, the diagnostics phone-home and the runtime monitor.

Copy of pilosa_tpu/utils/diagnostics.py. SystemInfo reads the host's
facts from /proc and `platform`; DiagnosticsCollector POSTs a JSON
document of the version, the schema's shape and the host every
`[diagnostics] interval` seconds to `[diagnostics] url`, is off unless
both are set, and swallows every network failure (reporting never
disturbs serving); RuntimeMonitor samples the process gauges (threads,
RSS, the garbage collector's counts) into the stats registry every
`[metric] poll-interval` seconds.
"""

from __future__ import annotations

import gc
import json
import os
import platform
import threading
import time
import urllib.request
from typing import Optional

from pilosa_tpu_torch.utils import threads


class SystemInfo:
    """Host facts from /proc + platform (gopsutil/systeminfo.go:1-193)."""

    def uptime(self) -> int:
        try:
            with open("/proc/uptime") as f:
                return int(float(f.read().split()[0]))
        except OSError:
            return 0

    def platform(self) -> str:
        return platform.system()

    def family(self) -> str:
        return platform.machine()

    def os_version(self) -> str:
        return platform.release()

    def kernel_version(self) -> str:
        return platform.version()

    def _meminfo(self) -> dict[str, int]:
        out: dict[str, int] = {}
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    k, _, rest = line.partition(":")
                    out[k.strip()] = int(rest.split()[0]) * 1024  # kB -> B
        except OSError:
            pass
        return out

    def mem_total(self) -> int:
        return self._meminfo().get("MemTotal", 0)

    def mem_free(self) -> int:
        return self._meminfo().get("MemAvailable", 0)

    def mem_used(self) -> int:
        m = self._meminfo()
        return m.get("MemTotal", 0) - m.get("MemAvailable", 0)

    def cpu_count(self) -> int:
        return os.cpu_count() or 0

    def cpu_model(self) -> str:
        try:
            with open("/proc/cpuinfo") as f:
                for line in f:
                    if line.startswith("model name"):
                        return line.partition(":")[2].strip()
        except OSError:
            pass
        return ""


class NopSystemInfo:
    """diagnostics.go:278 nopSystemInfo."""

    def uptime(self): return 0
    def platform(self): return ""
    def family(self): return ""
    def os_version(self): return ""
    def kernel_version(self): return ""
    def mem_total(self): return 0
    def mem_free(self): return 0
    def mem_used(self): return 0
    def cpu_count(self): return 0
    def cpu_model(self): return ""


def process_rss() -> int:
    """Resident set size of this process in bytes (monitorRuntime heap
    gauge analog)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


class DiagnosticsCollector:
    """Periodic anonymous usage report (diagnostics.go:42-260).

    Collects version + schema shape + host info and POSTs JSON to `url` every
    `interval` seconds. Inert unless both are set (the reference ships it off
    in non-release builds the same way, server/default.go:24)."""

    def __init__(self, version: str, url: str = "", interval: float = 0.0,
                 holder=None, cluster=None, system_info=None, logger=None):
        self.version = version
        self.url = url
        self.interval = interval
        self.holder = holder
        self.cluster = cluster
        self.system_info = system_info or SystemInfo()
        self.logger = logger
        self.start_time = time.monotonic()  # Uptime is elapsed, not wall
        self._timer: Optional[threading.Timer] = None
        self.closed = False

    # -- payload -------------------------------------------------------------

    def collect(self) -> dict:
        si = self.system_info
        info = {
            "Version": self.version,
            "Uptime": int(time.monotonic() - self.start_time),
            "OS": si.platform(),
            "Arch": si.family(),
            "OSVersion": si.os_version(),
            "KernelVersion": si.kernel_version(),
            "MemTotal": si.mem_total(),
            "MemUsed": si.mem_used(),
            "CPUArch": si.cpu_model(),
            "NumCPU": si.cpu_count(),
        }
        if self.holder is not None:
            indexes = getattr(self.holder, "indexes", {})
            info["NumIndexes"] = len(indexes)
            info["NumFields"] = sum(len(i.fields) for i in indexes.values())
        if self.cluster is not None:
            info["NumNodes"] = len(self.cluster.nodes)
        return info

    def flush(self) -> bool:
        """POST the report; all failures are swallowed (diagnostics must
        never disturb serving)."""
        if not self.url:
            return False
        try:
            body = json.dumps(self.collect()).encode()
            req = urllib.request.Request(
                self.url, data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10):
                return True
        except Exception:  # noqa: BLE001
            return False

    def check_version(self, version_url: str) -> Optional[str]:
        """Fetch the latest released version; returns it if newer than ours
        (diagnostics.go CheckVersion). None on any failure."""
        try:
            with urllib.request.urlopen(version_url, timeout=10) as resp:
                latest = json.loads(resp.read()).get("version", "")
        except Exception:  # noqa: BLE001
            return None
        if latest and latest != self.version:
            if self.logger is not None:
                self.logger.printf("newer version available: %s (running %s)",
                                   latest, self.version)
            return latest
        return None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self.interval <= 0 or not self.url:
            return
        self._schedule()

    def _schedule(self) -> None:
        if self.closed:
            return
        self._timer = threads.ctx_timer(self.interval, self._tick)
        self._timer.start()

    def _tick(self) -> None:
        try:
            self.flush()
        finally:
            self._schedule()

    def close(self) -> None:
        self.closed = True
        if self._timer is not None:
            self._timer.cancel()


class RuntimeMonitor:
    """Periodic process gauges -> stats (monitorRuntime, server.go:726-770:
    goroutines/heap/GC become threads/RSS/collections here)."""

    def __init__(self, stats, interval: float = 0.0):
        self.stats = stats
        self.interval = interval
        self._timer: Optional[threading.Timer] = None
        self.closed = False

    def sample(self) -> None:
        counts = gc.get_count()
        self.stats.gauge("threads", threading.active_count())
        self.stats.gauge("memory/rss", process_rss())
        self.stats.gauge("garbage/gen0", counts[0])
        self.stats.gauge("garbage/collections",
                         sum(s["collections"] for s in gc.get_stats()))

    def start(self) -> None:
        if self.interval > 0:
            self._schedule()

    def _schedule(self) -> None:
        if self.closed:
            return
        self._timer = threads.ctx_timer(self.interval, self._tick)
        self._timer.start()

    def _tick(self) -> None:
        try:
            self.sample()
        finally:
            self._schedule()

    def close(self) -> None:
        self.closed = True
        if self._timer is not None:
            self._timer.cancel()
