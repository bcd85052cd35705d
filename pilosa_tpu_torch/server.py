"""Server: holder + executor + API + HTTP, mirroring pilosa_tpu.server.

    srv = Server(data_dir, port=0, device="cuda").open()
    ... POST srv.uri + "/index/i/query" ...
    srv.close()

A single node on one device: no cluster, gossip or QoS.

sparse_threshold and run_threshold are the JAX server's [query]
sparse-threshold and run-threshold (pilosa_tpu/server.py:245-260): rows
with at most sparse_threshold bits in every shard load as sparse leaves,
rows above it with at most run_threshold intervals as run leaves; 0
disables a form. plan ("on" | "off") and plan_cache_bytes (0: off) are
its [query] plan and plan-cache-bytes (:84-85, :131-134, :235-244): the
planner and the plan cache, on by default with a 256 MiB budget; the
PILOSA_TPU_TORCH_PLANNER=0 and PILOSA_TPU_TORCH_PLAN_CACHE=0 switches win
over them.

Observability (pilosa_tpu/server.py:57, :118-137, :274-279, :392,
:2095): the server owns the StatsClient and the Tracer it gives the
executor, the device profiler behind POST /debug/device-profile, and the
telemetry sampler, which every telemetry_interval seconds (0: off) puts
sample_gauges() into the ring of GET /debug/timeseries. long_query_time
(seconds, 0: off) arms the slow-query history; eviction is the
residency's [storage] eviction, "lru" or "heat".
"""

from __future__ import annotations

import threading
import time

from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.net.http_server import Handler, HTTPServer
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel.residency import (
    DEFAULT_RUN_THRESHOLD,
    DEFAULT_SPARSE_THRESHOLD,
    PlanCache,
)
from pilosa_tpu_torch.state import open_holder
from pilosa_tpu_torch.utils import telemetry as _telemetry
from pilosa_tpu_torch.utils.stats import StatsClient
from pilosa_tpu_torch.utils.tracing import Tracer


def process_rss() -> int:
    """Resident set size of this process in bytes (0 where unknown)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


class Server:
    def __init__(self, data_dir: str, host: str = "localhost", port: int = 0,
                 device="cuda",
                 sparse_threshold: int = DEFAULT_SPARSE_THRESHOLD,
                 run_threshold: int = DEFAULT_RUN_THRESHOLD,
                 long_query_time: float = 0.0,
                 eviction: str = "lru",
                 telemetry_interval: float = 5.0,
                 plan: str = "on",
                 plan_cache_bytes: int = PlanCache.DEFAULT_BUDGET_BYTES):
        for name, value in (("sparse-threshold", sparse_threshold),
                            ("run-threshold", run_threshold)):
            if value < 0:
                raise ValueError(f"invalid [query] {name} {value!r} "
                                 "(expected >= 0)")
        if plan not in ("on", "off"):
            raise ValueError(f"invalid [query] plan {plan!r} "
                             "(expected on | off)")
        if eviction not in ("lru", "heat"):
            raise ValueError(f"invalid [storage] eviction {eviction!r} "
                             "(expected lru | heat)")
        self.data_dir = data_dir
        self.host = host
        self.port = port
        self.device = device
        self.sparse_threshold = sparse_threshold
        self.run_threshold = run_threshold
        self.long_query_time = long_query_time
        self.eviction = eviction
        self.plan = plan
        self.plan_cache_bytes = plan_cache_bytes
        self.stats = StatsClient()
        self.tracer = Tracer()
        self.telemetry = _telemetry.TelemetrySampler(
            interval=telemetry_interval, source=self.sample_gauges)
        self._telemetry_prev: tuple = (None, 0.0)
        self._last_hit_rate = 1.0  # carried through windows without lookups
        self._last_plan_hit_rate = 0.0  # the plan cache starts cold
        self.holder = None
        self.executor = None
        self.api = None
        self.http = None
        self.device_profiler = None

    def open(self) -> "Server":
        self.holder = open_holder(self.data_dir)
        self.executor = Executor(self.holder, device=self.device)
        self.executor.hybrid.threshold = self.sparse_threshold
        self.executor.hybrid.run_threshold = self.run_threshold
        self.executor.residency.eviction = self.eviction
        if self.plan == "off":
            self.executor.planner = None
        if self.plan_cache_bytes <= 0:
            self.executor.plan_cache = None
        elif self.executor.plan_cache is not None:
            self.executor.plan_cache.budget = self.plan_cache_bytes
        self.executor.stats = self.stats
        self.executor.tracer = self.tracer
        self.device_profiler = _telemetry.DeviceProfiler(
            self.executor.runner.device, kernel_names=kernels.DEVICE_KERNELS)
        self.api = API(self.holder, self.executor)
        self.api.long_query_time = self.long_query_time
        self.http = HTTPServer(
            Handler(self.api, stats=self.stats, telemetry=self.telemetry,
                    device_profiler=self.device_profiler),
            self.host, self.port)
        self.api.uri = self.http.uri
        self.http.serve_background()
        self.telemetry.start()
        return self

    @property
    def uri(self) -> str:
        return self.http.uri

    def close(self) -> None:
        self.telemetry.close()
        if self.http is not None:
            self.http.close()
            self.http = None
        if self.holder is not None:
            self.holder.close()

    def sample_gauges(self) -> dict:
        """One telemetry tick (pilosa_tpu/server.py:2095, the parts the
        port has): gauges of the residency, plan cache, planner, batchers,
        ingest, hybrid leaves, heat map, kernels, device memory and the
        process, and rates over the window since the previous tick. It
        also resolves the finished kernel event pairs and ticks the heat
        map's ring."""
        now = time.monotonic()
        g: dict = {}
        raw: dict = {}
        ex = self.executor
        res = ex.residency.snapshot()
        g["residency.bytes"] = float(res["bytes"])
        g["residency.budget"] = float(ex.residency.budget)
        g["residency.entries"] = float(res["entries"])
        raw["residency.hits"] = res["hits"]
        raw["residency.lookups"] = res["hits"] + res["misses"]
        raw["residency.evictions"] = res["evictions"]
        pc, pl = ex.plan_cache, ex.planner
        if pc is not None:
            cs = pc.snapshot()
            g["plancache.bytes"] = float(cs["bytes"])
            g["plancache.entries"] = float(cs["entries"])
            raw["plancache.hits"] = cs["hits"]
            raw["plancache.lookups"] = cs["hits"] + cs["misses"]
            raw["plancache.evictions"] = cs["evictions"]
        if pl is not None:
            ps = pl.snapshot()
            raw["planner.reorders"] = ps["reorders"]
            raw["planner.pushdowns"] = ps["pushdowns"]
            raw["planner.short_circuits"] = ps["shortCircuits"]
        if ex.heat is not None:
            hsum = ex.heat.sample_tick()
            g["heat.hot_fragments"] = float(hsum["hotFragments"])
            g["heat.skew"] = float(hsum["skew"])
            g["heat.tracker_entries"] = float(hsum["trackerEntries"])
        depth = 0
        for b in (ex.batcher, ex.sum_batcher):
            if b is None:
                continue
            bs = b.snapshot()
            depth += bs["queue_depth"]
            raw["batcher.wait_ms_total"] = raw.get(
                "batcher.wait_ms_total", 0.0) + bs["wait_ms_total"]
            raw["batcher.waited"] = raw.get("batcher.waited", 0) + bs["waited"]
            raw["batcher.batches"] = raw.get("batcher.batches", 0) \
                + bs["batches"]
        g["batcher.queue_depth"] = float(depth)
        hy = ex.hybrid_snapshot()
        g["hybrid.sparse_bytes"] = float(hy["residentSparseBytes"])
        g["hybrid.sparse_leaves"] = float(hy["residentSparseLeaves"])
        g["hybrid.run_bytes"] = float(hy["residentRunBytes"])
        g["hybrid.run_leaves"] = float(hy["residentRunLeaves"])
        ing = ex.ingest_snapshot()
        raw["ingest.mutations"] = ing["mutations"]
        raw["ingest.batches"] = ing["appliedBatches"]
        raw["ingest.wal_appends"] = ing["walAppends"]
        g["ingest.queue_depth"] = float(ing["queue_depth"])
        g["process.rss_bytes"] = float(process_rss())
        g["process.threads"] = float(threading.active_count())
        dev = ex.runner.device
        for d in _telemetry.device_memory_stats():
            if d["device"] == f"cuda:{dev.index}":
                ms = d["memoryStats"]
                g["device.bytes_in_use"] = float(ms["bytes_in_use"])
                g["device.bytes_reserved"] = float(ms["bytes_reserved"])
                g["device.bytes_limit"] = float(ms["bytes_limit"])
        _telemetry.kernels.stream.resolve()
        ks = _telemetry.kernels.totals()
        raw["kernels.dispatches"] = ks["dispatches"]
        raw["kernels.dispatch_ms"] = ks["dispatch_ms_total"]
        raw["kernels.wait_ms"] = ks["wait_ms_total"]
        raw["kernels.waited"] = ks["waited"]
        raw["kernels.h2d_bytes"] = ks["h2d_bytes"]

        prev, prev_t = self._telemetry_prev
        dt = max(1e-9, now - prev_t)

        def rate(name: str) -> float:
            if prev is None or name not in prev or name not in raw:
                return 0.0
            return max(0.0, (raw[name] - prev[name]) / dt)

        def delta(name: str) -> float:
            return raw.get(name, 0) - (prev or {}).get(name, 0)

        if prev is not None and delta("residency.lookups") > 0:
            self._last_hit_rate = (max(0.0, delta("residency.hits"))
                                   / delta("residency.lookups"))
        g["residency.hit_rate"] = self._last_hit_rate
        g["residency.evictions_per_s"] = rate("residency.evictions")
        if pc is not None:
            # over the window, as the residency's: a lifetime ratio hides
            # a cache that just began to thrash
            if prev is not None and delta("plancache.lookups") > 0:
                self._last_plan_hit_rate = (max(0.0, delta("plancache.hits"))
                                            / delta("plancache.lookups"))
            g["plancache.hit_rate"] = self._last_plan_hit_rate
            g["plancache.evictions_per_s"] = rate("plancache.evictions")
        if pl is not None:
            g["planner.reorders_per_s"] = rate("planner.reorders")
            g["planner.pushdowns_per_s"] = rate("planner.pushdowns")
            g["planner.short_circuits_per_s"] = rate(
                "planner.short_circuits")
        g["batcher.avg_wait_ms"] = (
            max(0.0, delta("batcher.wait_ms_total")) / delta("batcher.waited")
            if prev is not None and delta("batcher.waited") > 0 else 0.0)
        g["batcher.batches_per_s"] = rate("batcher.batches")
        g["ingest.sets_per_s"] = rate("ingest.mutations")
        g["ingest.batches_per_s"] = rate("ingest.batches")
        g["ingest.wal_appends_per_s"] = rate("ingest.wal_appends")
        g["kernels.dispatches_per_s"] = rate("kernels.dispatches")
        g["kernels.h2d_bytes_per_s"] = rate("kernels.h2d_bytes")
        g["kernels.avg_dispatch_ms"] = (
            max(0.0, delta("kernels.dispatch_ms"))
            / delta("kernels.dispatches")
            if prev is not None and delta("kernels.dispatches") > 0 else 0.0)
        g["kernels.avg_wait_ms"] = (
            max(0.0, delta("kernels.wait_ms")) / delta("kernels.waited")
            if prev is not None and delta("kernels.waited") > 0 else 0.0)
        self._telemetry_prev = (raw, now)
        return g
