"""Server: holder + cluster + executor + API + HTTP, mirroring
pilosa_tpu.server.

    srv = Server(data_dir, port=0, device="cuda").open()
    ... POST srv.uri + "/index/i/query" ...
    srv.close()

One Server is one node on one device. Its id is kept in <data_dir>/.id
(the JAX package's file, :529). Without cluster_hosts it is a one-node
cluster. With them (every node's URI, this one's included) it is a node
of a static cluster (:580-600): it starts as a cluster of itself and
merges the node lists its peers report on GET /internal/nodes, at open
and then every membership_interval seconds (refresh_membership,
:758-800), so peers may start in any order. Shards are placed on
replica_n nodes by the JAX package's jump hash (parallel/cluster.py); the
coordinator, the lowest node id, is the translation primary
(utils/cluster_translate.py).

The node answers the cluster's messages (receive_message, :1472): index
and field creation and deletion, create-shard, set-coordinator and
node-state. Schema changes go to every peer synchronously (broadcast); a
field's new shard goes to every peer through per-peer sender threads
(broadcast_async, _bcast_worker), except that a Set which creates a shard
announces it to every peer, waiting at most ANNOUNCE_SHARD_BUDGET_S,
before it is acknowledged (:1553-1680). query_timeout is the [cluster]
query-timeout, the deadline of every query; fanout_pool_size,
fanout_coalesce_window, fanout_coalesce_max_batch, hedge_delay and
ici_serving are the fan-out knobs of the same section (:196-222).

Not served yet: liveness probing and gossip, hinted handoff, the read
fence, drain, resize, anti-entropy, QoS and the /cluster/* federation;
no peer is ever marked down, so a write whose replica cannot be reached
fails (the JAX cluster with probing off).

String keys are minted into a TranslateStore at <data_dir>/.keys (its
sqlite index at .keys.idx; pilosa_tpu/server.py:151) through the
ClusterTranslator, which the API and the executor share and close()
closes.

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

import os
import queue
import threading
import time
import uuid
from typing import Optional

from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.models.field import FieldOptions
from pilosa_tpu_torch.net.client import ClientError, InternalClient
from pilosa_tpu_torch.net.http_server import Handler, HTTPServer
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel.cluster import Cluster, Node
from pilosa_tpu_torch.parallel.residency import (
    DEFAULT_RUN_THRESHOLD,
    DEFAULT_SPARSE_THRESHOLD,
    PlanCache,
)
from pilosa_tpu_torch.state import open_holder
from pilosa_tpu_torch.utils import telemetry as _telemetry
from pilosa_tpu_torch.utils.cluster_translate import ClusterTranslator
from pilosa_tpu_torch.utils.stats import StatsClient
from pilosa_tpu_torch.utils.tracing import Tracer
from pilosa_tpu_torch.utils.translate import TranslateStore

# seconds a GET /internal/nodes of the membership refresh may take (the
# JAX server's probe-timeout default)
PEER_TIMEOUT_S = 2.0


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
    # the longest a shard-creating Set waits for its announcement
    ANNOUNCE_SHARD_BUDGET_S = 0.5
    # a peer's async queue bound: past it messages are dropped
    BCAST_PEER_QUEUE_MAX = 1024

    def __init__(self, data_dir: str, host: str = "localhost", port: int = 0,
                 device="cuda",
                 sparse_threshold: int = DEFAULT_SPARSE_THRESHOLD,
                 run_threshold: int = DEFAULT_RUN_THRESHOLD,
                 long_query_time: float = 0.0,
                 eviction: str = "lru",
                 telemetry_interval: float = 5.0,
                 plan: str = "on",
                 plan_cache_bytes: int = PlanCache.DEFAULT_BUDGET_BYTES,
                 node_id: Optional[str] = None,
                 cluster_hosts: Optional[list] = None,
                 replica_n: int = 1,
                 membership_interval: float = 5.0,
                 query_timeout: float = 0.0,
                 fanout_pool_size: int = 32,
                 fanout_coalesce_window: float = 0.002,
                 fanout_coalesce_max_batch: int = 64,
                 hedge_delay: float = 0.0,
                 ici_serving: str = "auto"):
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
        if ici_serving not in ("off", "auto", "on"):
            raise ValueError(f"invalid [cluster] ici-serving {ici_serving!r}"
                             " (expected off | auto | on)")
        self.data_dir = data_dir
        self.node_id = node_id
        self.cluster_hosts = list(cluster_hosts or [])
        self.replica_n = replica_n
        self.membership_interval = membership_interval
        self.query_timeout = query_timeout
        self.fanout_pool_size = fanout_pool_size
        self.fanout_coalesce_window = fanout_coalesce_window
        self.fanout_coalesce_max_batch = fanout_coalesce_max_batch
        self.hedge_delay = hedge_delay
        self.ici_serving = ici_serving
        self.cluster = None
        self.client = None
        self.cluster_translate = None
        self.closed = False
        self._member_timer: Optional[threading.Timer] = None
        self._bcast_queue: queue.Queue = queue.Queue()
        self._bcast_thread: Optional[threading.Thread] = None
        self._bcast_dropped = 0
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
        self.translate = None
        self.executor = None
        self.api = None
        self.http = None
        self.device_profiler = None

    def _load_or_create_id(self) -> str:
        """The node's persistent id, <data_dir>/.id (holder.go:576)."""
        os.makedirs(self.data_dir, exist_ok=True)
        path = os.path.join(self.data_dir, ".id")
        if os.path.exists(path):
            with open(path) as f:
                return f.read().strip()
        node_id = str(uuid.uuid4())
        with open(path, "w") as f:
            f.write(node_id)
        return node_id

    def open(self) -> "Server":
        self.holder = open_holder(self.data_dir)
        self.node_id = self.node_id or self._load_or_create_id()
        self.cluster = Cluster(self.node_id, replica_n=self.replica_n)
        self.client = InternalClient()
        self.translate = TranslateStore(
            os.path.join(self.data_dir, ".keys")).open()
        self.cluster_translate = ClusterTranslator(self.translate,
                                                   self.cluster, self.client)
        self.executor = Executor(self.holder, device=self.device,
                                 translator=self.cluster_translate,
                                 cluster=self.cluster, client=self.client)
        ex = self.executor
        ex.hybrid.threshold = self.sparse_threshold
        ex.hybrid.run_threshold = self.run_threshold
        ex.residency.eviction = self.eviction
        if self.plan == "off":
            ex.planner = None
        if self.plan_cache_bytes <= 0:
            ex.plan_cache = None
        elif ex.plan_cache is not None:
            ex.plan_cache.budget = self.plan_cache_bytes
        ex.stats = self.stats
        ex.tracer = self.tracer
        ex.fanout_pool_size = self.fanout_pool_size
        ex.hedge_delay = self.hedge_delay
        ex.ici_mode = self.ici_serving
        if ex.coalescer is not None:
            ex.coalescer.admission_s = self.fanout_coalesce_window
            ex.coalescer.max_batch = max(1, self.fanout_coalesce_max_batch)
        self.device_profiler = _telemetry.DeviceProfiler(
            ex.runner.device, kernel_names=kernels.DEVICE_KERNELS)
        self.api = API(self.holder, ex, self.cluster_translate,
                       cluster=self.cluster)
        self.api.long_query_time = self.long_query_time
        self.handler = Handler(self.api, stats=self.stats,
                               telemetry=self.telemetry,
                               device_profiler=self.device_profiler,
                               cluster_message_fn=self.receive_message,
                               query_timeout=self.query_timeout)
        self.http = HTTPServer(self.handler, self.host, self.port)
        self.api.uri = self.http.uri
        self.holder.set_shard_hook(self._on_shard_added)
        self.http.serve_background()
        me = Node(id=self.node_id, uri=self.http.uri,
                  is_coordinator=not self.cluster_hosts)
        self.cluster.set_static([me])
        if not self.cluster_hosts:
            self.cluster.coordinator_id = self.node_id
        else:
            # peers may not be up yet: start as a cluster of this node
            # and merge what they report, now and every tick
            self.refresh_membership()
            if self.membership_interval > 0:
                self._schedule_membership_refresh()
        self.api.broadcast_fn = self.broadcast
        self.api.forward_import_fn = self.client.import_bits
        self.api.forward_roaring_fn = (
            lambda uri, index, field, shard, views, clear:
            self.client.import_roaring(uri, index, field, shard, views,
                                       clear=clear, remote=True))
        self.api.probe_peer_fn = (
            lambda uri: bool(self.client.status(uri,
                                                timeout=PEER_TIMEOUT_S)))
        ex.announce_shard_fn = self._announce_shard_bounded
        self._bcast_thread = threading.Thread(
            target=self._bcast_worker, name="pilosa-torch-bcast",
            daemon=True)
        self._bcast_thread.start()
        self.telemetry.start()
        if self.cluster_hosts:
            self.broadcast({"type": "node-state", "id": self.node_id,
                            "state": "READY"})
        return self

    @property
    def uri(self) -> str:
        return self.http.uri

    def close(self) -> None:
        self.closed = True
        if self._member_timer is not None:
            self._member_timer.cancel()
        self._bcast_queue.put(None)
        self.telemetry.close()
        if self.http is not None:
            self.http.close()
            self.http = None
        if self.executor is not None:
            self.executor.shutdown()
        if self.holder is not None:
            self.holder.close()
        if self.translate is not None:
            self.translate.close()
            self.translate = None

    # -- membership (a static cluster's refresh, :758-800) -----------------

    def _schedule_membership_refresh(self) -> None:
        if self.closed:
            return
        self._member_timer = threading.Timer(self.membership_interval,
                                             self._membership_tick)
        self._member_timer.daemon = True
        self._member_timer.start()

    def _membership_tick(self) -> None:
        try:
            self.refresh_membership()
        finally:
            self._schedule_membership_refresh()

    def refresh_membership(self) -> None:
        """Merge the node lists of every configured host."""
        http = self.http  # None once closed
        if not self.cluster_hosts or self.closed or http is None:
            return
        reports = self._fetch_peer_nodes(http.uri)
        self._apply_membership(reports, http.uri)

    def _fetch_peer_nodes(self, my_uri: str) -> list:
        reports: list = []
        for huri in self.cluster_hosts:
            if huri == my_uri:
                continue
            try:
                reports.extend(self.client.nodes(
                    huri, timeout=PEER_TIMEOUT_S) or [])
            except (ClientError, ValueError):
                pass  # not up yet: the next tick asks again
        return reports

    def _apply_membership(self, reports: list, my_uri: str) -> None:
        nodes = {n.id: n for n in self.cluster.nodes}
        nodes[self.node_id] = Node(id=self.node_id, uri=my_uri)
        for nd in reports:
            if nd["id"] not in nodes:
                nodes[nd["id"]] = Node.from_dict(nd)
            elif nd.get("uri") and nd["id"] != self.node_id:
                # a restarted peer may come back on another port
                nodes[nd["id"]].uri = nd["uri"]
        self.cluster.set_static(list(nodes.values()))
        self.cluster.elect_coordinator()

    # -- the cluster's messages (:1472) ------------------------------------

    def receive_message(self, msg: dict) -> None:
        mtype = msg.get("type")
        if mtype == "create-index":
            if self.holder.index(msg["index"]) is None:
                self.holder.create_index(
                    msg["index"], keys=msg.get("keys", False),
                    track_existence=msg.get("trackExistence", True))
        elif mtype == "delete-index":
            if self.holder.index(msg["index"]) is not None:
                self.holder.delete_index(msg["index"])
                self.executor.clear_caches()
        elif mtype == "create-field":
            idx = self.holder.index(msg["index"])
            if idx is not None and idx.field(msg["field"]) is None:
                idx.create_field(msg["field"],
                                 FieldOptions(**msg.get("options", {})))
        elif mtype == "delete-field":
            idx = self.holder.index(msg["index"])
            if idx is not None and idx.field(msg["field"]) is not None:
                idx.delete_field(msg["field"])
                self.executor.drop_field(msg["index"], msg["field"])
        elif mtype == "create-shard":
            idx = self.holder.index(msg["index"])
            f = idx.field(msg["field"]) if idx is not None else None
            if f is not None:
                f.add_available_shards([int(msg["shard"])], quiet=True)
        elif mtype == "set-coordinator":
            if msg.get("id"):
                self.cluster.adopt_coordinator(msg["id"])
        elif mtype == "node-state":
            # a peer (re)started: learn it now rather than at the next
            # membership tick
            if msg.get("id") and self.cluster.node_by_id(msg["id"]) is None:
                self.refresh_membership()
        else:
            raise ValueError(f"unknown cluster message type: {mtype}")

    def _on_shard_added(self, index_name: str, field_name: str,
                        shard: int) -> None:
        """A field newly holds a shard: tell every peer, off the write's
        thread (:1553)."""
        self.broadcast_async({"type": "create-shard", "index": index_name,
                              "field": field_name, "shard": shard})

    def _peer_uris(self) -> list:
        return [n.uri for n in self.cluster.nodes
                if n.id != self.node_id and n.uri
                and not self.cluster.is_down(n.id)]

    def _send_quiet(self, uri: str, msg: dict) -> None:
        try:
            self.client.send_message(uri, msg)
        except ClientError:
            pass  # the peer learns it at its next restart

    def broadcast(self, msg: dict) -> None:
        """To every peer at once, waiting for all (:1569); a peer that
        fails is skipped."""
        threads = [threading.Thread(target=self._send_quiet, args=(u, msg),
                                    daemon=True)
                   for u in self._peer_uris()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def _announce_shard_bounded(self, iname: str, fname: str,
                                shard: int) -> None:
        """create-shard to every peer before a shard-creating Set is
        acknowledged, waiting at most ANNOUNCE_SHARD_BUDGET_S (:1604)."""
        msg = {"type": "create-shard", "index": iname, "field": fname,
               "shard": shard}
        threads = [threading.Thread(target=self._send_quiet, args=(u, msg),
                                    daemon=True)
                   for u in self._peer_uris()]
        for t in threads:
            t.start()
        deadline = time.monotonic() + self.ANNOUNCE_SHARD_BUDGET_S
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))

    def broadcast_async(self, msg: dict) -> None:
        """Queue a message for every peer and return (:1631)."""
        if not self.closed:
            self._bcast_queue.put(msg)

    def _bcast_worker(self) -> None:
        """One sender thread and queue per peer, so a hung peer holds up
        only its own messages (:1642-1680)."""
        peer_queues: dict[str, queue.Queue] = {}

        def peer_sender(uri: str, q: queue.Queue) -> None:
            while True:
                m = q.get()
                if m is None:
                    return
                try:
                    self.client.send_message(uri, m)
                except ClientError:
                    if not self.closed:
                        time.sleep(0.2)  # one retry
                        self._send_quiet(uri, m)

        while True:
            msg = self._bcast_queue.get()
            if msg is None:
                for q in peer_queues.values():
                    q.put(None)
                return
            member = {n.uri for n in self.cluster.nodes
                      if n.id != self.node_id and n.uri}
            for uri in [u for u in peer_queues if u not in member]:
                peer_queues.pop(uri).put(None)
            for uri in self._peer_uris():
                q = peer_queues.get(uri)
                if q is None:
                    q = peer_queues[uri] = queue.Queue()
                    threading.Thread(target=peer_sender, args=(uri, q),
                                     name="pilosa-torch-bcast-peer",
                                     daemon=True).start()
                if q.qsize() < self.BCAST_PEER_QUEUE_MAX:
                    q.put(msg)
                else:
                    self._bcast_dropped += 1

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
