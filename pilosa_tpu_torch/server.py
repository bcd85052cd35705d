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

Liveness and healing (:640-660, :800-1100, :1263-1420, :2831-3100):
every membership tick probes each peer's /status (_probe_peers);
liveness_threshold failures in a row, unless a peer that can still reach
it vouches for it through /internal/probe, mark it down, and
REVIVE_THRESHOLD successes mark it up. A write then skips a down replica
and appends a durable hint for it (storage/hints.py, <data_dir>/.hints;
hint_max_bytes, hint_max_age). When a peer announces READY, a background
heal, one at a time per peer, pushes it the schema (schema-sync), replays
its hints and tells it so (hints-replayed); only when hints were dropped
does a block sync with it follow, once its read fence has lifted
(_on_node_return). A node that opens with data in a cluster read-fences
its shards (_arm_read_fence) until a block-checksum check against a live
replica lifts each (_verify_fence_pass), or rejoin_fence_timeout expires.
A shard whose blocks differ stays fenced, unmerged, until every live peer
has sent hints-replayed, and is then healed by a block sync first. With
anti_entropy_interval > 0, every interval (times 1 +- jitter) a scrub
pass (none while this node's read fence is armed: the fence check
compares every fenced fragment already; the JAX package scrubs beside
it) rebuilds quarantined fragments from a replica (repair_quarantined)
and merges divergent blocks by majority of the configured replicas, union
when one of them does not vote (sync_holder; pace seconds between
fragments, max_blocks blocks per fragment); a peer whose own read fence
is armed is left out of it. A block is merged by the periodic pass only
when the pass before saw the same divergence (the same local and peer
checksums).

These orders depart from the JAX package, which merges at first sight,
syncs a returning peer before telling it its hints are in, and heals on
READY only a peer it had marked down: with two replicas a merge is a
union, so a bit that a stale copy still holds would come back after an
acknowledged Clear, whether the Clear is a write in flight between the
replicas or a hint not yet replayed to a returning node. The event
journal's calls of the JAX code are left out (the port has no journal).

Not served yet: gossip, this node's own drain, resize, QoS and the
/cluster/* federation.

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

import io
import os
import queue
import random
import sys
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.constants import SHARD_WIDTH
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
from pilosa_tpu_torch.storage.hints import HintStore
from pilosa_tpu_torch.storage.roaring import Bitmap
from pilosa_tpu_torch.utils import telemetry as _telemetry
from pilosa_tpu_torch.utils.cluster_translate import ClusterTranslator
from pilosa_tpu_torch.utils.stats import StatsClient
from pilosa_tpu_torch.utils.tracing import Tracer
from pilosa_tpu_torch.utils.translate import TranslateStore


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


def _log(msg: str) -> None:
    print(f"pilosa-tpu-torch: {msg}", file=sys.stderr, flush=True)


class Server:
    # the longest a shard-creating Set waits for its announcement
    ANNOUNCE_SHARD_BUDGET_S = 0.5
    # a peer's async queue bound: past it messages are dropped
    BCAST_PEER_QUEUE_MAX = 1024
    # good probes in a row that mark a down peer up (one lucky probe of a
    # struggling peer must not flap it back into placement)
    REVIVE_THRESHOLD = 2
    # live peers asked to vouch for a suspect before it is marked down
    INDIRECT_PROBES = 2
    # attribute blocks per diff request of anti-entropy's attribute pull
    ATTR_SYNC_PAGE = 512
    # fenced shards checked at once (each check is an RPC a fragment)
    FENCE_WORKERS = 8

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
                 ici_serving: str = "auto",
                 liveness_threshold: int = 3,
                 probe_timeout: float = 2.0,
                 hint_max_bytes: int = 64 << 20,
                 hint_max_age: float = 3600.0,
                 anti_entropy_interval: float = 0.0,
                 anti_entropy_jitter: float = 0.25,
                 anti_entropy_pace: float = 0.0,
                 anti_entropy_max_blocks: int = 0):
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
        if not 0.0 <= anti_entropy_jitter < 1.0:
            raise ValueError(
                f"invalid [anti-entropy] jitter {anti_entropy_jitter!r} "
                "(a fraction: expected 0 <= jitter < 1)")
        if anti_entropy_pace < 0 or anti_entropy_max_blocks < 0:
            raise ValueError("[anti-entropy] pace and max-blocks must be >= 0")
        if hint_max_age < 0:
            raise ValueError("[cluster] hint-max-age must be >= 0")
        if liveness_threshold < 1:
            raise ValueError("[cluster] liveness-threshold must be >= 1")
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
        self.liveness_threshold = liveness_threshold
        self.probe_timeout = probe_timeout
        self.hint_max_bytes = hint_max_bytes
        self.hint_max_age = hint_max_age
        self.anti_entropy_interval = anti_entropy_interval
        self.anti_entropy_jitter = anti_entropy_jitter
        self.anti_entropy_pace = anti_entropy_pace
        self.anti_entropy_max_blocks = anti_entropy_max_blocks
        # seconds an unverified read fence may last before it lifts loudly
        self.rejoin_fence_timeout = 120.0
        self.hints: Optional[HintStore] = None
        # consecutive failed / (for a down peer) good probes per peer
        self._probe_failures: dict[str, int] = {}
        self._probe_successes: dict[str, int] = {}
        # peers with a return-heal in flight (one at a time per peer)
        self._return_heals: set[str] = set()
        # peers whose hints-replayed reached this node since it opened, and
        # the fenced shards whose blocks differed before every live peer's
        # had
        self._hints_in: set[str] = set()
        self._fence_diverged: set = set()
        self._return_lock = threading.Lock()
        self._fence_thread: Optional[threading.Thread] = None
        self._fence_wake = threading.Event()
        self._ae_timer: Optional[threading.Timer] = None
        self._scrub_lock = threading.Lock()
        # (index, field, view, shard, block) -> the divergence the last
        # periodic pass saw there: (local checksum, peer checksums)
        self._ae_seen: dict = {}
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
        for d in self.holder.damaged_fragments():
            frag = f"{d['index']}/{d['field']}/{d['view']}/{d['shard']}"
            if d["quarantinePath"]:
                _log(f"fragment {frag} failed its integrity check "
                     f"({d['corruptionError']}): quarantined to "
                     f"{d['quarantinePath']}, reopened empty; the scrubber "
                     "rebuilds it from a replica")
            if d["walTruncatedBytes"]:
                _log(f"fragment {frag} had a torn WAL tail "
                     f"({d['walTruncateError']}): truncated "
                     f"{d['walTruncatedBytes']} unacknowledged bytes")
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
        # hints reach the kernel at append, as the WAL's records do
        self.hints = HintStore(os.path.join(self.data_dir, ".hints"),
                               max_bytes=self.hint_max_bytes,
                               max_age=self.hint_max_age, stats=self.stats)
        ex.hints = self.hints
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
            lambda uri: bool(self.client.status(
                uri, timeout=self.probe_timeout)))
        ex.announce_shard_fn = self._announce_shard_bounded
        self._bcast_thread = threading.Thread(
            target=self._bcast_worker, name="pilosa-torch-bcast",
            daemon=True)
        self._bcast_thread.start()
        if self.anti_entropy_interval > 0:
            self._schedule_anti_entropy()
        self.telemetry.start()
        # the rejoin: fence what may have missed writes while this node was
        # away (before the first request is served: the listener is bound
        # and the peers known), then announce the return so peers replay
        # their hints now
        self._arm_read_fence()
        self.http.serve_background()
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
        if self._ae_timer is not None:
            self._ae_timer.cancel()
        self._fence_wake.set()
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
            self._probe_peers()
            # a replay that failed midway keeps its log: re-run the heal
            # of every live peer that still has hints
            self._retry_pending_hints()
        except Exception as e:  # noqa: BLE001 — the tick must go on
            _log(f"membership tick failed: {type(e).__name__}: {e}")
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
                    huri, timeout=self.probe_timeout) or [])
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

    # -- liveness probing (:800-977) ----------------------------------------

    def _probe_peers(self) -> None:
        """One probe of every peer's /status, all at once: after
        liveness_threshold failures in a row a peer is marked down, unless
        a live peer vouches for it (_indirect_confirms_alive); a down peer
        that answers REVIVE_THRESHOLD times in a row is marked up and
        healed (_on_node_return), as is a draining one that reports
        READY."""
        if self.closed:
            return
        peers = [n for n in list(self.cluster.nodes)
                 if n.id != self.node_id and n.uri]
        ids = {n.id for n in peers}
        for table in (self._probe_failures, self._probe_successes):
            for stale in set(table) - ids:
                del table[stale]
        if not peers:
            return
        results: dict[str, bool] = {}
        states: dict[str, str] = {}

        def probe(node) -> None:
            try:
                st = self.client.status(node.uri, timeout=self.probe_timeout)
                states[node.id] = st.get("nodeState", "")
                results[node.id] = True
            except Exception:  # noqa: BLE001 — any failure: not alive
                results[node.id] = False

        threads = [threading.Thread(target=probe, args=(n,), daemon=True)
                   for n in peers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.probe_timeout + 1.0)
        suspects = []
        for node in peers:
            if results.get(node.id, False):
                self._probe_failures.pop(node.id, None)
                if self.cluster.is_down(node.id):
                    ok = self._probe_successes.get(node.id, 0) + 1
                    if ok < self.REVIVE_THRESHOLD:
                        self._probe_successes[node.id] = ok
                        continue
                    self._probe_successes.pop(node.id, None)
                    _log(f"liveness: node {node.id} ({node.uri}) back up")
                    self.cluster.mark_up(node.id)
                    self._on_node_return(node)
                elif (self.cluster.is_draining(node.id)
                      and states.get(node.id) == "READY"):
                    self.cluster.clear_draining(node.id)
                    self._on_node_return(node)
            else:
                self._probe_successes.pop(node.id, None)
                n = self._probe_failures.get(node.id, 0) + 1
                self._probe_failures[node.id] = n
                if (n >= self.liveness_threshold
                        and not self.cluster.is_down(node.id)):
                    suspects.append(node)
        if not suspects:
            return
        # the suspects are checked through other peers, all at once: a
        # broken link from here must not evict a node the others reach
        refuted: dict[str, bool] = {}
        checkers = [threading.Thread(
            target=lambda nd=node: refuted.__setitem__(
                nd.id, self._indirect_confirms_alive(nd, peers, results)),
            daemon=True) for node in suspects]
        for t in checkers:
            t.start()
        for t in checkers:
            t.join(3 * self.probe_timeout + 3.0)
        for node in suspects:
            if refuted.get(node.id):
                _log(f"liveness: node {node.id} suspected but refuted by an "
                     "indirect probe (a link problem, not a death)")
                self._probe_failures.pop(node.id, None)
                self.stats.count("liveness/suspect_refuted")
                continue
            _log(f"liveness: node {node.id} ({node.uri}) failed "
                 f"{self._probe_failures.get(node.id, 0)} probes, marking "
                 "it down")
            self.cluster.mark_down(node.id)
            self.stats.count("liveness/node_down")

    def _indirect_confirms_alive(self, target, peers, results) -> bool:
        """Whether any of INDIRECT_PROBES live peers reaches target (asked
        all at once; the first vouch settles it)."""
        helpers = [p for p in peers
                   if p.id != target.id and results.get(p.id)
                   and not self.cluster.is_down(p.id)][:self.INDIRECT_PROBES]
        if not helpers:
            return False
        outer = 2 * self.probe_timeout + 1.0
        vouched = threading.Event()
        votes: dict[str, bool] = {}
        done = threading.Event()

        def ask(helper) -> None:
            try:
                votes[helper.id] = self.client.probe_indirect(
                    helper.uri, target.uri, timeout=outer)
            except Exception:  # noqa: BLE001 — an unreachable helper
                votes[helper.id] = False
            if votes[helper.id]:
                vouched.set()
            if len(votes) == len(helpers):
                done.set()

        for h in helpers:
            threading.Thread(target=ask, args=(h,), daemon=True).start()
        deadline = time.monotonic() + outer + 1.0
        while time.monotonic() < deadline:
            if vouched.wait(0.05) or done.is_set():
                break
        return vouched.is_set() or any(votes.values())

    # -- the return heal (:979-1110, :1389-1420) -----------------------------

    def _handle_node_state(self, msg: dict) -> None:
        """DRAINING routes around the peer at once; READY is its return:
        its marks clear and its heal runs if it was away."""
        nid, state = msg.get("id"), msg.get("state")
        if not nid or nid == self.node_id:
            return
        node = self.cluster.node_by_id(nid)
        if state == "DRAINING":
            if node is not None and not self.cluster.is_draining(nid):
                _log(f"peer {nid} is draining: routing around it")
                self.cluster.mark_draining(nid)
                self.stats.count("drain/peerDraining")
        elif state == "READY":
            was_away = (self.cluster.is_down(nid)
                        or self.cluster.is_draining(nid))
            self.cluster.mark_up(nid)
            self._probe_failures.pop(nid, None)
            self._probe_successes.pop(nid, None)
            if node is not None:
                # a peer that restarted before it was marked down waits
                # for this node's hints-replayed too
                if was_away:
                    _log(f"peer {nid} rejoined: replaying its hints")
                self._on_node_return(node)

    def _on_node_return(self, node) -> None:
        """Heal a peer that (re)opened or was away, on a thread of its
        own, one heal at a time per peer: push it the schema and available
        shards it may have missed (schema-sync) and the explicit
        coordinator claim, replay its hints, and send hints-replayed, which
        lets the peer's fence check merge what still differs. When hints
        were dropped, a block sync of the shards both hold follows once
        the peer's read fence has lifted: before that the peer may still
        miss another node's hints, and the sync's union would carry its
        stale bits back."""
        with self._return_lock:
            if node.id in self._return_heals:
                return
            self._return_heals.add(node.id)

        def heal() -> None:
            try:
                try:
                    self.client.send_message(node.uri, {
                        "type": "schema-sync",
                        "schema": self.holder.schema(),
                        "availableShards": {
                            iname: {fname: [int(x) for x in
                                            f.available_shards.positions()]
                                    for fname, f in list(idx.fields.items())}
                            for iname, idx in
                            list(self.holder.indexes.items())}})
                except ClientError as e:
                    _log(f"schema re-sync to {node.id} failed: {e}")
                claim = self.cluster._explicit_claim
                if claim:
                    self._send_quiet(node.uri, {"type": "set-coordinator",
                                                "id": claim})
                try:
                    _r, _d, complete = self.replay_hints(node)
                except Exception as e:  # noqa: BLE001 — fall back to sync
                    complete = False
                    _log(f"hint replay to {node.id} failed: {e}")
                self._send_quiet(node.uri, {
                    "type": "hints-replayed", "target": node.id,
                    "from": self.node_id, "complete": complete})
                if not complete and self._await_unfenced(node):
                    try:
                        self._sync_with_node(node.id)
                    except Exception as e:  # noqa: BLE001 — best effort
                        _log(f"post-return sync with {node.id} failed: {e}")
            finally:
                with self._return_lock:
                    self._return_heals.discard(node.id)

        threading.Thread(target=heal, name="pilosa-torch-heal",
                         daemon=True).start()

    def _await_unfenced(self, node) -> bool:
        """Whether node's read fence lifted within rejoin_fence_timeout
        (and a little more: its own fence expires then)."""
        deadline = time.monotonic() + self.rejoin_fence_timeout + 5.0
        while not self.closed and time.monotonic() < deadline:
            if not self._peer_fenced(node):
                return True
            time.sleep(0.5)
        return False

    def _peer_fenced(self, node) -> bool:
        """Whether node's rejoin read fence holds a shard (its
        /debug/vars readFence); an unreachable node counts as fenced. The
        client's own timeout, as for the walk's other RPCs: a busy node
        that answers late is not fenced, and leaving it out of a pass
        would only put its merges one pass later."""
        try:
            return self.client.fenced_shards(node.uri) > 0
        except ClientError:
            return True

    def _sync_with_node(self, node_id: str) -> int:
        """A block sync of the fragments this node shares with one peer."""
        merged = 0
        for iname, fname, vname, shard, _frag in \
                list(self.holder.walk_fragments()):
            owners = {n.id for n in self.cluster.shard_nodes(iname, shard)}
            if self.node_id in owners and node_id in owners:
                merged += self._sync_fragment(iname, fname, vname, shard)
        return merged

    def _retry_pending_hints(self) -> None:
        """The heal of every live peer that still has a hint log."""
        if not self.hints.pending_targets():
            return
        for n in list(self.cluster.nodes):
            if (n.id != self.node_id and n.uri
                    and not self.cluster.is_unavailable(n.id)
                    and self.hints.pending(n.id)):
                self._on_node_return(n)

    def replay_hints(self, node) -> tuple[int, int, bool]:
        """node's hints, in order, as the remote writes they were ->
        (replayed, dropped, complete) (HintStore.replay)."""
        def apply(doc: dict) -> None:
            self.client.query_proto(node.uri, doc["index"], doc["pql"],
                                    shards=doc.get("shards"), remote=True)

        replayed, dropped, complete = self.hints.replay(node.id, apply)
        if replayed or dropped:
            _log(f"hints: replayed {replayed} to {node.id}, {dropped} "
                 "dropped" + ("" if complete else
                              "; anti-entropy finishes the heal"))
        return replayed, dropped, complete

    def _apply_schema(self, schema: list) -> None:
        """Create the indexes and fields of schema dicts this node lacks."""
        for idx_d in schema:
            opts = idx_d.get("options", {})
            idx = self.holder.index(idx_d["name"])
            if idx is None:
                try:
                    idx = self.holder.create_index(
                        idx_d["name"], keys=opts.get("keys", False),
                        track_existence=opts.get("trackExistence", True))
                except ValueError:  # created meanwhile
                    idx = self.holder.index(idx_d["name"])
            for fd in idx_d.get("fields", []):
                if idx.field(fd["name"]) is not None:
                    continue
                o = fd.get("options", {})
                try:
                    idx.create_field(fd["name"], FieldOptions(
                        type=o.get("type", "set"),
                        cache_type=o.get("cacheType", "ranked"),
                        cache_size=o.get("cacheSize", 50000),
                        min=o.get("min", 0), max=o.get("max", 0),
                        time_quantum=o.get("timeQuantum", ""),
                        keys=o.get("keys", False)))
                except ValueError:
                    pass  # created meanwhile

    # -- the rejoin read fence (:1263-1387) ----------------------------------

    def _arm_read_fence(self) -> None:
        """Fence every local (index, shard) when this node opens with data
        in a cluster: it may have missed writes while it was away."""
        if not self.cluster_hosts:
            return
        keys = {(iname, shard) for iname, _f, _v, shard, _frag
                in self.holder.walk_fragments()}
        if not keys:
            return
        n = self.executor.fence_reads(keys)
        if not n:
            return
        self.stats.count("readFence/fenced", n)
        _log(f"rejoin: read-fenced {n} shard(s) until their block "
             "checksums match a replica")
        self._start_fence_worker()

    def _start_fence_worker(self) -> None:
        self._fence_wake.set()
        t = self._fence_thread
        if t is not None and t.is_alive():
            return
        self._fence_thread = threading.Thread(
            target=self._fence_worker, name="pilosa-torch-fence", daemon=True)
        self._fence_thread.start()

    def _fence_worker(self) -> None:
        deadline = time.monotonic() + self.rejoin_fence_timeout
        ex = self.executor
        while not self.closed and ex.read_fence:
            try:
                self._verify_fence_pass()
            except Exception as e:  # noqa: BLE001 — retried next tick
                _log(f"rejoin: fence check failed: {e}")
            if not ex.read_fence:
                break
            if time.monotonic() >= deadline:
                # availability wins over a fence nothing can verify; the
                # scrubber stays the backstop
                with ex._fence_lock:
                    n = len(ex.read_fence)
                    ex.read_fence.clear()
                self.stats.count("readFence/expired", n)
                _log(f"rejoin: fence expired after "
                     f"{self.rejoin_fence_timeout:.0f} s with {n} shard(s) "
                     "unverified: serving local data")
                break
            self._fence_wake.wait(0.25)
            self._fence_wake.clear()

    def _verify_fence_pass(self) -> int:
        """One check of every fenced shard, FENCE_WORKERS shards at once:
        each local fragment's block checksums against a live replica's; a
        difference is healed by a block sync first. A shard lifts when all
        its fragments were checked; one with no reachable replica stays
        for the next pass. Returns the shards lifted."""
        ex = self.executor
        with ex._fence_lock:
            fence = sorted(ex.read_fence)
        if not fence:
            return 0
        with ThreadPoolExecutor(min(self.FENCE_WORKERS, len(fence))) as pool:
            return sum(pool.map(self._verify_fenced_shard, fence))

    def _verify_fenced_shard(self, key: tuple) -> int:
        """1 when the shard's fence lifted, else 0."""
        iname, shard = key
        ex = self.executor
        idx = self.holder.index(iname)
        if idx is None:
            ex.unfence_reads(key)
            return 1
        owners = self.cluster.shard_nodes(iname, shard)
        peers = [n for n in owners
                 if n.id != self.node_id and n.uri
                 and not self.cluster.is_down(n.id)]
        if not peers:
            if all(n.id == self.node_id for n in owners):
                ex.unfence_reads(key)  # no replica configured
                return 1
            return 0
        peer = peers[0]
        # live peers that may still hold hints for this node: a difference
        # then waits, since a union merge would carry a bit that a hinted
        # Clear has not reached yet back onto the replica
        awaited = any(n.id != self.node_id and n.uri
                      and not self.cluster.is_down(n.id)
                      and n.id not in self._hints_in
                      for n in self.cluster.nodes)
        if awaited and key in self._fence_diverged:
            return 0
        healed = False
        for fname, field in list(idx.fields.items()):
            for vname, view in list(field.views.items()):
                frag = view.fragment(shard)
                if frag is None:
                    continue
                try:
                    remote = {b["id"]: b["checksum"]
                              for b in self.client.fragment_blocks(
                                  peer.uri, iname, fname, vname, shard)}
                except ClientError as e:
                    if e.code != "fragment-not-found":
                        return 0  # unreachable: the next pass
                    remote = {}
                local = {b: c.hex() for b, c in frag.blocks()}
                if local != remote:
                    if awaited:
                        self._fence_diverged.add(key)
                        return 0
                    self._sync_fragment(iname, fname, vname, shard)
                    healed = True
        ex.unfence_reads(key)
        self.stats.count("readFence/verified")
        if healed:
            self.stats.count("readFence/healed")
        return 1

    # -- anti-entropy: scrub and repair (:2831-3100) -------------------------

    def _schedule_anti_entropy(self) -> None:
        if self.closed:
            return
        interval = self.anti_entropy_interval
        if self.anti_entropy_jitter > 0:
            # replicas that scrub at the same instant double the load
            interval *= 1.0 + random.uniform(-self.anti_entropy_jitter,
                                             self.anti_entropy_jitter)
        self._ae_timer = threading.Timer(max(interval, 0.01),
                                         self._anti_entropy_tick)
        self._ae_timer.daemon = True
        self._ae_timer.start()

    def _anti_entropy_tick(self) -> None:
        try:
            self.scrub_pass()
        except Exception as e:  # noqa: BLE001 — the next pass retries
            _log(f"anti-entropy: pass failed: {type(e).__name__}: {e}")
        finally:
            self._schedule_anti_entropy()

    def scrub_pass(self) -> int:
        """One pass: rebuild quarantined fragments from live replicas,
        then merge the blocks that differ from the replicas'. Returns the
        blocks merged. Skipped (no pass counted) while this node's read
        fence is armed: its check compares every fenced fragment with a
        replica already, and a pass beside it would compute the same
        checksums again on the same cores."""
        if self.executor.read_fence:
            return 0
        with self._scrub_lock:
            t0 = time.monotonic()
            rebuilt = self.repair_quarantined()
            merged = self.sync_holder()
            self.stats.count("antiEntropy/passes")
            if merged:
                self.stats.count("antiEntropy/blocksMerged", merged)
            if rebuilt:
                self.stats.count("antiEntropy/fragmentsRebuilt", rebuilt)
            self.stats.gauge("antiEntropy/lastPassSeconds",
                             time.monotonic() - t0)
            return merged

    def repair_quarantined(self) -> int:
        """Every quarantined fragment rebuilt from the first live replica
        that has it: its roaring bytes (retrieve_shard) unioned in
        (import_roaring snapshots, so the rebuild is durable before
        rebuilt_from is set). Returns the fragments rebuilt."""
        rebuilt = 0
        for iname, fname, vname, shard, frag in \
                list(self.holder.walk_fragments()):
            if not frag.needs_rebuild:
                continue
            for node in self.cluster.shard_nodes(iname, shard):
                if node.id == self.node_id or not node.uri \
                        or self.cluster.is_down(node.id):
                    continue
                try:
                    data = self.client.retrieve_shard(
                        node.uri, iname, fname, vname, shard)
                except ClientError:
                    continue  # no copy there, or unreachable: the next
                try:
                    frag.import_roaring(data)
                except (ValueError, OSError) as e:
                    _log(f"scrubber: rebuild of {iname}/{fname}/{vname}/"
                         f"{shard} from {node.id} failed: {e}")
                    continue
                self._refresh_rank(iname, fname, vname, shard)
                frag.rebuilt_from = node.id
                rebuilt += 1
                _log(f"scrubber: rebuilt quarantined fragment {iname}/"
                     f"{fname}/{vname}/{shard} from {node.id} "
                     f"({frag.bit_count()} bits; the damaged file stays at "
                     f"{frag.quarantine_path})")
                break
        return rebuilt

    def _refresh_rank(self, iname: str, fname: str, vname: str,
                      shard: int) -> None:
        idx = self.holder.index(iname)
        f = idx.field(fname) if idx is not None else None
        view = f.view(vname) if f is not None else None
        if view is not None:
            view.refresh_rank_cache(shard)

    def sync_holder(self) -> int:
        """One anti-entropy walk: the index's column attributes, each
        field's row attributes, then every fragment of a shard this node
        owns (pace seconds apart). A block is merged only when the
        previous walk saw the same divergence. Returns blocks merged."""
        merged = 0
        seen: dict = {}
        # a peer still in its rejoin read fence may miss hints: its fence
        # check merges its fragments once they are in
        fenced = {n.id for n in list(self.cluster.nodes)
                  if n.id != self.node_id and n.uri
                  and not self.cluster.is_down(n.id) and self._peer_fenced(n)}
        for iname, idx in list(self.holder.indexes.items()):
            merged += self._sync_attrs(
                idx.column_attrs,
                lambda uri, blocks, rng, i=iname: self.client.column_attr_diff(
                    uri, i, blocks, rng), fenced)
            for fname, field in list(idx.fields.items()):
                merged += self._sync_attrs(
                    field.row_attrs,
                    lambda uri, blocks, rng, i=iname, fn=fname:
                    self.client.row_attr_diff(uri, i, fn, blocks, rng),
                    fenced)
                for vname, view in list(field.views.items()):
                    for shard in view.shards():
                        if self.closed:
                            return merged
                        if not self.cluster.owns_shard(self.node_id, iname,
                                                       shard):
                            continue
                        merged += self._sync_fragment(iname, fname, vname,
                                                      shard, seen=seen,
                                                      skip=fenced)
                        if self.anti_entropy_pace > 0:
                            time.sleep(self.anti_entropy_pace)
        self._ae_seen = seen
        return merged

    def _sync_attrs(self, store, diff_fn, skip: set) -> int:
        """Pull the attribute blocks that differ from each live peer and
        merge them in, ATTR_SYNC_PAGE local blocks a request with a block
        range tiling the id space, so blocks only the peer holds are
        pulled once; the peers in `skip` are left out. Returns the peers
        something was merged from."""
        merged = 0

        def pages() -> list:
            blocks = [{"id": b, "checksum": chk.hex()}
                      for b, chk in store.blocks()]
            out, lo = [], 0
            for i in range(0, len(blocks), self.ATTR_SYNC_PAGE):
                chunk = blocks[i:i + self.ATTR_SYNC_PAGE]
                last = i + self.ATTR_SYNC_PAGE >= len(blocks)
                hi = None if last else int(chunk[-1]["id"]) + 1
                out.append((chunk, [lo, hi]))
                lo = hi
            return out or [([], [0, None])]

        for node in list(self.cluster.nodes):
            if node.id == self.node_id or not node.uri \
                    or self.cluster.is_down(node.id) or node.id in skip:
                continue
            got = False
            try:
                for chunk, rng in pages():
                    attrs = diff_fn(node.uri, chunk, rng)
                    if attrs:
                        store.set_bulk_attrs(attrs.items())
                        got = True
            except ClientError:
                pass  # the pages merged so far still count
            merged += int(got)
        return merged

    def _sync_fragment(self, iname: str, fname: str, vname: str, shard: int,
                       seen: Optional[dict] = None,
                       skip: set | frozenset = frozenset()) -> int:
        """A fragment's blocks merged with every reachable replica's at
        once (:3029-3100): each block whose checksums differ is voted by
        every replica (a missing block or fragment votes empty), with
        majority (configured replicas + 1) // 2 when every configured
        replica votes and union otherwise, so clears need the whole
        replica set's evidence. The sets and clears land here and go to
        each peer as roaring imports. With `seen` (the periodic walk) a
        block is merged only when self._ae_seen holds the same divergence
        from the walk before; every divergence met is put in `seen`. The
        peers in `skip` neither vote nor receive. Returns the blocks
        merged."""
        idx = self.holder.index(iname)
        f = idx.field(fname) if idx is not None else None
        view = f.view(vname) if f is not None else None
        frag = view.fragment(shard) if view is not None else None
        if frag is None:
            return 0
        peers = []  # (node, {block: checksum hex}, has the fragment)
        for node in self.cluster.shard_nodes(iname, shard):
            if node.id == self.node_id or not node.uri \
                    or self.cluster.is_down(node.id) or node.id in skip:
                continue
            try:
                remote = {b["id"]: b["checksum"]
                          for b in self.client.fragment_blocks(
                              node.uri, iname, fname, vname, shard)}
                has = True
            except ClientError as e:
                if e.code != "fragment-not-found":
                    continue  # unreachable, or the schema is gone there
                remote, has = {}, False
            peers.append((node, remote, has))
        if not peers:
            return 0
        configured = min(self.cluster.replica_n, len(self.cluster.nodes))
        majority_n = ((configured + 1) // 2
                      if len(peers) + 1 == configured else 1)
        local_blocks = dict(frag.blocks())
        all_blocks = set(local_blocks)
        for _, remote, _ in peers:
            all_blocks |= set(remote)
        merged = 0
        adopted = False
        changed_here = False
        sw = np.uint64(SHARD_WIDTH)
        for blk in sorted(all_blocks):
            if self.anti_entropy_max_blocks > 0 \
                    and merged >= self.anti_entropy_max_blocks:
                break  # the next pass goes on
            lc = local_blocks.get(blk)
            lhex = lc.hex() if lc is not None else ""
            if lc is not None and all(remote.get(blk) == lhex
                                      for _, remote, _ in peers):
                continue
            if seen is not None:
                key = (iname, fname, vname, shard, blk)
                sig = (lhex, tuple(remote.get(blk, "")
                                   for _, remote, _ in peers))
                seen[key] = sig
                if self._ae_seen.get(key) != sig:
                    continue  # not settled: maybe a write in flight
            # each distinct checksum is fetched once
            by_checksum: dict = {}
            if lc is not None:
                lr, lcols = frag.block_data(blk)
                by_checksum[lhex] = (lr.astype(np.uint64) * sw
                                     + lcols.astype(np.uint64))
            voters, positions = [], []
            fetch_failed = False
            for node, remote, has in peers:
                if not has or blk not in remote:
                    pos = np.empty(0, dtype=np.uint64)
                elif remote[blk] in by_checksum:
                    pos = by_checksum[remote[blk]]
                else:
                    try:
                        data = self.client.block_data(node.uri, iname, fname,
                                                      vname, shard, blk)
                    except ClientError as e:
                        if e.status != 404:
                            if majority_n > 1:
                                # a majority needs this vote: skip the block
                                fetch_failed = True
                                break
                            continue  # union: it drops out of this block
                        data = None  # the block went meanwhile
                    if data is None:
                        pos = np.empty(0, dtype=np.uint64)
                    else:
                        pos = (np.asarray(data.get("rowIDs", []),
                                          dtype=np.uint64) * sw
                               + np.asarray(data.get("columnIDs", []),
                                            dtype=np.uint64))
                        by_checksum[remote[blk]] = pos
                voters.append(node)
                positions.append(pos)
            if fetch_failed:
                continue
            n_sets, n_clears, deltas, durable = frag.merge_block_majority(
                blk, positions, majority_n=majority_n)
            changed_here |= bool(n_sets or n_clears)
            adopted |= not durable
            merged += 1
            for node, (peer_sets, peer_clears) in zip(voters, deltas):
                for delta, clear in ((peer_sets, False), (peer_clears, True)):
                    if not delta.size:
                        continue
                    bm = Bitmap()
                    bm.add_many(delta)
                    buf = io.BytesIO()
                    bm.write_to(buf)
                    try:
                        self.client.import_roaring(
                            node.uri, iname, fname, shard,
                            {vname: buf.getvalue()}, remote=True, clear=clear)
                    except ClientError:
                        pass
        if adopted:
            frag.snapshot()  # one snapshot for a large adoption
        if changed_here:
            self._refresh_rank(iname, fname, vname, shard)
        return merged

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
            self._handle_node_state(msg)
        elif mtype == "hints-replayed":
            # a peer's hints for this node are in: check the fence now
            if msg.get("target") == self.node_id:
                if msg.get("from"):
                    self._hints_in.add(msg["from"])
                self._fence_wake.set()
                if self.executor.read_fence:
                    self._start_fence_worker()
        elif mtype == "schema-sync":
            # a peer's push to this node after its return (:1537)
            self._apply_schema(msg.get("schema", []))
            for iname, fields in msg.get("availableShards", {}).items():
                idx = self.holder.index(iname)
                if idx is None:
                    continue
                for fname, shards in fields.items():
                    f = idx.field(fname)
                    if f is not None and shards:
                        f.add_available_shards([int(x) for x in shards],
                                               quiet=True)
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
