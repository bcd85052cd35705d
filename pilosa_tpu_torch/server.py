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
replicas or a hint not yet replayed to a returning node. So each event
of the journal fires where the port's state changes, under the JAX
event's name and fields: a fence.lifted of a shard that waited for the
peers' hints says so (awaitedHints, the port's own field).

Membership changes (:1681-2093, message types :1472-1550): a node
opened with join=True treats cluster_hosts as seeds, knocks on them
(request_join: node-join-request, forwarded to the coordinator) and
waits in STARTING, knocking again every membership tick, until the
coordinator's job admits it; POST /cluster/resize/remove-node asks for a
leave job (forwarded to the coordinator). The coordinator plans the job
(Cluster.plan_resize over the cluster-wide available shards), goes
RESIZING and tells every member (cluster-state), which refuses queries
and writes with 503 meanwhile, and sends each node its resize-instruction
with the schema and the available shards. A follower asks each donor for
the views holding a shard (/internal/fragment/views), unions each
view's roaring bytes (/internal/fragment/data) into its fragment and
rebuilds the rank cache, RESIZE_COPY_WORKERS shards at once, then
acknowledges (resize-complete). The last acknowledgement ends the job:
the membership changes, the .topology file is written, the new topology
goes to every node and to a departed one (topology, with the removed
ids, which tombstone a node so no membership merge brings it back; a
node that finds itself removed becomes a node of its own), each node
drops the fragments it no longer owns (clean_holder) with the
executor's leaves over them, and the next queued join or leave starts
(_drain_pending_resizes). A failed instruction, an undeliverable one, a
resize_timeout watchdog or POST /cluster/resize/abort aborts the job and
un-gates every node. A leave with no more nodes than replicas removes
the node at once and serves DEGRADED.

This node's drain (:1117-1260; SIGTERM and POST /cluster/drain): new
external queries get 503 with X-Pilosa-Shed-Reason: draining, peers are
told (node-state DRAINING) and route around it, in-flight work and the
batchers' and the coalescer's queues empty (at most drain_timeout
seconds), the rank caches are saved and every fragment with WAL ops or
a volatile bulk load is snapshotted; /status then says nodeState
DRAINING until the process goes. abort_drain re-announces READY.

SWIM gossip (:697-757; parallel/gossip.py, with AES-GCM under
gossip_secret): with gossip_port set, gossip is the failure detector and
the HTTP probe loop is off. A member gossip declares dead is marked
down; one that comes alive is marked up and healed, or, unknown, admitted
to the membership from the HTTP URI its alive record carries (not while
a job runs, nor a removed node). A --join node knocks before gossip
opens, so the coordinator is RESIZING when gossip's alive record
arrives.

These differ from the JAX package: on entering RESIZING a node waits
(at most RESIZE_SETTLE_S) for its in-flight work routes to finish before
it answers the cluster-state message (the coordinator before it sends
the instructions), so a write acknowledged under the old state is in
the fragments a follower copies; at a join's last acknowledgement the
coordinator sends the joiner its topology before it changes its own
membership, so no member routes to the joiner while it is still
STARTING; every node, not only the coordinator, writes the .topology
file when it applies a topology and drops its hints for a removed node;
and a joining node arms no read fence.

QoS, usage accounting and SLOs (pilosa_tpu/server.py:332-355, :412-431,
:2140-2169, :2398-2446): the server builds the usage ledger
(usage_max_principals, usage_ring), the SLO tracker (an availability
objective at slo_availability_target unless 0, a latency objective per
class whose slo_<class>_latency_ms is set) and the QoS plane (the qos_*
arguments, the [qos] keys; mode "off" by default), wired to the executor,
the ledger and node_health(). node_health() is telemetry.health_score
over _health_inputs(): damaged and quarantined fragments (from the
sampler's last tick), the 5xx rate, the fan-out queue's saturation, the
drain, the read fence and the worst SLO; /status reports it and the
plane's healthRed shed reads it. The drain's sheds count in the plane.
The sampler ticks the ledger's ring and samples usage.*, slo.* and qos.*
gauges. walPoisoned is true while a fragment's WAL is poisoned (a torn
append that could not be rewound, storage/roaring.py), sampled as
wal.poisoned_fragments (:2249-2254, :2409-2416).

TLS and operations (:62-67, :153, :203-215, :441, :628-629): with
tls_certificate and tls_key the listener speaks HTTPS and the node's URI
is https://; tls_skip_verify gives the internal client an unverifying
context; metric_poll_interval samples the runtime monitor's gauges
(threads, memory/rss, garbage/*) and diagnostics_url with
diagnostics_interval phones home (utils/diagnostics.py). Background work
starts in a copy of the starting context (utils/threads.py), and the
anti-entropy walk evaluates the failpoint server.scrub.fragment per
fragment (:3045).

Limits and plain keys: max_writes_per_request (the top-level
max-writes-per-request; 0: none), wal_fsync ([storage] wal-fsync, "off"
or "always": every fragment fsyncs its WAL appends), ingest_batch_window
and ingest_max_batch ([ingest]: the IngestBatcher's admission window and
batch bound), query_history_size ([cluster]) and telemetry_ring
([metric]).

The event journal and the logger (utils/events.py, utils/logger.py;
pilosa_tpu/server.py:163-202): the node's HybridLogicalClock stamps every
event and rides on every internal RPC (net/client.py, both ways) and
gossip datagram; the EventJournal (events_ring, events_spool; the spool
at <data_dir>/events.spool.jsonl, reloaded at open) serves GET
/debug/events, and SIGQUIT writes it to <data_dir>/events.crash-<ts>.jsonl
(register_crash_dump at open, unregister at close). The events: node.start
and node.stop; wal.truncated and snapshot.quarantined at open;
peer.down and peer.up by probe and by gossip; peer.draining and
peer.rejoined; drain.start, drain.complete and drain.abort;
fence.armed, fence.lifted and fence.expired; hint.replay (and, in
storage/hints.py, hint.append and hint.drop); scrub.pass; resize.start,
resize.complete and resize.abort on the coordinator; topology.change
where a topology message changes this node's membership (as in the JAX
package, the coordinator records its own change as resize.complete);
health.transition on the sampler's tick; the QoS plane's and the
executor's own. cluster_events() merges every member's feed (GET
/cluster/events). The Logger (log_path, log_format, verbose; stderr
without a path) takes every log line at the JAX site's level, and its
warnf and errorf lines land in the journal's log lane. metric_service
and metric_host select the StatsClient (utils/stats.py
new_stats_client); profile_mode is the API's [cluster] profile.

The fleet view (pilosa_tpu/server.py:2448-2826): node_stats() is GET
/internal/stats; cluster_stats(), cluster_usage(), cluster_hbm(),
cluster_heat() and cluster_events() fetch every member's document at
once, each on a thread of its own, and merge them (GET /cluster/stats,
/cluster/usage, /cluster/hbm, /cluster/heat, /cluster/events). A peer
marked down gets no RPC, a 404 peer is "legacy" and any other failure is
yellow in the stats and "error" elsewhere; none fails the merge, and no
join waits longer than max(2, probe_timeout) + 1 seconds.

Trace export (:156-167, :361-382): tracing_endpoint (the [tracing]
agent-host-port) ships the recording tracer's spans through a
SpanExporter under tracing_sampler_type and tracing_sampler_param;
trace_export ("off", "file" or "http", the [metric] trace-export keys)
sets up a TraceExporter that the API gives every finished profile tree
of a query this node coordinated. close() flushes both.

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
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from pilosa_tpu_torch import qos as _qos
from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.models.field import FieldOptions
from pilosa_tpu_torch.net.client import ClientError, InternalClient
from pilosa_tpu_torch.net.http_server import Handler, HTTPServer
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel.cluster import (
    EVENT_LEAVE,
    STATE_RESIZING,
    STATE_STARTING,
    Cluster,
    Node,
    ResizeJob,
)
from pilosa_tpu_torch.parallel.residency import (
    DEFAULT_RUN_THRESHOLD,
    DEFAULT_SPARSE_THRESHOLD,
    PlanCache,
)
from pilosa_tpu_torch.state import open_holder
from pilosa_tpu_torch.storage.hints import HintStore
from pilosa_tpu_torch.storage.roaring import Bitmap
from pilosa_tpu_torch.utils import accounting as _accounting
from pilosa_tpu_torch.utils import events as _events
from pilosa_tpu_torch.utils import heat as _heat
from pilosa_tpu_torch.utils import telemetry as _telemetry
from pilosa_tpu_torch.utils import threads as _threads
from pilosa_tpu_torch.utils import failpoints
from pilosa_tpu_torch.utils.profile import QueryHistory
from pilosa_tpu_torch.utils.cluster_translate import ClusterTranslator
from pilosa_tpu_torch.utils.diagnostics import (
    DiagnosticsCollector,
    RuntimeMonitor,
)
from pilosa_tpu_torch.utils.logger import Logger
from pilosa_tpu_torch.utils.stats import new_stats_client
from pilosa_tpu_torch.utils.tracing import SpanExporter, TraceExporter, Tracer
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
    # shards a resize follower copies at once (two RPCs each)
    RESIZE_COPY_WORKERS = 8
    # the longest a node entering RESIZING waits for its in-flight work
    RESIZE_SETTLE_S = 10.0

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
                 anti_entropy_max_blocks: int = 0,
                 join: bool = False,
                 resize_timeout: float = 120.0,
                 drain_timeout: float = 30.0,
                 gossip_port: Optional[int] = None,
                 gossip_seeds: Optional[list] = None,
                 gossip_config=None,
                 gossip_secret: str = "",
                 max_writes_per_request: int = 5000,
                 wal_fsync: str = "off",
                 ingest_batch_window: float = 0.0,
                 ingest_max_batch: int = 4096,
                 query_history_size: int = 100,
                 telemetry_ring: int = 720,
                 usage_max_principals: int = 256,
                 usage_ring: int = 360,
                 slo_read_latency_ms: float = 0.0,
                 slo_count_latency_ms: float = 0.0,
                 slo_topn_latency_ms: float = 0.0,
                 slo_groupby_latency_ms: float = 0.0,
                 slo_latency_target: float = 0.99,
                 slo_availability_target: float = 0.999,
                 slo_burn_yellow: float = 6.0,
                 slo_burn_red: float = 14.4,
                 slo_window_short: float = 300.0,
                 slo_window_long: float = 3600.0,
                 qos_mode: str = "off",
                 qos_default_priority: str = "interactive",
                 qos_default_deadline: float = 0.0,
                 qos_queries_per_s: float = 0.0,
                 qos_device_ms_per_s: float = 0.0,
                 qos_bytes_per_s: float = 0.0,
                 qos_burst: float = 2.0,
                 qos_max_principals: int = 256,
                 qos_principals: Optional[dict] = None,
                 events_ring: int = 2048,
                 events_spool: int = 0,
                 metric_service: str = "expvar",
                 metric_host: str = "127.0.0.1:8125",
                 profile_mode: str = "auto",
                 log_path: str = "",
                 log_format: str = "plain",
                 verbose: bool = False,
                 trace_export: str = "off",
                 trace_export_path: str = "",
                 trace_export_endpoint: str = "",
                 trace_export_format: str = "jaeger",
                 trace_export_sample: float = 1.0,
                 tracing_sampler_type: str = "off",
                 tracing_sampler_param: float = 0.0,
                 tracing_endpoint: str = "",
                 tls_certificate: str = "",
                 tls_key: str = "",
                 tls_skip_verify: bool = False,
                 metric_poll_interval: float = 0.0,
                 diagnostics_url: str = "",
                 diagnostics_interval: float = 0.0):
        if wal_fsync not in ("off", "always"):
            raise ValueError(f"invalid [storage] wal-fsync {wal_fsync!r} "
                             "(expected off | always)")
        if ingest_batch_window < 0:
            raise ValueError(
                f"invalid [ingest] batch-window {ingest_batch_window!r} "
                "(expected >= 0)")
        if telemetry_ring < 1:
            raise ValueError(
                f"invalid [metric] telemetry-ring {telemetry_ring!r} "
                "(expected >= 1)")
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
        if hint_max_age < 0 or drain_timeout < 0:
            raise ValueError(
                "[cluster] hint-max-age and drain-timeout must be >= 0")
        if liveness_threshold < 1:
            raise ValueError("[cluster] liveness-threshold must be >= 1")
        if events_ring < 1:
            raise ValueError(
                f"invalid [metric] events-ring {events_ring!r} "
                "(expected >= 1)")
        if events_spool < 0:
            raise ValueError("[metric] events-spool must be >= 0")
        if profile_mode not in ("off", "auto", "on"):
            raise ValueError(
                f"invalid [cluster] profile mode {profile_mode!r} "
                "(expected off | auto | on)")
        if trace_export not in ("off", "file", "http"):
            raise ValueError(
                f"invalid [metric] trace-export {trace_export!r} "
                "(expected off | file | http)")
        # Logger validates the format; log_path appends there instead of
        # stderr
        self.logger = Logger(verbose=verbose, fmt=log_format)
        if log_path:
            self.logger.out = open(log_path, "a")
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
        # membership changes: join=True knocks on cluster_hosts (seeds);
        # the coordinator queues joins and leaves that arrive while a job
        # runs; removed ids are tombstones no membership merge undoes
        self.join = join
        self.resize_timeout = resize_timeout
        self._resize_watchdog: Optional[threading.Timer] = None
        self._pending_resizes: list = []
        self._resize_lock = threading.Lock()
        self._removed_ids: set[str] = set()
        self._left = False  # this node was removed from the cluster
        # this node's drain
        self.drain_timeout = drain_timeout
        self.draining = False
        self.drained = False
        self._drain_lock = threading.Lock()
        self._drain_thread: Optional[threading.Thread] = None
        self._drain_abort = threading.Event()
        self._drain_info: dict = {}
        # SWIM gossip: on when gossip_port is set (0: an ephemeral port)
        self.gossip = None
        self._gossip_port = gossip_port
        self._gossip_seeds = list(gossip_seeds or [])
        self._gossip_config = gossip_config
        self._gossip_secret = gossip_secret
        self.host = host
        self.port = port
        self.device = device
        self.sparse_threshold = sparse_threshold
        self.run_threshold = run_threshold
        self.long_query_time = long_query_time
        self.eviction = eviction
        self.plan = plan
        self.plan_cache_bytes = plan_cache_bytes
        self.max_writes_per_request = max_writes_per_request
        self.wal_fsync = wal_fsync
        self.ingest_batch_window = ingest_batch_window
        self.ingest_max_batch = ingest_max_batch
        self.query_history_size = query_history_size
        self.profile_mode = profile_mode
        self.stats = new_stats_client(metric_service, metric_host)
        self.tls_certificate = tls_certificate
        self.tls_key = tls_key
        self.tls_skip_verify = tls_skip_verify
        # the process gauges every [metric] poll-interval, and the
        # diagnostics phone-home (off unless both url and interval are set)
        self.runtime_monitor = RuntimeMonitor(self.stats,
                                              metric_poll_interval)
        self.diagnostics_url = diagnostics_url
        self.diagnostics_interval = diagnostics_interval
        self.diagnostics: Optional[DiagnosticsCollector] = None
        # the clock of the event journal (made at open, once the node id is
        # known); here so that a test can skew its wall before open
        self.clock = _events.HybridLogicalClock()
        self.events_ring = events_ring
        self.events_spool = events_spool
        self.events: Optional[_events.EventJournal] = None
        self._last_health: Optional[str] = None
        # [tracing]: an agent endpoint ("host:port" or a URL) ships the
        # recording tracer's spans as the sampler allows
        if tracing_endpoint and "://" not in tracing_endpoint:
            tracing_endpoint = f"http://{tracing_endpoint}/api/traces"
        self.tracer = Tracer(
            exporter=(SpanExporter(tracing_endpoint)
                      if tracing_endpoint else None),
            sampler_type=tracing_sampler_type,
            sampler_param=tracing_sampler_param)
        # [metric] trace-export: finished cross-node profile trees (and,
        # when no [tracing] endpoint took the tracer, its spans) go as
        # Jaeger or OTLP batches to a spool (<data_dir>/trace-spool.jsonl
        # by default) or a collector
        self.trace_exporter: Optional[TraceExporter] = None
        if trace_export != "off":
            self.trace_exporter = TraceExporter(
                mode=trace_export,
                path=trace_export_path or os.path.join(
                    data_dir, "trace-spool.jsonl"),
                endpoint=trace_export_endpoint, fmt=trace_export_format,
                sample=trace_export_sample)
            if self.tracer.exporter is None:
                self.tracer.exporter = self.trace_exporter
                if tracing_sampler_type == "off":
                    self.tracer.sampler_type = "probabilistic"
                    self.tracer.sampler_param = trace_export_sample
        self.telemetry = _telemetry.TelemetrySampler(
            interval=telemetry_interval, ring_size=telemetry_ring,
            source=self.sample_gauges)
        # the usage ledger, the [slo] objectives and the QoS plane (its
        # executor set at open); the plane validates the [qos] keys here
        self.usage = _accounting.UsageLedger(
            max_principals=usage_max_principals, ring_size=usage_ring)
        objectives = []
        if slo_availability_target > 0:
            objectives.append(_accounting.Objective(
                "availability", None, None, slo_availability_target))
        for cls, ms in (("read", slo_read_latency_ms),
                        ("count", slo_count_latency_ms),
                        ("topn", slo_topn_latency_ms),
                        ("groupby", slo_groupby_latency_ms)):
            if ms > 0:
                objectives.append(_accounting.Objective(
                    f"{cls}-latency", cls, ms, slo_latency_target))
        self.slo = _accounting.SLOTracker(
            objectives, short_window=slo_window_short,
            long_window=slo_window_long, burn_yellow=slo_burn_yellow,
            burn_red=slo_burn_red)
        self.qos = _qos.QosPlane(
            mode=qos_mode, default_priority=qos_default_priority,
            default_deadline=qos_default_deadline,
            queries_per_s=qos_queries_per_s,
            device_ms_per_s=qos_device_ms_per_s,
            bytes_per_s=qos_bytes_per_s, burst_s=qos_burst,
            max_principals=qos_max_principals, principals=qos_principals,
            ledger=self.usage, health_fn=self.node_health,
            logger=self.logger.printf)
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

    def _schema_shards(self) -> dict:
        """{index: {field: [shards]}} over the cluster-wide available
        shards (not this node's fragments: a shard may live only on
        peers), which resize plans over."""
        return {iname: {fname: [int(s) for s in
                                f.available_shards.positions()]
                        for fname, f in list(idx.fields.items())}
                for iname, idx in list(self.holder.indexes.items())}

    def open(self) -> "Server":
        self.holder = open_holder(self.data_dir,
                                  wal_fsync=self.wal_fsync == "always")
        self.node_id = self.node_id or self._load_or_create_id()
        # the event journal (:171-202): its spool's tail is reloaded here,
        # so a restarted node's earlier events stay on the timeline
        self.events = _events.EventJournal(
            node_id=self.node_id, ring_size=self.events_ring,
            clock=self.clock,
            spool_path=(os.path.join(self.data_dir, "events.spool.jsonl")
                        if self.events_spool > 0 else ""),
            spool_max_bytes=self.events_spool, stats=self.stats)
        self.logger.journal = self.events
        _events.register_crash_dump(self.events, self.data_dir)
        for d in self.holder.damaged_fragments():
            frag = f"{d['index']}/{d['field']}/{d['view']}/{d['shard']}"
            if d["quarantinePath"]:
                self.logger.errorf(
                    f"fragment {frag} failed its integrity check "
                    f"({d['corruptionError']}): quarantined to "
                    f"{d['quarantinePath']}, reopened empty; the scrubber "
                    "rebuilds it from a replica")
                self.events.emit("snapshot.quarantined", fragment=frag,
                                 error=str(d["corruptionError"])[:200],
                                 quarantinePath=d["quarantinePath"])
            if d["walTruncatedBytes"]:
                self.logger.warnf(
                    f"fragment {frag} had a torn WAL tail "
                    f"({d['walTruncateError']}): truncated "
                    f"{d['walTruncatedBytes']} unacknowledged bytes")
                self.events.emit("wal.truncated", fragment=frag,
                                 bytes=int(d["walTruncatedBytes"]))
        self.cluster = Cluster(
            self.node_id, replica_n=self.replica_n,
            schema_fn=self._schema_shards,
            topology_path=os.path.join(self.data_dir, ".topology"))
        self.client = InternalClient(tls_skip_verify=self.tls_skip_verify)
        # every internal RPC carries this node's stamp; responses merge
        self.client.hlc = self.clock
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
                               max_age=self.hint_max_age, stats=self.stats,
                               logger=self.logger, journal=self.events)
        ex.hints = self.hints
        ex.journal = self.events
        ex.fanout_pool_size = self.fanout_pool_size
        ex.hedge_delay = self.hedge_delay
        ex.ici_mode = self.ici_serving
        if ex.coalescer is not None:
            ex.coalescer.admission_s = self.fanout_coalesce_window
            ex.coalescer.max_batch = max(1, self.fanout_coalesce_max_batch)
        ex.ingest.admission_s = float(self.ingest_batch_window)
        ex.ingest.max_batch = max(1, self.ingest_max_batch)
        self.qos.executor = ex
        self.qos.journal = self.events
        self.device_profiler = _telemetry.DeviceProfiler(
            ex.runner.device, kernel_names=kernels.DEVICE_KERNELS)
        self.api = API(self.holder, ex, self.cluster_translate,
                       cluster=self.cluster)
        self.api.long_query_time = self.long_query_time
        self.api.logger = self.logger
        self.api.profile_mode = self.profile_mode
        self.api.cluster_events_fn = self.cluster_events
        self.api.node_stats_fn = self.node_stats
        self.api.cluster_stats_fn = self.cluster_stats
        self.api.cluster_usage_fn = self.cluster_usage
        self.api.cluster_hbm_fn = self.cluster_hbm
        self.api.cluster_heat_fn = self.cluster_heat
        self.api.trace_exporter = self.trace_exporter
        self.api.query_history = QueryHistory(self.query_history_size)
        self.api.max_writes_per_request = self.max_writes_per_request
        self.api.usage_ledger = self.usage
        self.api.slo = self.slo
        self.api.qos_plane = self.qos
        self.api.health_fn = self.node_health
        self.handler = Handler(self.api, stats=self.stats,
                               telemetry=self.telemetry,
                               device_profiler=self.device_profiler,
                               cluster_message_fn=self.receive_message,
                               query_timeout=self.query_timeout,
                               qos_plane=self.qos, events=self.events)
        self.handler.gossip_status_fn = self.gossip_status
        self.http = HTTPServer(self.handler, self.host, self.port,
                               tls_certificate=self.tls_certificate,
                               tls_key=self.tls_key)
        self.api.uri = self.http.uri
        self.holder.set_shard_hook(self._on_shard_added)
        me = Node(id=self.node_id, uri=self.http.uri,
                  is_coordinator=not self.cluster_hosts)
        joining = self.join and bool(self.cluster_hosts)
        if joining:
            # a node being added: a cluster of itself, STARTING (its
            # queries refused) until a job admits it
            self.cluster.nodes = [me]
            if self.membership_interval > 0:
                self._schedule_membership_refresh()
        elif not self.cluster_hosts:
            self.cluster.set_static([me])
            self.cluster.coordinator_id = self.node_id
        else:
            self.cluster.set_static([me])
            # peers may not be up yet: start as a cluster of this node
            # and merge what they report, now and every tick
            self.refresh_membership()
            if self.membership_interval > 0:
                self._schedule_membership_refresh()
        self.api.broadcast_fn = self.broadcast
        self.api.resize_fn = self._resize_request
        self.api.abort_fn = self._abort_request
        self.api.drain_fn = self.request_drain
        self.api.drain_status_fn = self.drain_status
        self.api.node_state_fn = (
            lambda: "DRAINING" if self.draining else "READY")
        self.api.forward_import_fn = self.client.import_bits
        self.api.forward_roaring_fn = (
            lambda uri, index, field, shard, views, clear:
            self.client.import_roaring(uri, index, field, shard, views,
                                       clear=clear, remote=True))
        self.api.probe_peer_fn = (
            lambda uri: bool(self.client.status(
                uri, timeout=self.probe_timeout)))
        ex.announce_shard_fn = self._announce_shard_bounded
        self._bcast_thread = _threads.spawn(self._bcast_worker,
                                            name="pilosa-torch-bcast")
        if self.anti_entropy_interval > 0:
            self._schedule_anti_entropy()
        self.telemetry.start()
        from pilosa_tpu_torch import __version__

        self.diagnostics = DiagnosticsCollector(
            __version__, url=self.diagnostics_url,
            interval=self.diagnostics_interval, holder=self.holder,
            cluster=self.cluster, logger=self.logger)
        self.runtime_monitor.start()
        self.diagnostics.start()
        # the rejoin: fence what may have missed writes while this node was
        # away (before the first request is served: the listener is bound
        # and the peers known), then announce the return so peers replay
        # their hints now
        if not joining:
            self._arm_read_fence()
        self.http.serve_background()
        if joining:
            # knock before gossip opens: the coordinator is RESIZING when
            # gossip's alive record reaches it, so gossip admits nothing
            self.request_join()
        if self._gossip_port is not None:
            self._open_gossip()
        self.events.emit("node.start", uri=self.http.uri,
                         cluster=bool(self.cluster_hosts))
        if self.cluster_hosts and not joining:
            self.broadcast({"type": "node-state", "id": self.node_id,
                            "state": "READY"})
        return self

    @property
    def uri(self) -> str:
        return self.http.uri

    def close(self) -> None:
        self.closed = True
        if self.gossip is not None:
            self.gossip.close()
        if self._resize_watchdog is not None:
            self._resize_watchdog.cancel()
        if self._member_timer is not None:
            self._member_timer.cancel()
        if self._ae_timer is not None:
            self._ae_timer.cancel()
        self._fence_wake.set()
        self._bcast_queue.put(None)
        self.telemetry.close()
        self.runtime_monitor.close()
        if self.diagnostics is not None:
            self.diagnostics.close()
        if self.events is not None:
            # node.stop is the node's last event: a scrub pass in flight
            # stops at its next fragment (sync_holder reads `closed`) and
            # records no scrub.pass
            with self._scrub_lock:
                self.events.emit("node.stop")
            _events.unregister_crash_dump(self.events)
        if self.http is not None:
            self.http.close()
            self.http = None
        # the last batches (TraceExporter.close is idempotent where it is
        # the tracer's exporter too)
        if self.tracer.exporter is not None:
            self.tracer.exporter.close()
        if self.trace_exporter is not None:
            self.trace_exporter.close()
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
        self._member_timer = _threads.ctx_timer(self.membership_interval,
                                                self._membership_tick)
        self._member_timer.start()

    def _membership_tick(self) -> None:
        try:
            if self.join and self.cluster.state == STATE_STARTING \
                    and not self.cluster.down_ids:
                # not admitted yet: knock again (a STARTING of peers down
                # falls through, so probing can see them come back)
                self.request_join()
            else:
                # fetched without the lock, merged under it: a merge must
                # not end a job's RESIZING
                http = self.http
                if http is not None and not self.closed:
                    reports = self._fetch_peer_nodes(http.uri)
                    if reports is not None:
                        with self._resize_lock:
                            if self.cluster.state != STATE_RESIZING \
                                    and self.cluster.active_job is None:
                                self._apply_membership(reports, http.uri)
                if self.gossip is None:
                    # with gossip on, gossip is the failure detector
                    self._probe_peers()
            # a replay that failed midway keeps its log: re-run the heal
            # of every live peer that still has hints
            self._retry_pending_hints()
        except Exception as e:  # noqa: BLE001 — the tick must go on
            self.logger.printf(
                f"membership tick failed: {type(e).__name__}: {e}")
        finally:
            self._schedule_membership_refresh()

    def refresh_membership(self) -> None:
        """Merge the node lists of every configured host."""
        http = self.http  # None once closed
        if not self.cluster_hosts or self.closed or http is None:
            return
        reports = self._fetch_peer_nodes(http.uri)
        if reports is not None:
            self._apply_membership(reports, http.uri)

    def _fetch_peer_nodes(self, my_uri: str) -> Optional[list]:
        """The node lists the configured hosts report (None once this node
        was removed)."""
        if self._left:
            return None
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
        nodes = {n.id: n for n in self.cluster.nodes
                 if n.id not in self._removed_ids}
        nodes[self.node_id] = Node(id=self.node_id, uri=my_uri)
        for nd in reports:
            if nd["id"] in self._removed_ids:
                continue
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

        threads = [_threads.spawn(probe, n) for n in peers]
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
                    self.logger.printf(
                        f"liveness: node {node.id} ({node.uri}) back up")
                    self.cluster.mark_up(node.id)
                    self.events.emit("peer.up", peer=node.id,
                                     detector="probe")
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
        checkers = [_threads.ctx_thread(
            lambda nd=node: refuted.__setitem__(
                nd.id, self._indirect_confirms_alive(nd, peers, results)))
            for node in suspects]
        for t in checkers:
            t.start()
        for t in checkers:
            t.join(3 * self.probe_timeout + 3.0)
        for node in suspects:
            if refuted.get(node.id):
                self.logger.printf(
                    f"liveness: node {node.id} suspected but refuted by an "
                    "indirect probe (a link problem, not a death)")
                self._probe_failures.pop(node.id, None)
                self.stats.count("liveness/suspect_refuted")
                continue
            self.logger.printf(
                f"liveness: node {node.id} ({node.uri}) failed "
                f"{self._probe_failures.get(node.id, 0)} probes, marking "
                "it down")
            self.cluster.mark_down(node.id)
            self.stats.count("liveness/node_down")
            self.events.emit("peer.down", peer=node.id, detector="probe",
                             failedProbes=self._probe_failures.get(
                                 node.id, 0))

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
            _threads.spawn(ask, h)
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
                self.logger.printf(
                    f"peer {nid} is draining: routing around it")
                self.cluster.mark_draining(nid)
                self.stats.count("drain/peerDraining")
                self.events.emit("peer.draining", peer=nid)
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
                    self.logger.printf(
                        f"peer {nid} rejoined: replaying its hints")
                    self.events.emit("peer.rejoined", peer=nid)
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
                        "availableShards": self._schema_shards()})
                except ClientError as e:
                    self.logger.printf(
                        f"schema re-sync to {node.id} failed: {e}")
                claim = self.cluster._explicit_claim
                if claim:
                    self._send_quiet(node.uri, {"type": "set-coordinator",
                                                "id": claim})
                try:
                    _r, _d, complete = self.replay_hints(node)
                except Exception as e:  # noqa: BLE001 — fall back to sync
                    complete = False
                    self.logger.printf(f"hint replay to {node.id} failed: {e}")
                self._send_quiet(node.uri, {
                    "type": "hints-replayed", "target": node.id,
                    "from": self.node_id, "complete": complete})
                if not complete and self._await_unfenced(node):
                    try:
                        self._sync_with_node(node.id)
                    except Exception as e:  # noqa: BLE001 — best effort
                        self.logger.printf(
                            f"post-return sync with {node.id} failed: {e}")
            finally:
                with self._return_lock:
                    self._return_heals.discard(node.id)

        _threads.spawn(heal, name="pilosa-torch-heal")

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
            self.events.emit("hint.replay", target=node.id,
                             replayed=replayed, dropped=dropped,
                             complete=complete)
            self.logger.printf(
                f"hints: replayed {replayed} to {node.id}, {dropped} "
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

    # -- SWIM gossip (:697-757) ----------------------------------------------

    def _open_gossip(self) -> None:
        """Start the UDP endpoint and join the seeds; this node's HTTP URI
        rides its alive record, so a node found by gossip alone can be
        admitted."""
        from pilosa_tpu_torch.parallel.gossip import Gossip, parse_seed
        from pilosa_tpu_torch.utils.aesgcm import derive_key

        self.gossip = Gossip(
            self.node_id, bind_host=self.host, bind_port=self._gossip_port,
            meta={"uri": self.http.uri}, config=self._gossip_config,
            on_alive=self._on_gossip_alive, on_dead=self._on_gossip_dead,
            secret_key=(derive_key(self._gossip_secret)
                        if self._gossip_secret else None),
            logger=self.logger.printf)
        # gossip datagrams carry the clock's stamp, as the RPCs do
        self.gossip.clock = self.clock
        self.gossip.open(seeds=[parse_seed(s) for s in self._gossip_seeds])
        self.logger.printf(
            f"gossip: listening on {self.gossip.host}:{self.gossip.port} "
            f"(seeds: {','.join(self._gossip_seeds) or 'none'})")

    def _on_gossip_dead(self, member) -> None:
        """Gossip's suspicion of a member expired: route around it."""
        if self.closed or member.id == self.node_id:
            return
        if self.cluster.node_by_id(member.id) is not None \
                and not self.cluster.is_down(member.id):
            self.logger.printf(
                f"gossip: node {member.id} dead (suspicion expired), "
                "marking it down")
            self.cluster.mark_down(member.id)
            self.stats.count("liveness/node_down")
            self.events.emit("peer.down", peer=member.id,
                             detector="gossip")

    def _on_gossip_alive(self, member) -> None:
        """A member is alive: a down one is marked up and healed; an
        unknown one is admitted from its URI (NotifyJoin,
        gossip/gossip.go:335-342), unless a job runs or it was removed."""
        if self.closed or member.id == self.node_id:
            return
        node = self.cluster.node_by_id(member.id)
        http = self.http
        if node is None:
            uri = member.meta.get("uri")
            if uri and member.id not in self._removed_ids \
                    and http is not None:
                with self._resize_lock:
                    if self.cluster.state != STATE_RESIZING \
                            and self.cluster.active_job is None:
                        self._apply_membership([{"id": member.id,
                                                 "uri": uri}], http.uri)
        elif self.cluster.is_down(member.id):
            self.logger.printf(f"gossip: node {member.id} back up")
            self.cluster.mark_up(member.id)
            self.events.emit("peer.up", peer=member.id, detector="gossip")
            self._on_node_return(node)

    def gossip_status(self) -> Optional[dict]:
        """The gossip block of /debug/vars (the port's own): the endpoint,
        the members by state, the datagrams dropped by the cipher and the
        cipher's seconds."""
        g = self.gossip
        if g is None:
            return None
        members = g.members()
        return {"host": g.host, "port": g.port,
                "members": {m.id: m.state for m in members},
                "incarnation": g.incarnation,
                "cryptoDrops": g.crypto_drops,
                "encrypted": g._cipher is not None,
                "cipherBackend": (None if g._cipher is None else "stdlib"
                                  if g._cipher._lib is None
                                  else "cryptography"),
                "sealed": g.sealed, "sealSeconds": g.seal_s,
                "opened": g.opened, "openSeconds": g.open_s}

    # -- this node's drain (:1117-1260) ------------------------------------

    def request_drain(self, abort: bool = False,
                      timeout: Optional[float] = None) -> dict:
        """POST /cluster/drain: the drain on a thread of its own, the
        status answered at once; abort=True cancels one in progress."""
        if abort:
            self.abort_drain()
            return self.drain_status()
        with self._drain_lock:
            if self._drain_thread is None \
                    or not self._drain_thread.is_alive():
                self._drain_abort.clear()
                self._drain_thread = _threads.spawn(
                    self.drain, timeout, name="pilosa-torch-drain")
        return self.drain_status()

    def abort_drain(self) -> None:
        """Stop shedding and re-announce READY, so peers route here
        again."""
        if not self.draining:
            return
        self._drain_abort.set()
        self.draining = False
        self.handler.draining = False
        me = self.cluster.local_node
        if me is not None and me.state == "DRAINING":
            me.state = "READY"
        self.logger.printf("drain: aborted, serving again")
        self.events.emit("drain.abort")
        self.broadcast({"type": "node-state", "id": self.node_id,
                        "state": "READY"})

    def _drain_wait(self, cond, deadline: Optional[float]) -> bool:
        while not cond():
            if self._drain_abort.is_set() or self.closed:
                return False
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.01)
        return True

    def drain(self, timeout: Optional[float] = None) -> dict:
        """The drain, run to its end: (1) shed new external queries, (2)
        tell the peers (node-state DRAINING), (3) wait for in-flight work
        and for the batchers' and the coalescer's queues to empty, (4) save
        the rank caches and snapshot every fragment with WAL ops or a
        volatile bulk load, so a restart replays nothing. Steps (1) and
        (2) run once; a second call (the CLI's SIGTERM after POST
        /cluster/drain) waits and persists again."""
        timeout = self.drain_timeout if timeout is None else timeout
        t0 = time.monotonic()
        deadline = t0 + timeout if timeout and timeout > 0 else None
        if not self.draining:
            self.draining = True
            self.handler.draining = True
            me = self.cluster.local_node
            if me is not None:
                me.state = "DRAINING"
            self.stats.count("drain/started")
            self.logger.printf(
                f"drain: shedding new external queries (timeout "
                f"{timeout:.1f} s)")
            self.events.emit("drain.start", timeoutSeconds=timeout)
            self.broadcast({"type": "node-state", "id": self.node_id,
                            "state": "DRAINING"})
        inflight_ok = self._drain_wait(
            lambda: self.handler.active_queries == 0, deadline)
        ex = self.executor
        queues = [b for b in (ex.batcher, ex.sum_batcher, ex.minmax_batcher,
                              ex.coalescer) if b is not None]
        flushed_ok = self._drain_wait(
            lambda: sum(b.queue_depth() for b in queues) == 0, deadline)
        if self._drain_abort.is_set():
            return self.drain_status()
        snapshotted = errors = 0
        try:
            self.holder.flush_caches()
        except Exception as e:  # noqa: BLE001 — caches are rebuilt
            self.logger.printf(f"drain: rank cache flush failed: {e}")
        for iname, fname, vname, shard, frag in \
                list(self.holder.walk_fragments()):
            if frag.op_n <= 0 and not frag._volatile:
                continue
            try:
                frag.snapshot()
                snapshotted += 1
            except (OSError, ValueError) as e:
                errors += 1
                self.logger.printf(
                    f"drain: final snapshot of {iname}/{fname}/{vname}/"
                    f"{shard} failed: {e}")
        self.drained = True
        self._drain_info = {
            "inflightDrained": inflight_ok, "queuesFlushed": flushed_ok,
            "snapshotted": snapshotted, "snapshotErrors": errors,
            "durationSeconds": round(time.monotonic() - t0, 3)}
        self.stats.count("drain/completed")
        self.logger.printf(
            f"drain: done in {self._drain_info['durationSeconds']:.2f} s "
            f"(in-flight {inflight_ok}, queues {flushed_ok}, snapshots "
            f"{snapshotted}): the process may stop")
        self.events.emit("drain.complete", snapshotted=snapshotted,
                         snapshotErrors=errors,
                         durationSeconds=self._drain_info["durationSeconds"])
        return self.drain_status()

    def drain_status(self) -> dict:
        """The drain block of /debug/vars and /cluster/drain's answer."""
        out = {"draining": self.draining, "drained": self.drained,
               "shedQueries": self.handler.drain_sheds,
               "activeQueries": self.handler.active_queries,
               "timeoutSeconds": self.drain_timeout}
        out.update(self._drain_info)
        return out

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
        self.logger.printf(
            f"rejoin: read-fenced {n} shard(s) until their block "
            "checksums match a replica")
        self.events.emit("fence.armed", shards=n)
        self._start_fence_worker()

    def _start_fence_worker(self) -> None:
        self._fence_wake.set()
        t = self._fence_thread
        if t is not None and t.is_alive():
            return
        self._fence_thread = _threads.spawn(self._fence_worker,
                                            name="pilosa-torch-fence")

    def _fence_worker(self) -> None:
        deadline = time.monotonic() + self.rejoin_fence_timeout
        ex = self.executor
        while not self.closed and ex.read_fence:
            try:
                self._verify_fence_pass()
            except Exception as e:  # noqa: BLE001 — retried next tick
                self.logger.printf(f"rejoin: fence check failed: {e}")
            if not ex.read_fence:
                break
            if time.monotonic() >= deadline:
                # availability wins over a fence nothing can verify; the
                # scrubber stays the backstop
                with ex._fence_lock:
                    n = len(ex.read_fence)
                    ex.read_fence.clear()
                self.stats.count("readFence/expired", n)
                self.logger.warnf(
                    f"rejoin: fence expired after "
                    f"{self.rejoin_fence_timeout:.0f} s with {n} shard(s) "
                    "unverified: serving local data")
                self.events.emit("fence.expired", shards=n,
                                 timeoutSeconds=self.rejoin_fence_timeout)
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
        # awaitedHints (the port's own field): the shard's blocks differed
        # before every live peer had replayed its hints to this node, so it
        # lifted only after them
        self.events.emit("fence.lifted", index=iname, shard=shard,
                         healed=healed,
                         awaitedHints=key in self._fence_diverged or None)
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
        self._ae_timer = _threads.ctx_timer(max(interval, 0.01),
                                            self._anti_entropy_tick)
        self._ae_timer.start()

    def _anti_entropy_tick(self) -> None:
        try:
            self.scrub_pass()
        except Exception as e:  # noqa: BLE001 — the next pass retries
            self.logger.printf(
                f"anti-entropy: pass failed: {type(e).__name__}: {e}")
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
            if self.closed:
                return 0
            t0 = time.monotonic()
            rebuilt = self.repair_quarantined()
            merged = self.sync_holder()
            if self.closed:
                return merged  # cut short: close() records node.stop
            self.events.emit("scrub.pass", blocksMerged=merged,
                             fragmentsRebuilt=rebuilt,
                             seconds=round(time.monotonic() - t0, 3))
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
                    self.logger.printf(
                        f"scrubber: rebuild of {iname}/{fname}/{vname}/"
                        f"{shard} from {node.id} failed: {e}")
                    continue
                self._refresh_rank(iname, fname, vname, shard)
                frag.rebuilt_from = node.id
                rebuilt += 1
                self.logger.printf(
                    f"scrubber: rebuilt quarantined fragment {iname}/"
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
        merged. The failpoint server.scrub.fragment runs first."""
        failpoints.hit("server.scrub.fragment")
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
        elif mtype == "node-join":
            self.cluster.add_node(Node.from_dict(msg["node"]))
        elif mtype == "node-join-request":
            self._handle_join_request(Node.from_dict(msg["node"]))
        elif mtype == "node-leave-request":
            self._handle_leave_request(msg["id"])
        elif mtype == "resize-instruction":
            # the copies run off the coordinator's request
            _threads.spawn(self.follow_resize_instruction, msg,
                           name="pilosa-torch-resize")
        elif mtype == "resize-complete":
            self._handle_resize_complete(msg)
        elif mtype == "resize-abort":
            self._abort_request()
        elif mtype == "topology":
            self._apply_topology(msg["nodes"], msg.get("removed"))
        elif mtype == "cluster-state":
            self.cluster._set_state(msg["state"])
            if msg["state"] == STATE_RESIZING:
                self._settle_work()
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
            self._apply_available(msg.get("availableShards", {}))
        else:
            raise ValueError(f"unknown cluster message type: {mtype}")

    # -- resize (:1681-2093) ------------------------------------------------

    def _settle_work(self) -> None:
        """Wait (at most RESIZE_SETTLE_S) for the work routes in flight
        here to finish: a write acknowledged before RESIZING must be in the
        fragments a follower copies."""
        deadline = time.monotonic() + self.RESIZE_SETTLE_S
        while self.handler.active_queries > 0 and not self.closed \
                and time.monotonic() < deadline:
            time.sleep(0.005)

    def _topology_msg(self) -> dict:
        return {"type": "topology",
                "nodes": [n.to_dict() for n in self.cluster.nodes],
                "removed": sorted(self._removed_ids)}

    def request_join(self) -> None:
        """Ask the first seed that answers to admit this node; it forwards
        the request to the coordinator, which runs a join job."""
        http = self.http
        if http is None:
            return
        me = {"id": self.node_id, "uri": http.uri}
        for huri in self.cluster_hosts:
            if huri == http.uri:
                continue
            try:
                self.client.send_message(huri, {"type": "node-join-request",
                                                "node": me})
                return
            except ClientError:
                continue

    def _resize_request(self, event: str, node: Node):
        """The API's remove-node: a leave job on the coordinator, asked
        for through it; a refusal (too few replicas) is a ValueError the
        operator's request answers with."""
        if event != EVENT_LEAVE:
            raise ValueError(f"unsupported resize event: {event}")
        if not self.cluster.is_coordinator():
            coord = self.cluster.node_by_id(self.cluster.coordinator_id)
            if coord is None or not coord.uri:
                raise ValueError("no coordinator available")
            try:
                self.client.send_message(coord.uri, {
                    "type": "node-leave-request", "id": node.id})
            except ClientError as e:
                raise ValueError(f"remove-node refused by coordinator: {e}")
            return None
        self._handle_leave_request(node.id)
        return self.cluster.active_job

    def _abort_request(self) -> None:
        """POST /cluster/resize/abort: the coordinator cancels its job and
        un-gates every node."""
        if not self.cluster.is_coordinator():
            coord = self.cluster.node_by_id(self.cluster.coordinator_id)
            if coord is None or not coord.uri:
                raise ValueError("no coordinator available")
            try:
                self.client.send_message(coord.uri, {"type": "resize-abort"})
            except ClientError as e:
                raise ValueError(f"abort refused by coordinator: {e}")
            return
        with self._resize_lock:
            self.cluster.abort_resize()
        if self._resize_watchdog is not None:
            self._resize_watchdog.cancel()
        self._resize_aborted()

    def _forward_to_coordinator(self, msg: dict) -> bool:
        coord = self.cluster.node_by_id(self.cluster.coordinator_id)
        if coord is None or coord.id == self.node_id or not coord.uri:
            return False
        try:
            self.client.send_message(coord.uri, msg)
            return True
        except ClientError:
            return False

    def _handle_join_request(self, node: Node) -> None:
        if node.id == self.node_id:
            return
        # a removed node may come back
        self._removed_ids.discard(node.id)
        if self.cluster.node_by_id(node.id) is not None:
            # a member already (its topology message was lost): send it
            # the topology again
            self._send_quiet(node.uri, self._topology_msg())
            return
        if not self.cluster.is_coordinator():
            self._forward_to_coordinator({"type": "node-join-request",
                                          "node": node.to_dict()})
            return
        with self._resize_lock:
            if self.cluster.state == STATE_RESIZING \
                    or self.cluster.active_job is not None:
                if all(n.id != node.id for _, n in self._pending_resizes):
                    self._pending_resizes.append(("join", node))
                return
            job = self.cluster.node_join(node)
        if job is not None:
            self._start_job(job)

    def _handle_leave_request(self, node_id: str) -> None:
        if not self.cluster.is_coordinator():
            self._forward_to_coordinator({"type": "node-leave-request",
                                          "id": node_id})
            return
        with self._resize_lock:
            victim = self.cluster.node_by_id(node_id)
            if self.cluster.state == STATE_RESIZING \
                    or self.cluster.active_job is not None:
                if victim is not None:
                    self._pending_resizes.append(("leave", victim))
                return
            job = self.cluster.node_leave(node_id)
        if job is not None:
            self._start_job(job)
            return
        # too few nodes to rebuild the replicas: the node is gone already
        self._removed_ids.add(node_id)
        self.hints.drop_target(node_id)
        self._broadcast_topology()
        if victim is not None and victim.uri:
            self._send_quiet(victim.uri, self._topology_msg())
        self.clean_holder()

    def _start_job(self, job: ResizeJob) -> None:
        """Every member RESIZING (each settles its in-flight work before
        it answers), this node's work settled too, then the
        instructions."""
        self._broadcast_state(STATE_RESIZING)
        self._settle_work()
        self._distribute_resize(job)

    def _distribute_resize(self, job: ResizeJob) -> None:
        """Each node's instruction, with the schema and the cluster-wide
        available shards, so a joining node creates the fields first and
        plans over every shard (cluster.go:1499)."""
        uri_by_id = {n.id: n.uri for n in self.cluster.nodes}
        if job.node is not None:
            uri_by_id.setdefault(job.node.id, job.node.uri)
        self.events.emit("resize.start", job=job.id, event=job.event,
                         node=job.node_id)
        self._arm_watchdog(job.id)
        schema = self.holder.schema()
        avail = self._schema_shards()
        for target, sources in job.instructions.items():
            msg = {"type": "resize-instruction", "job": job.id,
                   "coordinator": self.node_id,
                   "coordinatorURI": self.http.uri,
                   "schema": schema, "availableShards": avail,
                   "sources": [dict(s.to_dict(),
                                    fromURI=uri_by_id.get(s.from_node, ""))
                               for s in sources]}
            if target == self.node_id:
                _threads.spawn(self.follow_resize_instruction, msg,
                               name="pilosa-torch-resize")
                continue
            try:
                self.client.send_message(uri_by_id[target], msg)
            except ClientError as e:
                self.logger.printf(
                    f"resize: instruction undeliverable to {target}: {e}; "
                    "aborting the job")
                with self._resize_lock:
                    self.cluster.abort_resize()
                self._resize_aborted()
                return

    def _copy_source(self, src: dict) -> tuple:
        """One source shard from its donor: each view's roaring bytes
        unioned into this node's fragment, and its rank cache rebuilt.
        -> (fragments, bytes)."""
        idx = self.holder.index(src["index"])
        f = idx.field(src["field"]) if idx is not None else None
        if f is None:
            raise ClientError(
                f"schema missing for {src['index']}/{src['field']}")
        shard = int(src["shard"])
        n_frags = n_bytes = 0
        for vname in self.client.fragment_views(
                src["fromURI"], src["index"], src["field"], shard):
            try:
                data = self.client.retrieve_shard(
                    src["fromURI"], src["index"], src["field"], vname, shard)
            except ClientError as e:
                if e.status == 404:
                    continue  # gone meanwhile: anti-entropy heals it
                raise
            view = f.create_view_if_not_exists(vname)
            view.create_fragment_if_not_exists(shard).import_roaring(data)
            view.refresh_rank_cache(shard)
            n_frags += 1
            n_bytes += len(data)
        f.add_available_shards([shard], quiet=True)
        return n_frags, n_bytes

    def follow_resize_instruction(self, msg: dict) -> None:
        """Apply the schema and the available shards, copy every source
        (RESIZE_COPY_WORKERS at once), then acknowledge to the coordinator
        (followResizeInstruction, cluster.go:1251-1393)."""
        done = {"type": "resize-complete", "job": msg["job"],
                "node": self.node_id}
        try:
            self._apply_schema(msg.get("schema", []))
            self._apply_available(msg.get("availableShards", {}))
            sources = msg.get("sources", [])
            if sources:
                with ThreadPoolExecutor(min(self.RESIZE_COPY_WORKERS,
                                            len(sources))) as pool:
                    copied = list(pool.map(self._copy_source, sources))
                self.stats.count("resize/fragmentsCopied",
                                 sum(c[0] for c in copied))
                self.stats.count("resize/bytesCopied",
                                 sum(c[1] for c in copied))
        except (ClientError, ValueError, OSError) as e:
            done["error"] = str(e)
        if msg.get("coordinator") == self.node_id:
            self._handle_resize_complete(done)
            return
        # the acknowledgement must arrive, or the job waits out its
        # watchdog: transient failures are retried
        for attempt in range(5):
            try:
                self.client.send_message(msg["coordinatorURI"], done)
                break
            except ClientError:
                time.sleep(0.5 * (attempt + 1))

    def _apply_available(self, avail: dict) -> None:
        for iname, fields in avail.items():
            idx = self.holder.index(iname)
            if idx is None:
                continue
            for fname, shards in fields.items():
                f = idx.field(fname)
                if f is not None and shards:
                    f.add_available_shards([int(x) for x in shards],
                                           quiet=True)

    def _handle_resize_complete(self, msg: dict) -> None:
        job = self.cluster.active_job
        if (job is not None and job.id == msg.get("job")
                and not msg.get("error") and job.event != EVENT_LEAVE
                and job.node is not None and job.node.uri
                and set(job.instructions) <= job.completed | {msg["node"]}):
            # the last acknowledgement of a join: the joiner takes its
            # topology first, so no member routes to it while it is still
            # STARTING (a refused read)
            nodes = sorted(self.cluster.nodes + [job.node],
                           key=lambda n: n.id)
            self._send_quiet(job.node.uri, {
                "type": "topology", "nodes": [n.to_dict() for n in nodes],
                "removed": sorted(self._removed_ids)})
        with self._resize_lock:
            job = self.cluster.active_job
            if job is None or job.id != msg.get("job"):
                return
            if msg.get("error"):
                self.logger.printf(
                    f"resize: job {job.id} failed on {msg.get('node')}: "
                    f"{msg['error']}")
                self.cluster.abort_resize()
                aborted, finished = True, False
            else:
                aborted = False
                self.cluster.complete_resize(job, msg["node"])
                # a state other than NORMAL (an unrelated peer down) still
                # ends the job
                finished = self.cluster.active_job is None
                if finished and job.event == EVENT_LEAVE:
                    self._removed_ids.add(job.node_id)
        if aborted:
            if self._resize_watchdog is not None:
                self._resize_watchdog.cancel()
            self._resize_aborted()
            return
        if not finished:
            return
        if self._resize_watchdog is not None:
            self._resize_watchdog.cancel()
        self.events.emit("resize.complete", job=job.id, event=job.event,
                         node=job.node_id)
        if job.event == EVENT_LEAVE:
            # a departed node's hints can never be delivered
            self.hints.drop_target(job.node_id)
        self._broadcast_topology()
        if job.event == EVENT_LEAVE and job.node is not None \
                and job.node.uri:
            self._send_quiet(job.node.uri, self._topology_msg())
        self.clean_holder()
        self._drain_pending_resizes()

    def _arm_watchdog(self, job_id: str) -> None:
        if self._resize_watchdog is not None:
            self._resize_watchdog.cancel()
        if self.resize_timeout <= 0:
            return
        t = _threads.ctx_timer(self.resize_timeout, self._watchdog_fire,
                               args=(job_id,))
        t.start()
        self._resize_watchdog = t

    def _watchdog_fire(self, job_id: str) -> None:
        with self._resize_lock:
            job = self.cluster.active_job
            if job is None or job.id != job_id:
                return
            self.logger.printf(
                f"resize: job {job_id} timed out after "
                f"{self.resize_timeout:.0f} s; aborting it")
            self.cluster.abort_resize()
        self._resize_aborted()

    def _broadcast_state(self, state: str) -> None:
        """Every member takes the cluster state (RESIZING refuses queries
        and writes everywhere, not only on the coordinator)."""
        self.broadcast({"type": "cluster-state", "state": state})

    def _resize_aborted(self) -> None:
        """Un-gate the members, then start the next queued join or leave
        (an aborted join knocks again by itself)."""
        self.events.emit("resize.abort")
        self._broadcast_state(self.cluster.state)
        self._drain_pending_resizes()

    def _drain_pending_resizes(self) -> None:
        """The queued joins and leaves, one job at a time; one that became
        invalid (a leave refused for lack of replicas) is dropped."""
        while True:
            with self._resize_lock:
                if not self._pending_resizes:
                    return
                event, node = self._pending_resizes.pop(0)
            try:
                if event == "join":
                    self._handle_join_request(node)
                else:
                    self._handle_leave_request(node.id)
                with self._resize_lock:
                    if self.cluster.active_job is not None:
                        return  # its end drains the next
            except ValueError as e:
                self.logger.printf(
                    f"resize: dropping queued {event}({node.id}): {e}")

    def _broadcast_topology(self) -> None:
        """The membership after a job, to every node."""
        self.cluster.elect_coordinator()
        msg = self._topology_msg()
        for n in list(self.cluster.nodes):
            if n.id != self.node_id and n.uri:
                self._send_quiet(n.uri, msg)

    def _apply_topology(self, nodes_d: list,
                        removed: Optional[list] = None) -> None:
        """The coordinator's membership after a job. Its removed set
        replaces this node's (a union would tombstone a node that came
        back); the hints for a removed node go; a node that finds itself
        removed becomes a node of its own and stops merging peers."""
        if removed is not None:
            self._removed_ids = set(removed)
        for rid in self._removed_ids:
            if rid != self.node_id and self.hints.pending(rid):
                self.hints.drop_target(rid)
        http = self.http
        if self.node_id in self._removed_ids:
            self._left = True
            if http is not None:
                self.cluster.set_static([Node(id=self.node_id,
                                              uri=http.uri)])
            self.cluster.coordinator_id = self.node_id
            self.cluster.save_topology()
            return
        before = {n.id for n in self.cluster.nodes}
        self.cluster.set_static([Node.from_dict(d) for d in nodes_d
                                 if d["id"] not in self._removed_ids])
        self.cluster.elect_coordinator()
        self.cluster.save_topology()
        after = {n.id for n in self.cluster.nodes}
        if after != before:
            self.events.emit("topology.change", nodes=sorted(after),
                             added=sorted(after - before),
                             removed=sorted(before - after))
        self.clean_holder()

    def clean_holder(self) -> int:
        """Drop the fragments of shards this node no longer owns, and the
        executor's leaves and cached results over them (holderCleaner,
        holder.go:855-906). Returns the fragments dropped."""
        dropped = 0
        for iname, idx in list(self.holder.indexes.items()):
            gone = set()
            for f in list(idx.fields.values()):
                for view in list(f.views.values()):
                    for shard in view.shards():
                        if not self.cluster.owns_shard(self.node_id, iname,
                                                       shard):
                            view.delete_fragment(shard)
                            gone.add(shard)
                            dropped += 1
            if gone:
                self.executor.drop_shards(iname, gone)
        if dropped:
            self.stats.count("resize/fragmentsDropped", dropped)
        return dropped

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
        threads = [_threads.spawn(self._send_quiet, u, msg)
                   for u in self._peer_uris()]
        for t in threads:
            t.join()

    def _announce_shard_bounded(self, iname: str, fname: str,
                                shard: int) -> None:
        """create-shard to every peer before a shard-creating Set is
        acknowledged, waiting at most ANNOUNCE_SHARD_BUDGET_S (:1604)."""
        msg = {"type": "create-shard", "index": iname, "field": fname,
               "shard": shard}
        threads = [_threads.spawn(self._send_quiet, u, msg)
                   for u in self._peer_uris()]
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
                    _threads.spawn(peer_sender, uri, q,
                                   name="pilosa-torch-bcast-peer")
                if q.qsize() < self.BCAST_PEER_QUEUE_MAX:
                    q.put(msg)
                else:
                    self._bcast_dropped += 1

    def sample_gauges(self) -> dict:
        """One telemetry tick (pilosa_tpu/server.py:2095, the parts the
        port has): gauges of the residency, plan cache, planner, batchers,
        ingest, hybrid leaves, heat map, usage, SLOs, QoS, damaged
        fragments, kernels, device memory and the process, and rates over
        the window since the previous tick (the 5xx rate among them). It
        also resolves the finished kernel event pairs and ticks the heat
        map's and the usage ledger's rings."""
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
        self.usage.sample_tick()
        ut = self.usage.totals()
        g["usage.tracked_principals"] = float(
            self.usage.snapshot(top=1)["trackedPrincipals"])
        raw["usage.queries"] = ut["queries"]
        raw["usage.device_ms"] = ut["deviceMs"]
        raw["usage.rpc_bytes"] = ut["rpcBytes"]
        worst = 0.0
        for name, ob in self.slo.evaluate().items():
            g[f"slo.{name}.burn_short"] = ob["burnShort"]
            g[f"slo.{name}.burn_long"] = ob["burnLong"]
            worst = max(worst, {"green": 0.0, "yellow": 1.0,
                                "red": 2.0}[ob["status"]])
        g["slo.worst"] = worst
        qt = self.qos.totals()
        raw["qos.admitted"] = qt["admitted"]
        raw["qos.shed"] = qt["shed"] + qt["wouldShed"]
        raw["qos.throttled"] = qt["throttled"]
        g["qos.estimated_wait_ms"] = round(self.qos.estimated_wait_ms(), 3)
        damaged = self.holder.damaged_fragments()
        g["wal.poisoned_fragments"] = float(self._poisoned_fragments())
        g["wal.damaged_fragments"] = float(len(damaged))
        g["wal.needs_rebuild"] = float(
            sum(1 for d in damaged if d["needsRebuild"]))
        raw["http.errors"] = float(self.handler.errors_5xx)
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
        g["usage.queries_per_s"] = rate("usage.queries")
        g["usage.device_ms_per_s"] = rate("usage.device_ms")
        g["usage.rpc_bytes_per_s"] = rate("usage.rpc_bytes")
        g["qos.admitted_per_s"] = rate("qos.admitted")
        g["qos.shed_per_s"] = rate("qos.shed")
        g["qos.throttled_per_s"] = rate("qos.throttled")
        g["http.errors_per_s"] = rate("http.errors")
        self._telemetry_prev = (raw, now)
        # the sampler is the one periodic observer of the health score:
        # each change of it is recorded once, with its reasons
        health = self.node_health()
        if self._last_health is not None \
                and health["score"] != self._last_health:
            self.events.emit("health.transition",
                             fromScore=self._last_health,
                             toScore=health["score"],
                             reasons=health["reasons"][:5])
        self._last_health = health["score"]
        return g

    def _health_inputs(self) -> dict:
        """The health score's live inputs (:2398-2442). /status is the
        probes' path, so the fragment walk is the sampler's last tick's
        where it has one, the walk itself only without."""
        latest = self.telemetry.ring.latest()
        if "wal.damaged_fragments" in latest:
            poisoned = latest.get("wal.poisoned_fragments", 0.0) > 0
            needs_rebuild = int(latest["wal.needs_rebuild"])
            n_damaged = int(latest["wal.damaged_fragments"])
        else:
            poisoned = self._poisoned_fragments() > 0
            damaged = self.holder.damaged_fragments()
            needs_rebuild = sum(1 for d in damaged if d["needsRebuild"])
            n_damaged = len(damaged)
        ps = self.executor.fanout_pool_stats()
        out = {
            "walPoisoned": poisoned,
            "needsRebuild": needs_rebuild,
            "damagedFragments": n_damaged,
            "errorRate": latest.get("http.errors_per_s", 0.0),
            "queueSaturation": ps["queued"] / max(1, ps["size"]),
            "draining": self.draining,
            "fencedShards": self.executor.fence_snapshot()["fencedShards"],
        }
        status, reason = self.slo.worst()
        if status != "green":
            out["sloStatus"] = status
            out["sloReason"] = reason
        return out

    def _poisoned_fragments(self) -> int:
        return sum(1 for *_, frag in self.holder.walk_fragments()
                   if frag.storage.wal_poisoned)

    def node_health(self) -> dict:
        """This node's {score, reasons}: /status and the QoS plane's
        healthRed shed."""
        return _telemetry.health_score(self._health_inputs())

    # samples of the telemetry ring a node's stats document carries (the
    # dashboard's sparklines)
    STATS_TAIL_SAMPLES = 60

    def node_stats(self) -> dict:
        """This node's fleet-telemetry document (GET /internal/stats,
        :2448-2479): identity, health and its inputs, the latest sampled
        gauges, device memory and the ring's tail. The JAX document's
        `xla` block counts XLA compiles; the port compiles nothing per
        shape (its kernels are built once per process from
        csrc/bitmap_kernels.cu), so `xla` is null, and the card's work
        shows in the gauges (device.bytes_in_use, kernels.*)."""
        from pilosa_tpu_torch import __version__

        inputs = self._health_inputs()
        ring = self.telemetry.ring
        return {
            "id": self.node_id,
            "uri": self.http.uri,
            # a draining node says so (its health inputs make it yellow)
            "state": "DRAINING" if self.draining else self.cluster.state,
            "version": __version__,
            "uptimeSeconds": int(time.monotonic() - self.api.start_time),
            "health": _telemetry.health_score(inputs),
            "healthInputs": inputs,
            "damagedFragments": inputs["damagedFragments"],
            "gauges": ring.latest(),
            "counters": {
                "http5xx": self.handler.errors_5xx,
                "hedgesFired": self.executor.hedges_fired,
                "sampleErrors": self.telemetry.sample_errors,
            },
            "xla": None,
            "deviceMemory": _telemetry.device_memory_stats(),
            "timeseries": ring.since(0, limit=self.STATS_TAIL_SAMPLES),
        }

    def _fetch_timeout(self) -> float:
        return max(2.0, self.probe_timeout)

    def _federate(self, local_fn, fetch_fn, what: str) -> tuple:
        """Every member's document for a /cluster/* merge (:2586-2826):
        this node's from local_fn(), each live peer's from fetch_fn(uri,
        timeout) on a short-lived thread of its own (not the fan-out
        pool, where a fetch queued behind query RPCs would time out). A
        peer marked down, or without a URI, gets no RPC ("down"); a 404
        is a "legacy" peer, any other failure or a fetch past the join
        bound "error"; none fails the merge. -> ({id: document},
        [{id, uri, status}] in membership order)."""
        docs: dict = {}
        nodes: list[dict] = []
        timeout = self._fetch_timeout()
        fetchers: list = []
        for n in list(self.cluster.nodes):
            if n.id == self.node_id:
                docs[n.id] = local_fn()
                nodes.append({"id": n.id, "uri": self.uri, "status": "ok"})
                continue
            if self.cluster.is_down(n.id) or not n.uri:
                nodes.append({"id": n.id, "uri": n.uri or "",
                              "status": "down"})
                continue
            entry = {"id": n.id, "uri": n.uri, "status": "pending"}
            nodes.append(entry)

            def fetch(node=n, entry=entry) -> None:
                try:
                    docs[node.id] = fetch_fn(node.uri, timeout)
                    entry["status"] = "ok"
                except ClientError as e:
                    entry["status"] = ("legacy" if e.status == 404
                                       else "error")
                except Exception:  # noqa: BLE001 — never fail the merge
                    entry["status"] = "error"

            t = _threads.spawn(fetch, name=f"pilosa-torch-{what}")
            fetchers.append((entry, t))
        for entry, t in fetchers:
            t.join(timeout + 1.0)
            if entry["status"] == "pending":
                entry["status"] = "error"
        # a fetch that finishes after its join bound must not show up
        ok = {e["id"] for e in nodes if e["status"] == "ok"}
        return {k: v for k, v in list(docs.items()) if k in ok}, nodes

    @staticmethod
    def _stamped(out: dict, node_id: str) -> dict:
        out["generatedBy"] = node_id
        out["asOf"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        return out

    def cluster_stats(self) -> dict:
        """The fleet document (GET /cluster/stats, :2481-2584): every
        member's node_stats with its health. A peer marked down is red
        (no RPC), a draining one that stopped answering yellow, one
        without /internal/stats (404) "legacy", a failed or timed-out
        fetch yellow; legacy and unknown never worsen the fleet's
        health."""
        entries: dict[str, dict] = {self.node_id: self.node_stats()}
        order: list[str] = []
        timeout = self._fetch_timeout()
        draining_doc = {"state": "DRAINING", "health": {
            "score": "yellow",
            "reasons": ["node draining (rolling restart in progress)"]}}
        fetchers: list = []
        for n in list(self.cluster.nodes):
            order.append(n.id)
            if n.id == self.node_id:
                continue
            if self.cluster.is_down(n.id):
                # a drained node that went away is mid-restart, not failed
                entries[n.id] = {"id": n.id, "uri": n.uri, **(
                    draining_doc if self.cluster.is_draining(n.id) else
                    {"state": "down", "health": {"score": "red", "reasons": [
                        "node marked down (liveness)"]}})}
                continue
            if not n.uri:
                entries[n.id] = {
                    "id": n.id, "uri": "", "state": "unknown",
                    "health": {"score": "yellow",
                               "reasons": ["no known URI"]}}
                continue

            def fetch(node=n) -> None:
                draining = self.cluster.is_draining(node.id)
                try:
                    doc = self.client.node_stats(node.uri, timeout)
                    doc.setdefault("id", node.id)
                    doc.setdefault("uri", node.uri)
                    entries[node.id] = doc
                except ClientError as e:
                    if draining:
                        entries[node.id] = {"id": node.id, "uri": node.uri,
                                            **draining_doc}
                    elif e.status == 404:
                        entries[node.id] = {
                            "id": node.id, "uri": node.uri, "state": "up",
                            "health": {"score": "legacy", "reasons": [
                                "peer predates /internal/stats "
                                "(legacy protocol)"]}}
                    else:
                        entries[node.id] = {
                            "id": node.id, "uri": node.uri, "state": "up",
                            "health": {"score": "yellow", "reasons": [
                                f"stats fetch failed: {e}"]}}
                except Exception as e:  # noqa: BLE001 — never fail it all
                    entries[node.id] = {
                        "id": node.id, "uri": node.uri, "state": "up",
                        "health": {"score": "yellow", "reasons": [
                            f"stats fetch failed: "
                            f"{type(e).__name__}: {e}"]}}

            t = _threads.spawn(fetch, name="pilosa-torch-stats")
            fetchers.append((n, t))
        for n, t in fetchers:
            t.join(timeout + 1.0)
            if n.id not in entries:
                entries[n.id] = {
                    "id": n.id, "uri": n.uri, "state": "up",
                    "health": {"score": "yellow", "reasons": [
                        f"stats fetch timed out after {timeout:.1f}s"]}}
        nodes = [entries[i] for i in order]
        counts: dict[str, int] = {}
        worst = "green"
        sev = {"green": 0, "yellow": 1, "red": 2}
        for nd in nodes:
            score = (nd.get("health") or {}).get("score", "unknown")
            counts[score] = counts.get(score, 0) + 1
            if score in sev and sev[score] > sev[worst]:
                worst = score
        return self._stamped(
            {"fleet": {"health": worst, "counts": counts, "nodes": nodes}},
            self.node_id)

    def cluster_usage(self) -> dict:
        """The fleet's per-principal usage (GET /cluster/usage,
        :2586-2651): every member's /debug/usage summed per principal,
        ordered by device ms, then queries, then name."""
        docs, nodes = self._federate(self.usage.snapshot,
                                     self.client.debug_usage, "usage")
        merged: dict[str, dict] = {}
        totals = dict.fromkeys(_accounting.FIELDS, 0.0)
        spilled = 0
        for doc in docs.values():
            for p, e in (doc.get("principals") or {}).items():
                acc = merged.setdefault(
                    p, dict.fromkeys(_accounting.FIELDS, 0.0))
                for f in _accounting.FIELDS:
                    acc[f] += float(e.get(f, 0.0))
                acc["nodes"] = acc.get("nodes", 0) + 1
            for f in _accounting.FIELDS:
                totals[f] += float((doc.get("totals") or {}).get(f, 0.0))
            spilled += int(doc.get("spilledPrincipals", 0))
        ordered = dict(sorted(merged.items(),
                              key=lambda kv: (-kv[1]["deviceMs"],
                                              -kv[1]["queries"], kv[0])))
        return self._stamped({"principals": ordered, "totals": totals,
                              "spilledPrincipals": spilled, "nodes": nodes},
                             self.node_id)

    def cluster_hbm(self) -> dict:
        """The fleet's residency maps (GET /cluster/hbm, :2653-2708):
        every member's /debug/hbm under byNode and its byte totals summed.
        Nodes that share one card each count their own residency budget,
        so budgetBytes and headroomBytes sum past the card's memory."""
        docs, nodes = self._federate(self.executor.hbm_snapshot,
                                     self.client.debug_hbm, "hbm")
        totals = {"residentBytes": 0, "budgetBytes": 0, "headroomBytes": 0,
                  "planCacheBytes": 0, "entries": 0}
        drift = None
        for doc in docs.values():
            for f in totals:
                totals[f] += int(doc.get(f, 0) or 0)
            d = doc.get("hbmDriftBytes")
            if d is not None:
                drift = (drift or 0) + int(d)
        return self._stamped({"byNode": docs, "totals": totals,
                              "hbmDriftBytes": drift, "nodes": nodes},
                             self.node_id)

    def cluster_heat(self) -> dict:
        """The fleet's heat map (GET /cluster/heat, :2765-2826): every
        member's whole /debug/heat table merged per fragment
        (heat.merge_heat_docs: replica heat sums), and each node entry
        with its skew, hot and tracked fragments (the advisor's node
        input)."""
        tracker = self.executor.heat
        docs, nodes = self._federate(
            lambda: tracker.snapshot(top=0) if tracker is not None else {},
            self.client.debug_heat, "heat")
        out = _heat.merge_heat_docs(docs)
        for entry in nodes:
            doc = docs.get(entry["id"])
            if doc:
                entry["skew"] = doc.get("skew", 1.0)
                entry["hotFragments"] = doc.get("hotFragments", 0)
                entry["trackedFragments"] = doc.get("trackedFragments", 0)
        out["nodes"] = nodes
        return self._stamped(out, self.node_id)

    def cluster_events(self, limit: int = 0) -> dict:
        """GET /cluster/events (:2710-2760): every member's /debug/events
        merged in HLC order (events.merge_events). The RPCs merge each
        peer's stamp, so this node's clock has passed every peer's before
        it sorts."""
        docs, nodes = self._federate(
            lambda: self.events.events(0),
            lambda uri, timeout: self.client.debug_events(
                uri, timeout).get("events", []), "events")
        merged = _events.merge_events(docs)
        if limit > 0:
            merged = merged[-limit:]
        return self._stamped({"events": merged, "nodes": nodes},
                             self.node_id)
